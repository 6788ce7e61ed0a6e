"""The big-level cell `texstress_b1024.fs1` in tiny CPU runs through the
port's plain versions (the configuration's 600-row level, the frame and
batch cut to the CPU's small shapes): it comes out correct, it reports
the end-to-end metrics it has and every per-layer metric without a cell
list, a fault planted in B4's plain version comes out not correct, and a
metric file alone reads the big-level walk's `select` span and the
cull's counters by name. The frozen generator makes the cell's level as
the port's does."""

import importlib.util
import json
import os

import torch

import harness.cell as hc
import harness.spans as spans
from conftest import ROOT, SMALL
from harness.cell import Cell, run_cell

CELL = "texstress_b1024.fs1"
SEED = 2**31 + 4343
# Throwaway metric files: the `select` span (kernel B4) per agent step and
# the cull's two counters per agent step, read by name.
EXTRA = {
    "select_span_ms": "from harness.spans import span_ms\n\n\n"
                      "def read(ctx):\n    return span_ms(ctx, 'select', 'step')\n",
    "visible_rows": "from harness.spans import counter\n\n\n"
                    "def read(ctx):\n    return counter(ctx, 'visible_rows', 'step')\n",
    "cull_overflow_envs": "from harness.spans import counter\n\n\n"
                          "def read(ctx):\n"
                          "    return counter(ctx, 'cull_overflow_envs', 'step')\n",
}


def _manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_file(name, path):
    spec = importlib.util.spec_from_file_location(f"test_metric_{name}", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(trace=False, control=None):
    return run_cell(CELL, SEED, 0.3, trace, "cpu", control=control, overrides=dict(SMALL),
                    log=lambda line: None)


def test_cell_is_correct():
    res = _run(control="bfloat16")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"env_frames_per_s", "setup_s"}
    control = res["control"]
    assert any(control[k] > res["checks"][k]["limit"] for k in res["checks"])


def test_cell_is_the_whole_big_level_on_one_chip():
    """Nothing cut; the AUTO values of a 600-row level written out: no
    crossing compaction, the cull to 448 rows."""
    manifest = _manifest()
    (work,) = (w for w in manifest["workloads"] if w["name"] == CELL)
    (entry,) = (c for c in manifest["configs"] if c["name"] == work["config"])
    assert work["chips"] == 1 and entry["reduced"] == []
    conf = Cell(CELL, manifest).config
    assert conf["levels"] == [[":texstress:", 0]]
    assert (conf["envs_per_level"], conf["width"], conf["height"]) == (1024, 320, 200)
    assert conf["game"]["portal_compact_crossings"] == 0
    assert conf["game"]["portal_visible_segs"] == 448


def test_frozen_texstress_bytes_equal_the_ports():
    """The frozen generator makes the cell's level, 16 x 16 rooms and 128
    wall textures, as the port's does, and the port opens it."""
    from harness.inputs import wad_bytes
    from tpu_doom_torch.models.doom_sim import open_wad
    from tpu_doom_torch.wad import wadgen

    assert wad_bytes(":texstress:") == wadgen.build_stress_wad(0, 16, n_textures=128)
    assert open_wad(":texstress:").num_levels >= 1


def test_cell_reports_the_metrics_without_a_list():
    manifest = _manifest()
    cell = Cell(CELL, manifest)
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"env_frames_per_s", "setup_s"}
    unlisted = {m["name"] for m in manifest["per_layer"] if "workloads" not in m}
    assert len(unlisted) == 10
    assert {m["name"] for m in cell.metrics("per_layer")} == unlisted


def test_faulty_selection_is_not_correct(monkeypatch):
    """B4's plain version with one attribute column (C_CEILROW, the
    height of the front ceiling the walk projects) rolled by half its
    K x W crossings: the frames differ from the reference's."""
    import tpu_doom_torch.ops.raster as raster
    from tpu_doom_torch.ops.walk import C_CEILROW

    select = raster.select_rows_ref

    def rolled(idx, tab):
        out = select(idx, tab)
        out[:, C_CEILROW] = torch.roll(out[:, C_CEILROW], out.shape[2] // 2, dims=1)
        return out

    monkeypatch.setattr(raster, "select_rows_ref", rolled)
    res = _run()
    assert not res["correct"] and res["checks"]["frame_px"]["value"] > 0, res["checks"]


def test_a_metric_file_reads_the_select_span_and_cull_counters(monkeypatch, tmp_path):
    manifest = _manifest()
    files = {}
    for name, code in EXTRA.items():
        files[name] = tmp_path / f"{name}.py"
        files[name].write_text(code)
        manifest["per_layer"].append({
            "name": name, "unit": "ms/step" if name.endswith("_ms") else "per_step",
            "better": "lower", "source": "program_span",
            "layer": "walk", "moves": "env_frames_per_s", "workloads": [CELL]})
    monkeypatch.setattr(hc, "load_json", lambda path, load=hc.load_json: (
        manifest if path == hc.MANIFEST else load(path)))
    monkeypatch.setattr(hc, "load_module", lambda kind, name, load=hc.load_module: (
        _load_file(name, files[name]) if kind == "metrics" and name in files
        else load(kind, name)))
    monkeypatch.setattr(spans, "CPU_STEPS", 4)
    seen, window = [], spans.window

    def recording(ctx):
        w = window(ctx)
        seen.append(w)
        return w

    monkeypatch.setattr(spans, "window", recording)
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    w = next(x for x in seen if x is not None)
    assert got["select_span_ms"]["value"] > 0
    assert got["select_span_ms"]["value"] == w.spans.total_ms("select") / w.steps
    assert got["visible_rows"]["value"] > 0
    assert got["visible_rows"]["value"] == w.counts["visible_rows"] / w.steps
    assert got["cull_overflow_envs"]["value"] >= 0
    # Every `select` span sits in a `walk` span: B4 runs inside the walk.
    assert all(w.spans.spans[s.parent].name == "walk" for s in w.spans.spans
               if s.name == "select")
