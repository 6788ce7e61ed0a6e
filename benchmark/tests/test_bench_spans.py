"""Tiny CPU runs of one cell of each kind with --trace 1, the span window
(`harness/spans.py`) let run on the CPU (where by default it runs no
step and reports nothing): it reports every span metric the cell reports
(`Cell.metrics`), finite and in range, and the per-layer metrics that
were there before read as they read without the span metrics. A metric
file alone reads a span or counter by name: one the harness names
nowhere reads, one the window never saw is left out. A fifth cell on a
small big-level maze, given as files and entries only, reports every
per-layer metric that carries no cell list."""

import json
import math
import os

import pytest

import harness.cell as hc
import harness.spans as spans
from conftest import ROOT, SMALL
from harness.cell import Cell, run_cell

SEED = 2**31 + 4242
SPAN_METRICS = ("device_idle_share", "step_span_ms", "walk_span_ms", "raster_span_ms",
                "fallback_span_ms", "frames_span_ms", "migrate_span_ms", "overflow_envs",
                "migrated_envs")
# Throwaway metric files: B1's `player` spans per tic, which the harness
# names nowhere, and a span and a counter the program does not have.
EXTRA = {
    "player_span_ms": "from harness.spans import span_ms\n\n\n"
                      "def read(ctx):\n    return span_ms(ctx, 'player', 'tic')\n",
    "no_such_span_ms": "from harness.spans import span_ms\n\n\n"
                       "def read(ctx):\n    return span_ms(ctx, 'no_such_span', 'tic')\n",
    "no_such_counter": "from harness.spans import counter\n\n\n"
                       "def read(ctx):\n    return counter(ctx, 'no_such_counter', 'step')\n",
}
TEXSTRESS = {
    "name": "texstress_small", "kind": "doom_sim", "levels": [[":texstress:10x16", 0]],
    "envs_per_level": 4, "width": 64, "height": 40,
    "game": {"raster_backend": "portal", "clip_substeps": 4},
    "limits": {"state_err": 0.0001, "frame_px": 64},
}


def _manifest(with_spans: bool = True) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    if not with_spans:
        m["per_layer"] = [e for e in m["per_layer"] if e["name"] not in SPAN_METRICS]
    return m


def _per_layer(name: str, layer: str) -> dict:
    return {"name": name, "unit": "ms/tic", "better": "lower", "source": "program_span",
            "layer": layer, "moves": "env_frames_per_s"}


def _run(monkeypatch, cell, manifest, metric_files=None):
    """A traced CPU run of `cell` under `manifest`; `metric_files` {name:
    path} are loaded as those metrics' readers."""
    over = dict(SMALL)
    if cell.startswith("synthbank"):
        over.update(envs_per_level=2, warmup_steps=1)
    monkeypatch.setattr(hc, "load_json", lambda path, load=hc.load_json: (
        manifest if path == hc.MANIFEST else load(path)))
    files = metric_files or {}
    monkeypatch.setattr(hc, "load_module", lambda kind, name, load=hc.load_module: (
        _load_file(name, files[name]) if kind == "metrics" and name in files
        else load(kind, name)))
    monkeypatch.setattr(spans, "CPU_STEPS", 4)
    return run_cell(cell, SEED, 0.3, True, "cpu", overrides=over, log=lambda line: None)


def _load_file(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"test_metric_{name}", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording_window(monkeypatch) -> list:
    """Keep each span window the run reads."""
    seen, window = [], spans.window

    def recording(ctx):
        w = window(ctx)
        seen.append(w)
        return w

    monkeypatch.setattr(spans, "window", recording)
    return seen


@pytest.mark.parametrize("cell", ["synth_b1024.fs4", "synthbank4_b4096.fs1"])
def test_traced_run_reports_the_span_metrics(monkeypatch, cell):
    res = _run(monkeypatch, cell, _manifest())
    assert res["correct"], res["checks"]
    reported = {e["name"] for e in Cell(cell, _manifest()).metrics("per_layer")
                if e["name"] in SPAN_METRICS}
    assert len(reported) == (9 if cell.startswith("synthbank") else 7)
    got = res["metrics"]
    assert reported <= set(got)
    for name in reported:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0, name
    assert got["device_idle_share"]["value"] <= 100
    for name in ("step_span_ms", "walk_span_ms", "raster_span_ms"):
        assert got[name]["value"] > 0, name
    if cell.startswith("synthbank"):
        assert got["migrate_span_ms"]["value"] > 0

    # Without the span metrics the metrics that were there read the same:
    # the span window runs after their readers and touches nothing they read.
    # step_ms is a host-clock time, so it is only present in both.
    before = _run(monkeypatch, cell, _manifest(False))["metrics"]
    assert set(before) == set(got) - reported
    for name, m in before.items():
        if name != "step_ms":
            assert got[name]["value"] == m["value"], name


def test_fixed_list_readings_equal_the_readers_by_name(monkeypatch):
    """The nine span and counter metrics read what the window's former
    fixed lists computed from the same recorded window: `step`,
    `migrate` and `migrated_envs` per tic, the rest per agent step."""
    seen = _recording_window(monkeypatch)
    res = _run(monkeypatch, "synthbank4_b4096.fs4", _manifest())
    w = next(x for x in seen if x is not None)
    rec, counts, steps = w.spans, w.counts, w.steps
    tics = steps * 4
    old = {"device_idle_share": rec.idle_share(),
           "overflow_envs": counts["overflow_envs"] / steps,
           "migrated_envs": counts["migrated_envs"] / tics}
    for name in ("step", "migrate"):
        old[f"{name}_span_ms"] = rec.total_ms(name) / tics
    for name in ("walk", "raster", "fallback", "frames"):
        old[f"{name}_span_ms"] = rec.total_ms(name) / steps
    assert w.tics == tics and set(old) == set(SPAN_METRICS)
    assert {k: res["metrics"][k]["value"] for k in old} == old


def test_a_metric_file_alone_reads_a_span_by_name(monkeypatch, tmp_path):
    manifest = _manifest()
    paths = {}
    for name, code in EXTRA.items():
        paths[name] = tmp_path / f"{name}.py"
        paths[name].write_text(code)
        manifest["per_layer"].append(_per_layer(name, "step"))
    seen = _recording_window(monkeypatch)
    res = _run(monkeypatch, "synth_b1024.fs1", manifest, paths)
    assert res["correct"], res["checks"]
    w = next(x for x in seen if x is not None)
    assert res["metrics"]["player_span_ms"]["value"] > 0
    assert res["metrics"]["player_span_ms"]["value"] == w.spans.total_ms("player") / w.tics
    # A name the window never saw reads None: left out, never 0.
    assert "no_such_span_ms" not in res["metrics"] and "no_such_counter" not in res["metrics"]
    with pytest.raises(ValueError, match="per"):
        w.per("frame")


def test_a_fifth_cell_reports_every_metric_without_a_list(monkeypatch, tmp_path):
    """A doom_sim cell on a small :texstress: maze (257 walk rows: the
    visible-row cull, B4's selection, W2 reading it), added as a
    configuration file and manifest entries alone, reports every
    per-layer metric without a cell list. No device on the CPU: a trace
    in which each kernel asked for took 1 ms stands in for the
    profiler's, so that the rooflines' readers run their counts."""
    import harness.trace

    conf = tmp_path / "texstress_small.json"
    conf.write_text(json.dumps(TEXSTRESS))
    manifest = _manifest()
    manifest["configs"].append({"name": "texstress_small", "source": "test", "file": str(conf),
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "texstress_small.fs1", "config": "texstress_small",
                                  "traffic": "explore_fs1", "chips": 1, "why": "test"})

    class KernelsTrace(harness.trace.Trace):
        def op_seconds(self, *substrings):
            return 1e-3 * len(substrings)

    monkeypatch.setattr(harness.trace, "Trace", KernelsTrace)
    res = _run(monkeypatch, "texstress_small.fs1", manifest)
    assert res["correct"], res["checks"]
    unlisted = {e["name"] for e in manifest["per_layer"] if "workloads" not in e}
    assert len(unlisted) == 10
    assert {e["name"] for e in Cell("texstress_small.fs1", manifest).metrics("per_layer")} \
        == unlisted
    assert set(res["metrics"]) == unlisted
    for name in ("w2_roofline", "b2_roofline"):
        assert 0 < res["metrics"][name]["value"] < math.inf, name
