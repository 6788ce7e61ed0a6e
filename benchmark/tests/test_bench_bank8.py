"""The maze bank's cell `bank8_b4096.fs1` in tiny CPU runs through the
port's plain versions (BANK8's eight levels, 8 envs a level at 64x40,
the warm-up raised until maze envs fall): it comes out correct while envs
render through the triangle fallback, its bfloat16 control does not, and
a fault planted in B3's plain version comes out not correct, so the check
judges fallback frames. The configuration is BANK8 uncut, with AUTO's
compaction for the padded bank written out; the frozen generator makes
its mazes as the port's does; the cell reports the metrics of the other
cells without a list, under a mix that is explore_fs1 with a longer
warm-up."""

import json
import os

import pytest
import torch

import harness.spans as spans
from conftest import BENCH, ROOT, SMALL
from harness.cell import Cell, run_cell

CELL = "bank8_b4096.fs1"
SEED = 2**31 + 4444
# 8 envs a level; the warm-up takes the maze envs past their first
# falls (at 64x40 the first fall is near step 16, a few a step by 24).
OVERRIDES = dict(SMALL, envs_per_level=8, warmup_steps=28)
SPAN_STEPS = 2
MAZES = (":stress:4", ":stress:6", ":texstress:4x16", ":texstress:6x24")


def _manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _run(trace=False, control=None):
    return run_cell(CELL, SEED, 0.3, trace, "cpu", control=control, overrides=OVERRIDES,
                    log=lambda line: None)


@pytest.fixture(scope="module")
def sound():
    """One traced run with the control: the check, the control's readings
    and, from a span window of SPAN_STEPS agent steps, the port's
    `overflow_envs` counter and `fallback` spans."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "CPU_STEPS", SPAN_STEPS)
        return _run(trace=True, control="bfloat16")


def test_cell_is_correct_while_envs_fall_back(sound):
    assert sound["correct"] and sound["failed"] == 0, sound["checks"]
    assert sound["checks"]["state_err"]["value"] == 0
    assert sound["checks"]["frame_px"]["value"] == 0
    # Envs rendered through the triangle fallback in the span window.
    got = sound["metrics"]
    assert got["overflow_envs"]["value"] > 0 and got["fallback_span_ms"]["value"] > 0


def test_bfloat16_control_is_not_correct(sound):
    control = sound["control"]
    assert control["precision"] == "bfloat16"
    assert any(control[k] > sound["checks"][k]["limit"] for k in sound["checks"])


def test_faulty_fallback_is_not_correct(monkeypatch):
    """B3's plain version with its resolved layers rolled by half the
    pixels: only envs on the triangle fallback render through it, so the
    check sees a wrong frame only where it judges a fallback frame."""
    import tpu_doom_torch.ops.raster as raster

    resolve = raster.peel_resolve_ref

    def rolled(*args, **kw):
        out = resolve(*args, **kw)
        return torch.roll(out, out.shape[-1] // 2, dims=-1)

    monkeypatch.setattr(raster, "peel_resolve_ref", rolled)
    res = _run()
    assert not res["correct"] and res["checks"]["frame_px"]["value"] > 0, res["checks"]
    assert res["checks"]["state_err"]["value"] == 0


def test_cell_is_bank8_uncut_with_auto_compaction_written_out():
    from tpu_doom_torch.render.portal import compact_crossings
    from tpu_doom_torch.tools.banks import BANK8, bank_config, bank_levels
    from tpu_doom_torch.utils.config import GameConfig

    manifest = _manifest()
    (work,) = (w for w in manifest["workloads"] if w["name"] == CELL)
    (entry,) = (c for c in manifest["configs"] if c["name"] == work["config"])
    assert work["chips"] == 1 and entry["reduced"] == []
    conf = Cell(CELL, manifest).config
    assert [tuple(x) for x in conf["levels"]] == list(BANK8)
    assert (conf["envs_per_level"], conf["width"], conf["height"]) == (512, 640, 400)
    # The bank walks every level at its members' padded seg and sprite rows.
    levels = bank_levels(BANK8, bank_config())
    rows = (max(a.portal.p1.shape[0] for a in levels)
            + max(a.portal.sprite_center.shape[0] for a in levels))
    assert rows == 148
    assert conf["game"]["portal_compact_crossings"] == compact_crossings(GameConfig(), rows) == 8


@pytest.mark.parametrize("spec", MAZES)
def test_frozen_maze_bytes_equal_the_ports(spec):
    """The frozen generator's bytes are those the port opens under the
    fixture's name, and those of the port's generator for the maze."""
    from harness.inputs import wad_bytes
    from tpu_doom_torch.models.doom_sim import open_wad
    from tpu_doom_torch.wad import wadgen

    cells, _, textures = spec.split(":")[2].partition("x")
    kw = {"n_textures": int(textures)} if textures else {}
    port = open_wad(spec)
    assert wad_bytes(spec) == port.data == wadgen.build_stress_wad(0, int(cells), **kw)
    assert port.num_levels >= 1


def test_cell_reports_the_metrics_without_a_list_under_a_settled_mix():
    manifest = _manifest()
    cell = Cell(CELL, manifest)
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"env_frames_per_s", "setup_s"}
    unlisted = {m["name"] for m in manifest["per_layer"] if "workloads" not in m}
    assert {m["name"] for m in cell.metrics("per_layer")} == unlisted
    with open(os.path.join(BENCH, "traffic", "explore_fs1.json")) as f:
        base = json.load(f)
    mix = cell.mix
    assert mix["warmup_steps"] == 64
    assert len(set(mix["actions"].values())) == 1
    assert {k: v for k, v in mix.items() if k not in ("why", "warmup_steps")} == \
        {k: v for k, v in base.items() if k not in ("why", "warmup_steps")}
