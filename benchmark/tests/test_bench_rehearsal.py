"""Tiny CPU runs of the cells through the port's plain versions: the
whole of a run but the look for a card. A sound run is correct; the
control (the reference with its state in bfloat16, in the program's
place) and each fault a cell can have, planted in the port underneath
the timed path, come out not correct."""

import pytest
import torch

from conftest import SMALL
from harness.cell import run_cell

SEED = 2**31 + 4242


def _run(cell, trace=False, control=None, **kw):
    over = dict(SMALL, **kw)
    if cell.startswith("synthbank"):
        over["envs_per_level"] = 2
    lines = []
    return run_cell(cell, SEED, 0.3, trace, "cpu", control=control, overrides=over,
                    log=lines.append), lines


def test_synth_cell_is_correct_and_reports_its_metrics():
    res, lines = _run("synth_b1024.fs1", control="bfloat16")
    assert res["correct"], res["checks"]
    # The cell's p95 sits at the fallback's 5 % edge: not one of its metrics.
    assert set(res["metrics"]) == {"env_frames_per_s", "setup_s"}
    assert list(res)[-1] == "checks" and lines[-1].startswith("check frame_px")
    # The control fails at least one of the cell's numbers.
    control = res["control"]
    assert any(control[k] > res["checks"][k]["limit"] for k in res["checks"])


def test_traced_run_is_correct_and_reads_the_host_metrics():
    res, _ = _run("synth_b1024.fs4", trace=True)
    assert res["correct"], res["checks"]
    # No device on the CPU: the device-trace metrics read nothing; the
    # host-clock metric and the launch counter do.
    assert set(res["metrics"]) == {"step_ms", "fallback_blocks"}
    assert res["metrics"]["fallback_blocks"]["value"] >= 0
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_bank_cell_is_correct():
    res, _ = _run("synthbank4_b4096.fs1", warmup_steps=1)
    assert res["correct"], res["checks"]


def _unchanged(step):
    return lambda scene, cfg, state, acts: state


def _half(step):
    def half(scene, cfg, state, acts):
        n = state.pos.shape[0] // 2
        head = step(scene, cfg, type(state)(*(x[:n] for x in state)),
                    type(acts)(*(x[:n] for x in acts)))
        return type(state)(*(torch.cat([a, b[n:]]) for a, b in zip(head, state)))
    return half


def _altered_state(step):
    def altered(scene, cfg, state, acts):
        out = step(scene, cfg, state, acts)
        return out._replace(pos=out.pos + 1e-3)
    return altered


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered_state])
def test_faulty_step_is_not_correct(monkeypatch, fault):
    import tpu_doom_torch.models.doom_sim as ds

    monkeypatch.setattr(ds, "sim_step", fault(ds.sim_step))
    res, _ = _run("synth_b1024.fs1")
    assert not res["correct"], res["checks"]


def test_altered_frames_are_not_correct(monkeypatch):
    import tpu_doom_torch.models.doom_sim as ds

    render = ds.render_dispatch

    def altered(*args):
        idx, cov = render(*args)
        return idx ^ 1, cov

    monkeypatch.setattr(ds, "render_dispatch", altered)
    res, _ = _run("synth_b1024.fs1")
    assert not res["correct"] and res["checks"]["frame_px"]["value"] > 0


def test_bank_step_leaving_half_out_is_not_correct(monkeypatch):
    import tpu_doom_torch.models.level_bank as lb

    monkeypatch.setattr(lb, "sim_step", _half(lb.sim_step))
    res, _ = _run("synthbank4_b4096.fs1", warmup_steps=1)
    assert not res["correct"], res["checks"]


def test_jax_loaded_after_the_window_gives_no_result(monkeypatch):
    """A module of JAX that a metric's reader loads after the window is
    found before the result is given."""
    import sys
    import types

    import harness.cell as hc

    load = hc.load_module

    def loading_jax(kind, name):
        mod = load(kind, name)
        if kind == "metrics":
            read = mod.read

            def read_and_load(ctx):
                monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
                return read(ctx)

            mod.read = read_and_load
        return mod

    monkeypatch.setattr(hc, "load_module", loading_jax)
    with pytest.raises(RuntimeError, match="jax"):
        _run("synth_b1024.fs1")


def test_a_wad_file_of_the_checkout_is_run(monkeypatch, tmp_path):
    """A configuration may name a WAD by its path in the checkout: the
    fixture's bytes as a file run as the fixture does; a path that leads
    out of the checkout is refused."""
    import harness.inputs as inputs

    monkeypatch.setattr(inputs, "ROOT", str(tmp_path))
    (tmp_path / "wads").mkdir()
    (tmp_path / "wads" / "test.wad").write_bytes(inputs.wad_bytes(":test:"))
    res, _ = _run("synth_b1024.fs1", levels=[["wads/test.wad", 0]])
    assert res["correct"], res["checks"]
    for bad in ("../test.wad", str(tmp_path / "wads" / "test.wad")):
        with pytest.raises(ValueError):
            inputs.checkout_file(bad)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    import json
    import subprocess
    import sys

    from conftest import ROOT

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "synth_b1024.fs1",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_run_without_a_card_prints_no_result(tmp_path):
    import os
    import shutil
    import subprocess
    import sys

    from conftest import BENCH, ROOT

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "synth_b1024.fs1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
