"""The port's benchmark and verify leg (`python -m tpu_doom_torch.bench`)
on the CPU (BENCH_DEVICE=cpu: eager ticks through the kernels' plain
versions):

(f) `main` and `bank_main` at tiny sizes print exactly one JSON line on
    stdout, with bench.py's keys and `metric` strings; with no card and
    no BENCH_DEVICE, `main`, `bank_main` and `verify` raise.
(g) `--verify` on the `test` leg passes: portal against portal_jnp
    within 16 px and 16 cov over the leg, each within 16 px per pose of
    tests/golden/verify_ref.npz.
The timed ticks: `time_ticks` over bench.py's tick ends bitwise where as
many eager step + render ticks end, its checksum the sum of every
frame's indices; the bank's checksum tick equals the bank tick of
`tools/banks.py` summed, bitwise; both ticks take nothing from the host
(tests/test_torch_rollout.py's TorchDispatchMode), so that the card can
capture them. `_leg`'s verdicts: every ceiling at 16, the golden per pose
or summed over the leg.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from tpu_doom_torch import bench
from tpu_doom_torch.graphs import device_decisions
from tpu_doom_torch.models import DoomSim
from tpu_doom_torch.utils.config import GameConfig, PlayerConfig

W, H = 64, 40
KEYS = ["metric", "value", "unit", "vs_baseline"]


def _load_test_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(os.path.dirname(__file__), f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(out: str) -> dict:
    """The one line of stdout, a JSON object."""
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _env(monkeypatch, **kw):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    for k, v in kw.items():
        monkeypatch.setenv(k, str(v))


# -- (f) -----------------------------------------------------------------------


@pytest.mark.parametrize("env,metric", [
    (dict(BENCH_W=W, BENCH_H=H), "step+render FPS/chip (64x40, batched :test:)"),
    ({}, "step+render FPS/chip (320x200, batched synthetic E1M1)"),
    (dict(BENCH_W=W, BENCH_H=H, BENCH_LOOKY=1, BENCH_CROSSINGS=12),
     "step+render FPS/chip (64x40, batched :test:)"),
    (dict(BENCH_W=W, BENCH_H=H, BENCH_WAD=":texstress:10x16", BENCH_GLOBAL_MAX=1024),
     "step+render FPS/chip (64x40, batched :texstress:10x16)"),
], ids=["test_64x40", "test_320x200", "looky", "texstress_active_set"])
def test_main_prints_one_json_line(monkeypatch, capsys, env, metric):
    _env(monkeypatch, BENCH_BATCH=2, BENCH_TICKS=2, **env)
    assert bench.run([]) == 0
    out = capsys.readouterr()
    line = _json_line(out.out)
    assert list(line) == KEYS
    assert line["metric"] == metric and line["unit"] == "env*frames/s"
    # value and vs_baseline are rounded from the same rate, each on its own.
    assert line["value"] > 0 and abs(line["vs_baseline"] - line["value"] / 1e4) <= 1e-4
    assert "launches {" in out.err


@pytest.mark.parametrize("levels", [4, 8])
def test_bank_main_prints_one_json_line(monkeypatch, capsys, levels):
    _env(monkeypatch, BENCH_BANK=1, BENCH_LEVELS=levels, BENCH_BATCH=8, BENCH_W=W,
         BENCH_H=H, BENCH_TICKS=1)
    assert bench.run([]) == 0
    out = capsys.readouterr()
    line = _json_line(out.out)
    assert list(line) == KEYS
    E = 8 // levels
    assert line["metric"] == f"step+render FPS/chip (64x40, {levels}x{E} mixed-level LevelBank)"
    assert "trace+compile+warmup" in out.err and f"(L={levels})" in out.err


@pytest.mark.parametrize("argv,env", [([], {}), ([], {"BENCH_BANK": "1"}),
                                      (["--verify"], {})], ids=["main", "bank", "verify"])
def test_raises_without_card(monkeypatch, argv, env):
    """The card is the default: no card and no BENCH_DEVICE raises before
    any level is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.run(argv)


def test_config_knobs_name_game_config_fields():
    fields = {f.name: f.type for f in dataclasses.fields(GameConfig)}
    for name, (field, kind) in bench.CONFIG_KNOBS.items():
        assert name.startswith("BENCH_") and fields[field] == kind.__name__, name


# -- (g) -----------------------------------------------------------------------


def test_verify_test_leg_passes_against_the_golden(monkeypatch, capsys):
    _env(monkeypatch, BENCH_VERIFY_LEGS="test")
    assert bench.run(["--verify"]) == 0
    out = _json_line(capsys.readouterr().out)
    assert out["metric"] == "on-device kernel verification" and out["device"] == "cpu"
    leg = out["legs"]["test"]
    assert out["pass"] and leg["pass"] and leg["poses"] == 8 and leg["golden_per"] == "pose"
    assert max(leg["mismatch_px"], leg["mismatch_cov"], leg["golden_px"],
               leg["golden_cov"]) <= bench.VERIFY_CEILING


@pytest.mark.parametrize("counts,per,ok", [
    ((0, 0, 16, 0), "pose", True),
    ((0, 0, 17, 0), "pose", False),
    ((0, 0, 9, 0), "leg", False),  # 2 poses of 9 px: 18 summed
    ((0, 0, 8, 0), "leg", True),  # 16 summed
    ((17, 0, 0, 0), "pose", False),
    ((0, 17, 0, 0), "pose", False),
    ((0, 0, 0, 17), "pose", False),
], ids=["pose_at_ceiling", "pose_over", "leg_over", "leg_at_ceiling", "px_over", "cov_over",
        "golden_cov_over"])
def test_leg_verdict(counts, per, ok):
    """_leg on 2 synthetic poses: portal differs from portal_jnp in
    counts[0] px and counts[1] cov of pose 0; both backends from the
    golden in counts[2] px and counts[3] cov of every pose."""
    px, cov, gpx, gcov = counts
    ref_idx, ref_cov = np.zeros((2, 8, 8), np.uint8), np.zeros((2, 8, 8), bool)

    def frames(n_px, n_cov):
        idx, c = ref_idx.copy().reshape(2, -1), ref_cov.copy().reshape(2, -1)
        idx[:, :gpx] += 1
        c[:, :gcov] = True
        idx[0, 40:40 + n_px] += 2
        c[0, 40:40 + n_cov] ^= True
        return idx.reshape(2, 8, 8), c.reshape(2, 8, 8)
    res = bench._leg({"portal": frames(px, cov), "portal_jnp": frames(0, 0)}, ref_idx,
                     ref_cov, per)
    assert res["pass"] is ok
    assert (res["mismatch_px"], res["mismatch_cov"]) == (px, cov)


@pytest.mark.parametrize("gpx,ok", [(bench.TEXSTRESS8_POSE_CEILING, True),
                                    (bench.TEXSTRESS8_POSE_CEILING + 1, False)],
                         ids=["at", "over"])
def test_leg_golden_ceiling(gpx, ok):
    """A leg's own golden ceiling (the texstress8 leg's, 2 px per pose)
    replaces 16 for the golden's px only."""
    ceiling = bench.TEXSTRESS8_POSE_CEILING
    ref_idx, ref_cov = np.zeros((2, 8, 8), np.uint8), np.zeros((2, 8, 8), bool)
    idx = ref_idx.copy().reshape(2, -1)
    idx[1, :gpx] = 1
    idx = idx.reshape(2, 8, 8)
    res = bench._leg({"portal": (idx, ref_cov), "portal_jnp": (idx, ref_cov)}, ref_idx,
                     ref_cov, "pose", golden_ceiling=ceiling)
    assert res["pass"] is ok and res["golden_px"] == gpx and res["golden_ceiling"] == ceiling


# -- the timed ticks -------------------------------------------------------------


def _sim(**kw):
    cfg = dict(wad_file=":test:", width=W, height=H, batch_size=2, raster_backend="portal",
               player=PlayerConfig(clip_substeps=4))
    cfg.update(kw)
    return DoomSim(GameConfig(**cfg), "cpu")


def test_time_ticks_equals_eager_ticks():
    """warmup + ticks eager step_render ticks: bitwise the same state, the
    checksum the sum of all their frames."""
    sim = _sim()
    acts = bench.bench_actions(sim, 2, looky=True)
    timing = bench.time_ticks(bench.sim_tick(sim, W, H),
                              (sim.reset(2), torch.zeros((), dtype=torch.int64)), acts, 2,
                              warmup=1)
    state, check = sim.reset(2), 0
    for _ in range(3):
        state, idx, _ = sim.step_render(state, acts)
        check += int(idx.sum(dtype=torch.int64))
    final, got = timing.state
    assert all(torch.equal(a, b) for a, b in zip(final, state))
    assert int(got) == check > 0
    assert timing.seconds > 0 and set(timing.launches) >= {"player_move",
                                                           "render_portal_fused"}


def test_time_ticks_windows_run_on_from_one_state():
    """reps windows of n ticks end where one window of reps * n ticks
    does, bitwise."""
    sim = _sim()
    acts = bench.bench_actions(sim, 2)
    tick = bench.sim_tick(sim, W, H)

    def run(ticks, reps):
        carry = (sim.reset(2), torch.zeros((), dtype=torch.int64))
        return bench.time_ticks(tick, carry, acts, ticks, warmup=1, reps=reps)

    windows, whole = run(1, 3), run(3, 1)
    assert all(torch.equal(a, b) for a, b in zip(windows.state[0], whole.state[0]))
    assert int(windows.state[1]) == int(whole.state[1]) > 0
    assert windows.seconds > 0


def _bank():
    from tpu_doom_torch.tools.banks import BANK5, make_bank

    return make_bank(BANK5[0:1] + BANK5[2:3], "cpu", width=W, height=H,
                     portal_pitch="triangle")


def _bank_start(bank, E=2):
    s = bank.reset(E)
    pitch = s.pitch.clone()
    pitch[:, 1] = 0.3  # one env per level on the triangle fallback
    return s._replace(pitch=pitch), torch.ones((bank.num_levels, E), dtype=torch.bool)


def test_bank_checksum_tick_equals_bank_tick():
    """bank_main's tick reduces each level's frames as it renders them:
    the same state, active mask and frame sum as the stacking bank tick."""
    bank = _bank()
    state, active = _bank_start(bank)
    acts = bench.bank_actions(bank.num_levels, 2, "cpu")
    check = torch.zeros((), dtype=torch.int64)
    tick, stacked = bench.bank_check_tick(bank, W, H), bench.bank_tick(bank, W, H)
    want = 0
    with torch.no_grad():
        for _ in range(2):
            ((s1, a1, check),) = tick((state, active, check), acts)
            (state, active), frames = stacked((state, active), acts)
            want += int(frames.sum(dtype=torch.int64))
            assert all(torch.equal(a, b) for a, b in zip(s1, state))
            assert torch.equal(a1, active) and int(check) == want


@pytest.mark.parametrize("which", ["sim", "bank"])
def test_bench_ticks_take_nothing_from_the_host(monkeypatch, which):
    """Under device_decisions() -- what a captured tick runs -- the bench
    tick (with its checksum) and the bank's make no host read and take no
    data from the host; the kernels' plain versions are left out."""
    from tpu_doom_torch import _numerics
    from tpu_doom_torch.ops import collision, raster

    check = torch.zeros((), dtype=torch.int64)
    if which == "sim":
        sim = _sim(portal_pitch="triangle")
        state = sim.reset(2)
        state = state._replace(pitch=torch.tensor([1e-8, 0.3]))
        carry, acts = (state, check), bench.bench_actions(sim, 2)
        tick = bench.sim_tick(sim, W, H)
        tables = [list(sim.scene), list(sim.portal_scene().values())]
    else:
        bank = _bank()
        carry, acts = (*_bank_start(bank), check), bench.bank_actions(2, 2, "cpu")
        tick = bench.bank_check_tick(bank, W, H)
        tables = [list(bank.scenes),
                  [v for v in bank.pscenes.values() if isinstance(v, torch.Tensor)]]
    with torch.no_grad():
        tick(carry, acts)  # makes the cached device scalars
    mode = _load_test_module("test_torch_rollout")._HostTraffic([])
    mode.add([carry, acts, tables, list(_numerics._SCALARS.values())])

    def outside(fn):
        def run(*args, **kw):
            with _disable_current_modes():
                out = fn(*args, **kw)
            mode.add(out)
            return out
        return run

    for mod in (raster, collision):
        for name in dir(mod):
            if name.endswith("_ref"):
                monkeypatch.setattr(mod, name, outside(getattr(mod, name)))
    with device_decisions(), torch.no_grad(), mode:
        ((*_, got),) = tick(carry, acts)
    assert mode.found == []
    assert int(got) > 0
