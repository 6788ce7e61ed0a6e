"""The PyTorch port's simulation against the JAX package on identical
inputs (CPU: every kernel wrapper takes its plain version here).

Tolerances:
* B1 (`player_move_ref` vs `player_move_jnp`): <= 4 ulp per component
  and identical hit/miss -- XLA on the CPU contracts some a*b+c into
  fused multiply-adds, the port rounds every operation.
* One tick of `step` from identical states: pos/vel within 1e-5.
* Whole trajectories: a pinned drift ceiling, never bit for bit (an ulp
  can flip a grounded/jump branch).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from trigger_scenarios import FIRING, SCENARIOS

from tpu_doom.models import DoomSim as JaxSim
from tpu_doom.utils.config import GameConfig, PlayerConfig
from tpu_doom_torch.models import DoomSim as TorchSim
from tpu_doom_torch.sim.state import (
    actions_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from tpu_doom_torch.utils.config import GameConfig as TorchConfig
from tpu_doom_torch.utils.config import PlayerConfig as TorchPlayer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(scope="module")
def sims():
    """JAX and torch sims with test_sim.py's player config."""
    pk = dict(clip_substeps=1, enable_noclip=False)
    kw = dict(wad_file=":test:", width=64, height=40, batch_size=1)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", player=PlayerConfig(**pk), **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", player=TorchPlayer(**pk), **kw),
                    "cpu")
    jstep = jax.jit(simj.step)
    return simj, simt, jstep


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_player_move_ref_matches_jax_move_core():
    """(a) B1's plain version vs the JAX kernel's math on 16 poses."""
    from tpu_doom.ops.collision_pallas import player_move_jnp
    from tpu_doom.sim.collision import broadphase_rows as jax_rows

    from tpu_doom_torch.ops.collision import player_move_ref
    from tpu_doom_torch.sim.collision import broadphase_rows

    simj = JaxSim(GameConfig(wad_file=":test:", raster_backend="portal_jnp"))
    simt = TorchSim(TorchConfig(wad_file=":test:", raster_backend="portal"), "cpu")
    rng = np.random.default_rng(0)
    B = 16
    s = simj.reset(B)
    jitter = rng.uniform(-0.5, 0.5, (B, 3)) * np.array([1.0, 0.3, 1.0])
    pos = (np.asarray(s.pos) + jitter).astype(np.float32)
    pos[8:] += np.array([0.3, -0.2, -6.0], np.float32)  # door corridor
    vel = rng.uniform(-3.0, 3.0, (B, 3)).astype(np.float32)
    s = s._replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    rows_j = np.asarray(jax.vmap(lambda o, p: jax_rows(simj.scene, o, p))(
        s.object_offset, s.pos))
    ts = state_from_numpy(TO_NP(s), "cpu")
    rows_t = broadphase_rows(simt.scene, ts.object_offset, ts.pos)
    np.testing.assert_array_equal(rows_t.numpy(), rows_j)  # exact row select

    st8 = np.concatenate([pos, vel, np.zeros((B, 2), np.float32)], axis=1)
    for substeps in (1, 4):
        kw = dict(radius=0.19, height=0.21, dt=1.0 / 60.0, substeps=substeps)
        want = np.asarray(player_move_jnp(jnp.asarray(rows_j), jnp.asarray(st8), **kw))
        got = player_move_ref(torch.as_tensor(rows_j), torch.as_tensor(st8), **kw).numpy()
        hit = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), hit)
        near = hit.copy()
        near[:, 10] = False
        assert _ulps(got[near], want[near]).max() <= 4
        # The noclip probe sweeps 2000 units: its vertex quadratic loses
        # ~8 digits to cancellation, so FMA contraction on the JAX side
        # moves its time by up to ~300 ulp (measured 1.76e-5).
        far = hit[:, 10]
        np.testing.assert_allclose(got[far, 10], want[far, 10], rtol=0, atol=5e-5)
        assert hit[:, 0].any()  # the ground probe hits


def test_step_one_tick_matches_jax():
    """(b) One tick from identical states with random actions."""
    kw = dict(wad_file=":test:", width=64, height=40, batch_size=8)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", **kw), "cpu")
    rng = np.random.default_rng(1)
    s = simj.reset(8)
    s = s._replace(
        pos=s.pos + jnp.asarray(rng.uniform(-0.3, 0.3, (8, 3)).astype(np.float32)),
        vel=jnp.asarray(rng.uniform(-2.0, 2.0, (8, 3)).astype(np.float32)),
        fly=jnp.asarray(rng.random(8) < 0.25),
    )
    a = simj.null_actions(8)._replace(
        movement=jnp.asarray(rng.uniform(-1, 1, (8, 2)).astype(np.float32)),
        look=jnp.asarray(rng.uniform(-0.1, 0.1, (8, 2)).astype(np.float32)),
        jump=jnp.asarray(rng.random(8) < 0.5),
        push=jnp.asarray(rng.random(8) < 0.5),
    )
    want = TO_NP(simj.step(s, a))._asdict()
    got = state_to_numpy(simt.step(state_from_numpy(TO_NP(s), "cpu"),
                                   actions_from_numpy(TO_NP(a), "cpu")))
    for f in ("pos", "vel"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-5, err_msg=f)
    for f in ("yaw", "pitch", "object_offset", "eff_active", "trig_alive",
              "exit_triggered", "time", "tick", "fly", "noclip"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trigger_scenarios_fire_like_jax(sims, name):
    """(b) Door / lift / exit scenarios fire the same triggers, effects
    and exit codes in both packages, tick by tick."""
    simj, simt, jstep = sims
    pos, yaw, field, ticks = SCENARIOS[name]
    s = simj.reset(1)._replace(pos=jnp.asarray([pos], jnp.float32))
    if yaw is not None:
        s = s._replace(yaw=jnp.asarray([yaw], jnp.float32))
    a = simj.null_actions(1)
    if field == "back":
        a = a._replace(movement=jnp.asarray([[0.0, 1.0]], jnp.float32))
    else:
        a = a._replace(**{field: jnp.asarray([True])})
    ts = state_from_numpy(TO_NP(s), "cpu")
    ta = actions_from_numpy(TO_NP(a), "cpu")
    fired = False
    for _ in range(ticks):
        s = jstep(s, a)
        ts = simt.step(ts, ta)
        got, want = state_to_numpy(ts), TO_NP(s)._asdict()
        for f in ("eff_active", "trig_alive", "exit_triggered"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name} {f}")
        np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=1e-5)
        fired = fired or bool(want["eff_active"].any() or want["exit_triggered"].any())
    assert fired == (name in FIRING), name


# Measured max |pos| drift between the packages over the 60-tick bench
# trajectory below: 0.0 m (both stay on identical grounded branches);
# the ceiling leaves room for ulp-level noise amplified by contacts.
TRAJECTORY_DRIFT_CEILING = 1e-3


def test_bench_trajectory_drift_ceiling():
    """(b) 60 ticks of bench actions (walk forward, per-env yaw rate)."""
    B = 4
    kw = dict(wad_file=":test:", width=64, height=40, batch_size=B)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp",
                             player=PlayerConfig(clip_substeps=4), **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal",
                                player=TorchPlayer(clip_substeps=4), **kw), "cpu")
    rng = np.random.default_rng(0)
    look = np.stack([rng.uniform(-0.05, 0.05, B).astype(np.float32),
                     np.zeros(B, np.float32)], axis=1)
    move = np.tile(np.array([[0.0, 1.0]], np.float32), (B, 1))
    a = simj.null_actions(B)._replace(movement=jnp.asarray(move), look=jnp.asarray(look))
    s = simj.reset(B)
    ts = state_from_numpy(TO_NP(s), "cpu")
    ta = actions_from_numpy(TO_NP(a), "cpu")
    jstep = jax.jit(simj.step)
    drift = 0.0
    for _ in range(60):
        s = jstep(s, a)
        ts = simt.step(ts, ta)
        drift = max(drift, float(np.abs(ts.pos.numpy() - np.asarray(s.pos)).max()))
    assert drift <= TRAJECTORY_DRIFT_CEILING, drift
    assert np.isfinite(ts.pos.numpy()).all()


def test_port_imports_no_jax():
    """(f) The port never imports JAX (the GPU machine has none)."""
    code = ("import sys; import tpu_doom_torch.models, tpu_doom_torch.ops, "
            "tpu_doom_torch.render.portal; print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """(g) Without nvcc, load() raises a clear error, never a stub."""
    from tpu_doom_torch import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load()
    finally:
        _build.load.cache_clear()


def test_tpu_backend_names_raise():
    """The port picks kernel or plain version by device; TPU-only
    backend names are refused (the reference configurations "portal_jnp"
    and "jnp" are the port's own, tests/test_torch_oracle.py)."""
    for backend in ("portal_interpret", "pallas", "pallas_interpret"):
        with pytest.raises(ValueError):
            TorchSim(TorchConfig(wad_file=":test:", raster_backend=backend), "cpu")
    with pytest.raises(ValueError):
        TorchSim(TorchConfig(wad_file=":test:", raster_backend="portal",
                             player=TorchPlayer(collision_backend="pallas")), "cpu")


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__6a470611_15_peel_resolve_cu_0d48f67319peel_resolve_kernelEPKfS1_S1_S1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__6a470611_15_peel_resolve_cu_0d48f67319peel_resolve_kernelEPKfS1_S1_S1_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 12544 bytes smem
ptxas info    : Compile time = 58.543 ms
"""


def test_ptxas_usage_reads_the_kept_report(tmp_path):
    """The build keeps ptxas -v's report beside the library; ptxas_usage
    gives one line per kernel with its registers, smem and spills."""
    from tpu_doom_torch import _build

    lib = tmp_path / "libtpu_doom_torch_0.so"
    lib.with_suffix(".ptxas.txt").write_text(PTXAS_REPORT)
    assert _build.ptxas_usage(lib) == [
        "peel_resolve_kernel: Used 40 registers, used 1 barriers, 12544 bytes"
        " smem; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]


def test_div_rounds_once_with_a_cached_scalar():
    """_numerics.div divides by a device scalar made once per (value,
    dtype, device), and matches numpy's f32 division exactly."""
    from tpu_doom_torch._numerics import _scalar, div

    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    got = div(torch.as_tensor(x), 0.3).numpy()
    np.testing.assert_array_equal(got, x / np.float32(0.3))
    assert _scalar(0.3, torch.float32, torch.device("cpu")) is _scalar(
        0.3, torch.float32, torch.device("cpu"))
