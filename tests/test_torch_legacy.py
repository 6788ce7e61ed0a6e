"""The port's `legacy` collision oracle (`collision_backend="legacy"`,
and `collision_broadphase=False`) against the JAX package's `legacy`
path on identical inputs, on the CPU; plain PyTorch on any device (the
card test is in tests/test_torch_cuda.py).

Tolerances:
* `sweep_sphere` on identical triangles: hit / miss equal, time and
  normal within 4 ulp (ROADMAP C: XLA on the CPU contracts some a*b+c
  into fused multiply-adds, the port rounds every operation), the
  2000-unit noclip probe within 5e-5 (its vertex quadratic cancels ~8
  digits).
* One tick of `step`: pos and vel within STEP_ATOL, the other fields
  equal (tests/test_torch_sim.py's one-tick tolerance).
* 150-tick trajectories: within tests/test_torch_sim.py's
  TRAJECTORY_DRIFT_CEILING (1e-3), against JAX's `legacy` and against the
  port's B1 path (`auto`).
* The port's brute force against its broad phase over 150 ticks: bitwise
  (tests/test_broadphase.py's invariant).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_doom.models import DoomSim as JaxSim
from tpu_doom.utils.config import GameConfig, PlayerConfig
from tpu_doom_torch.models import DoomSim as TorchSim
from tpu_doom_torch.sim.state import actions_from_numpy, state_from_numpy, state_to_numpy
from tpu_doom_torch.utils.config import GameConfig as TorchConfig
from tpu_doom_torch.utils.config import PlayerConfig as TorchPlayer

TRAJECTORY_DRIFT_CEILING = 1e-3  # tests/test_torch_sim.py
STEP_ATOL = 1e-5  # tests/test_torch_sim.py's one tick
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
BROADPHASE = {"broadphase": True, "brute_force": False}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _sims(broadphase, batch, **pk):
    kw = dict(wad_file=":test:", width=64, height=40, batch_size=batch)
    pk = dict(collision_backend="legacy", collision_broadphase=broadphase, **pk)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", player=PlayerConfig(**pk), **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", player=TorchPlayer(**pk), **kw),
                    "cpu")
    return simj, simt


def _jittered(simj, batch, seed):
    """Reset states moved about the start and through the door corridor,
    with random velocities."""
    rng = np.random.default_rng(seed)
    s = simj.reset(batch)
    pos = np.asarray(s.pos) + rng.uniform(-0.5, 0.5, (batch, 3)) * np.array([1.0, 0.3, 1.0])
    pos[batch // 2:] += np.array([0.3, -0.2, -6.0])
    vel = rng.uniform(-3.0, 3.0, (batch, 3))
    return s._replace(pos=jnp.asarray(pos, jnp.float32), vel=jnp.asarray(vel, jnp.float32))


@pytest.mark.parametrize("mode", list(BROADPHASE))
def test_sweep_sphere_matches_jax(mode):
    """The ground probe, a clip sweep and the noclip probe of 16 envs
    through `sweep_sphere` on the triangles `broadphase_triangles` (or
    `offset_triangles`) gives each env, in both packages."""
    from tpu_doom.sim import collision as jc

    from tpu_doom_torch.sim import collision as tc

    simj, simt = _sims(BROADPHASE[mode], 16)
    s = _jittered(simj, 16, 0)
    ts = state_from_numpy(TO_NP(s), "cpu")
    if BROADPHASE[mode]:
        jt = jax.vmap(lambda o, p: jc.broadphase_triangles(simj.scene, o, p))(
            s.object_offset, s.pos)
        tt = tc.broadphase_triangles(simt.scene, ts.object_offset, ts.pos)
    else:
        jt = (*jax.vmap(lambda o: jc.offset_triangles(simj.scene, o))(s.object_offset),
              jnp.broadcast_to(simj.scene.coll_normal, (16,) + simj.scene.coll_normal.shape))
        tt = (*tc.offset_triangles(simt.scene, ts.object_offset), simt.scene.coll_normal)
    for a, b in zip(tt, jt):  # the same triangles, bit for bit
        np.testing.assert_array_equal(a.expand(b.shape).numpy(), np.asarray(b))
    vel = np.asarray(s.vel)
    cases = {
        "ground": (np.asarray(s.pos), 0.2, np.tile([0.0, -0.21, 0.0], (16, 1))),
        "clip": (np.asarray(s.pos), 0.19, vel / 60.0),
        "noclip": (np.asarray(s.pos) + vel / 60.0 + [0.0, 1000.0, 0.0], 0.19,
                   np.tile([0.0, -2000.0, 0.0], (16, 1))),
    }
    hits = 0
    for name, (c, r, d) in cases.items():
        c, d = c.astype(np.float32), d.astype(np.float32)
        want = jax.vmap(lambda c_, d_, *t: jc.sweep_sphere(c_, jnp.float32(r), d_, *t))(
            jnp.asarray(c), jnp.asarray(d), *jt)
        got = tc.sweep_sphere(torch.as_tensor(c), r, torch.as_tensor(d), *tt)
        wt, wn = np.asarray(want.time), np.asarray(want.normal)
        hit = np.isfinite(wt)
        np.testing.assert_array_equal(np.isfinite(got.time.numpy()), hit, err_msg=name)
        hits += int(hit.sum())
        if name == "noclip":
            np.testing.assert_allclose(got.time.numpy()[hit], wt[hit], rtol=0, atol=5e-5)
        else:
            assert _ulps(got.time.numpy()[hit], wt[hit]).max(initial=0) <= 4, name
            assert _ulps(got.normal.numpy()[hit], wn[hit]).max(initial=0) <= 4, name
    assert hits > 16


@pytest.mark.parametrize("mode", list(BROADPHASE))
def test_legacy_step_one_tick_matches_jax(mode):
    """One tick of `step` through the `legacy` path from identical jittered
    states with random actions, some envs flying or noclipping."""
    simj, simt = _sims(BROADPHASE[mode], 8)
    rng = np.random.default_rng(1)
    s = _jittered(simj, 8, 1)._replace(fly=jnp.asarray(rng.random(8) < 0.25),
                                       noclip=jnp.asarray(rng.random(8) < 0.25))
    a = simj.null_actions(8)._replace(
        movement=jnp.asarray(rng.uniform(-1, 1, (8, 2)).astype(np.float32)),
        look=jnp.asarray(rng.uniform(-0.1, 0.1, (8, 2)).astype(np.float32)),
        jump=jnp.asarray(rng.random(8) < 0.5),
        push=jnp.asarray(rng.random(8) < 0.5),
    )
    want = TO_NP(jax.jit(simj.step)(s, a))._asdict()
    got = state_to_numpy(simt.step(state_from_numpy(TO_NP(s), "cpu"),
                                   actions_from_numpy(TO_NP(a), "cpu")))
    for f in ("pos", "vel", "last_height_diff"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=STEP_ATOL, err_msg=f)
    for f in ("yaw", "pitch", "object_offset", "eff_active", "trig_alive",
              "exit_triggered", "time", "tick", "fly", "noclip"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _walk(sim, batch, ticks, seed=2, jax_sim=None):
    """`ticks` ticks of a jagged walk (forward + strafe + turning + jumps)
    from reset: the port's states (and JAX's, with jax_sim) per tick."""
    rng = np.random.default_rng(seed)
    move = rng.uniform(-1.0, 1.0, (batch, 2)).astype(np.float32)
    move[:, 1] = -1.0
    look = np.stack([rng.uniform(-0.03, 0.03, batch), np.zeros(batch)], 1).astype(np.float32)
    jump = rng.random(batch) < 0.5
    ta = sim.null_actions(batch)._replace(movement=torch.as_tensor(move),
                                          look=torch.as_tensor(look),
                                          jump=torch.as_tensor(jump))
    ts = sim.reset(batch)
    if jax_sim is not None:
        ja = jax_sim.null_actions(batch)._replace(
            movement=jnp.asarray(move), look=jnp.asarray(look), jump=jnp.asarray(jump))
        js, jstep = jax_sim.reset(batch), jax.jit(jax_sim.step)
    for _ in range(ticks):
        ts = sim.step(ts, ta)
        if jax_sim is not None:
            js = jstep(js, ja)
        yield ts, (js if jax_sim is not None else None)


@pytest.mark.parametrize("mode", list(BROADPHASE))
def test_legacy_trajectory_matches_jax(mode):
    """150 ticks of a jagged walk: the port's `legacy` within the drift
    ceiling of JAX's, tick by tick."""
    simj, simt = _sims(BROADPHASE[mode], 2, clip_substeps=2, enable_noclip=False)
    drift = 0.0
    for ts, js in _walk(simt, 2, 150, jax_sim=simj):
        drift = max(drift, float(np.abs(ts.pos.numpy() - np.asarray(js.pos)).max()))
    assert drift <= TRAJECTORY_DRIFT_CEILING, drift
    assert float(np.abs(ts.pos.numpy() - simt.reset(2).pos.numpy()).max()) > 1.0


def test_brute_force_equals_broadphase_over_150_ticks():
    """The port's brute force (every triangle) and broad phase (the grid
    cell's) give bitwise-equal trajectories (tests/test_broadphase.py)."""
    kw = dict(clip_substeps=2, enable_noclip=False, collision_backend="legacy")
    sims = [TorchSim(TorchConfig(wad_file=":test:", batch_size=2,
                                 player=TorchPlayer(collision_broadphase=bp, **kw)), "cpu")
            for bp in (True, False)]
    for (sb, _), (sf, _) in zip(_walk(sims[0], 2, 150), _walk(sims[1], 2, 150)):
        assert torch.equal(sb.pos, sf.pos) and torch.equal(sb.vel, sf.vel)


def test_legacy_matches_b1_path():
    """B1's second oracle: 150 ticks of the `legacy` path within the drift
    ceiling of the shipped path (`auto`: B1's plain version here)."""
    sims = [TorchSim(TorchConfig(wad_file=":test:", batch_size=4,
                                 player=TorchPlayer(collision_backend=cb)), "cpu")
            for cb in ("auto", "legacy")]
    drift = 0.0
    for (sa, _), (sl, _) in zip(_walk(sims[0], 4, 150, seed=3), _walk(sims[1], 4, 150, seed=3)):
        drift = max(drift, float((sa.pos - sl.pos).abs().max()))
    assert drift <= TRAJECTORY_DRIFT_CEILING, drift


def test_tpu_collision_backends_raise():
    """The JAX package's TPU names stay refused; "legacy" and the broad
    phase off are accepted."""
    for cb in ("xla", "pallas", "pallas_interpret"):
        with pytest.raises(ValueError):
            TorchSim(TorchConfig(wad_file=":test:", player=TorchPlayer(collision_backend=cb)),
                     "cpu")
    TorchSim(TorchConfig(wad_file=":test:", player=TorchPlayer(
        collision_backend="legacy", collision_broadphase=False)), "cpu")
