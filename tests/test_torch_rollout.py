"""The port's multi-tick API (`DoomSim.rollout`, `step_n`, the exit and
level helpers) and the device-side form of the tick's one host decision,
on the CPU (every kernel wrapper takes its plain version here; the card
tests in tests/test_torch_cuda.py replay the captured graphs).

Tolerances:
* rollout against a loop of the port's own `step_render`: bitwise, in
  frames and state.
* The port against JAX's `DoomSim.rollout` / `step_n` (`portal_jnp`, the
  reference configuration) on the same seeded actions: frames within the
  largest per-frame ceiling of tests/test_torch_render.py's PORTAL_CEILING;
  discrete state fields equal, float fields within
  tests/test_torch_sim.py's TRAJECTORY_DRIFT_CEILING (1e-3).
* The fallback decided on the device (every env through the triangle
  path, then `torch.where`) against the host branch (`nonzero`, the
  fallen envs alone): bitwise.
* `reset_exited` against JAX's: bitwise.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from tpu_doom.models import DoomSim as JaxSim
from tpu_doom.utils.config import GameConfig, PlayerConfig
from tpu_doom_torch.graphs import device_decisions
from tpu_doom_torch.models import DoomSim as TorchSim
from tpu_doom_torch.sim.state import Actions, SimState, state_from_numpy, state_to_numpy
from tpu_doom_torch.utils.config import GameConfig as TorchConfig
from tpu_doom_torch.utils.config import PlayerConfig as TorchPlayer

W, H, B, N = 64, 40, 3, 7
TRAJECTORY_DRIFT_CEILING = 1e-3  # tests/test_torch_sim.py
DISCRETE = ("fly", "noclip", "eff_active", "eff_has_second", "trig_alive",
            "exit_triggered", "tick")
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _frame_ceiling():
    """The largest entry of tests/test_torch_render.py's PORTAL_CEILING."""
    path = os.path.join(os.path.dirname(__file__), "test_torch_render.py")
    spec = importlib.util.spec_from_file_location("_torch_render_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return max(mod.PORTAL_CEILING.values())


def _torch_sim(batch=B, **kw):
    cfg = dict(wad_file=":test:", width=W, height=H, batch_size=batch,
               raster_backend="portal", player=TorchPlayer(clip_substeps=4))
    cfg.update(kw)
    return TorchSim(TorchConfig(**cfg), "cpu")


def _action_seq(n, batch, seed=0):
    """A seeded (n, batch, ...) sequence as numpy arrays: walking, turning,
    pushing and jumping."""
    rng = np.random.default_rng(seed)
    return dict(
        movement=rng.uniform(-1.0, 1.0, (n, batch, 2)).astype(np.float32),
        look=rng.uniform(-0.05, 0.05, (n, batch, 2)).astype(np.float32),
        jump=rng.random((n, batch)) < 0.2,
        fly_toggle=np.zeros((n, batch), bool),
        clip_toggle=np.zeros((n, batch), bool),
        push=rng.random((n, batch)) < 0.3,
        shoot=rng.random((n, batch)) < 0.1,
    )


def _torch_actions(seq):
    return Actions(**{k: torch.as_tensor(v) for k, v in seq.items()})


def _states_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("render_every", [1, 3])
@pytest.mark.parametrize("acts", ["idle", "seeded"])
def test_rollout_equals_step_render_loop(render_every, acts):
    """rollout == a loop of step_render, bitwise: frames after each chunk's
    last tick, the n % render_every trailing ticks stepped unrendered."""
    sim = _torch_sim()
    s0 = sim.reset()
    seq = None if acts == "idle" else _torch_actions(_action_seq(N, B))
    state, frames = sim.rollout(s0, seq, N, render_every=render_every)
    s, want = s0, []
    for t in range(N):
        a = sim.null_actions() if seq is None else Actions(*(x[t] for x in seq))
        s, idx, _ = sim.step_render(s, a)
        if (t + 1) % render_every == 0 and t < N - N % render_every:
            want.append(idx)
    assert frames.shape == (N // render_every, B, H, W) and frames.dtype == torch.uint8
    assert torch.equal(frames, torch.stack(want))
    assert _states_equal(state, s)
    assert _states_equal(sim.step_n(s0, seq, N), s)


@pytest.fixture(scope="module")
def jax_rollout():
    """JAX portal_jnp DoomSim.rollout (render_every=3, a tail of 1) and
    step_n over N seeded ticks from reset, as numpy."""
    cfg = GameConfig(wad_file=":test:", width=W, height=H, batch_size=B,
                     raster_backend="portal_jnp", render_env_chunk=0,
                     player=PlayerConfig(clip_substeps=4))
    sim = JaxSim(cfg)
    seq = _action_seq(N, B)
    jseq = type(sim.null_actions(B))(**{k: jnp.asarray(v) for k, v in seq.items()})
    s0 = sim.reset(B)
    final, frames = sim.rollout(s0, jseq, N, render_every=3)
    stepped = sim.step_n(s0, jseq, N)
    return TO_NP(s0), seq, TO_NP(final)._asdict(), np.asarray(frames), TO_NP(stepped)._asdict()


def _assert_state_close(got: SimState, want: dict):
    got = state_to_numpy(got)
    for k in SimState._fields:
        if k in DISCRETE:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TRAJECTORY_DRIFT_CEILING, err_msg=k)


def test_rollout_matches_jax_rollout(jax_rollout):
    s0, seq, want_state, want_frames, _ = jax_rollout
    sim = _torch_sim()
    state, frames = sim.rollout(state_from_numpy(s0, "cpu"), _torch_actions(seq), N,
                                render_every=3)
    assert frames.shape == want_frames.shape == (2, B, H, W)
    mism = (frames.numpy() != want_frames).sum(axis=(2, 3))
    assert mism.max() <= _frame_ceiling(), mism
    _assert_state_close(state, want_state)


def test_step_n_matches_jax_step_n(jax_rollout):
    s0, seq, _, _, want = jax_rollout
    sim = _torch_sim()
    _assert_state_close(sim.step_n(state_from_numpy(s0, "cpu"), _torch_actions(seq), N),
                        want)


def _fallback_state(sim, falls):
    s = sim.reset()
    s = s._replace(pos=torch.tensor([[-2.2, 0.2, -8.8], [-2.56, 0.5, -2.24],
                                     [-3.5, 1.0, -9.0]]),
                   yaw=torch.tensor([0.9, 0.0, 2.0]))
    if falls:
        s = s._replace(pitch=torch.tensor([0.3, 1e-8, -0.2]))
    return s


@pytest.mark.parametrize("backend", ["portal", "portal_jnp"])
@pytest.mark.parametrize("falls", [True, False], ids=["half_pitched", "none_falls"])
def test_device_fallback_equals_host_branch(backend, falls):
    """The captured tick's form of the fallback (every env through the
    triangle path, the fallen ones taking its frame) == the eager host
    branch (the fallen envs alone), bitwise."""
    sim = _torch_sim(raster_backend=backend, portal_pitch="triangle")
    s = _fallback_state(sim, falls)
    want = sim.render(s)
    with device_decisions():
        got = sim.render(s)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if falls:  # the triangle path ran: pitched envs differ from the column walk
        col = _torch_sim(raster_backend=backend).render(s)
        assert not torch.equal(col[0][0], want[0][0])
        assert torch.equal(col[0][1], want[0][1])


def test_reset_exited_matches_jax():
    cfg = dict(wad_file=":test:", width=W, height=H, batch_size=4)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", **cfg))
    simt = TorchSim(TorchConfig(raster_backend="portal", **cfg), "cpu")
    seq = _action_seq(5, 4, seed=3)
    jseq = type(simj.null_actions(4))(**{k: jnp.asarray(v) for k, v in seq.items()})
    s = simj.step_n(simj.reset(4), jseq, 5)
    s = s._replace(exit_triggered=jnp.asarray([1, 0, 2, 0], jnp.int32))
    want = TO_NP(simj.reset_exited(s))._asdict()
    got = state_to_numpy(simt.reset_exited(state_from_numpy(TO_NP(s), "cpu")))
    for k in SimState._fields:
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)
    assert got["tick"].tolist() == [0, 5, 0, 5]


def test_levels_match_jax():
    simj = JaxSim(GameConfig(wad_file=":test:", width=W, height=H, batch_size=1))
    simt = _torch_sim(batch=1)
    assert simt.num_levels == simj.num_levels == 2
    assert simt.list_levels() == simj.list_levels()


def test_level_cache_and_exit_helpers():
    """load_level revisits the cached scene; check() compiles every level
    and comes back; handle_exits moves the batch to the next level only
    when an exit fired."""
    sim = _torch_sim(batch=2)
    scene0 = sim.scene
    sim.load_level(1)
    assert sim.level_index == 1 and sim.scene is not scene0
    sim.load_level(0)
    assert sim.scene is scene0
    assert sim.check() >= 0.0 and sim.level_index == 0 and sim.scene is scene0
    s = sim.reset()
    assert sim.handle_exits(s) is s and sim.level_index == 0
    s = sim.handle_exits(s._replace(exit_triggered=torch.tensor([0, 1], dtype=torch.int32)))
    assert sim.level_index == 1 and int(s.tick.sum()) == 0


# The ops a captured tick cannot hold: they read a value back to the host.
HOST_READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
              "aten::_unique", "aten::_unique2", "aten::unique_dim",
              "aten::unique_consecutive", "aten::is_nonzero", "aten::item"}


class _HostTraffic(TorchDispatchMode):
    """Records every op of the tick that would move data between the host
    and the card: a host read, a boolean-mask index (its shape depends on
    the data), or an input tensor that no earlier op made (data from the
    host: a Python list index, `t[i] = x`, `torch.tensor(...)`)."""

    def __init__(self, known):
        super().__init__()
        self.known, self.keep, self.found = set(known), [], []

    def add(self, tree):
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self.known.add(t.untyped_storage().data_ptr())
                self.keep.append(t)  # no storage address is reused meanwhile

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in HOST_READS:
            self.found.append(name)
        if name.startswith("aten::index") and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in args[1]):
            self.found.append(f"{name} with a boolean mask")
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in self.known:
                self.found.append(f"{name} on host data {tuple(t.shape)}")
        out = func(*args, **kwargs)
        self.add(out)
        return out


@pytest.mark.parametrize("wad,extra", [
    (":test:", {}),
    (":test:", dict(portal_pitch="triangle")),
    (":test:", dict(raster_backend="portal_jnp", portal_pitch="triangle")),
    (":test:", dict(render_env_chunk=2)),
    (":texstress:10x16", {}),
    (":texstress:10x16", dict(portal_global_segs_max=1024)),
], ids=["portal", "fallback", "portal_jnp_fallback", "chunked", "texstress",
        "texstress_active_set"])
def test_tick_moves_nothing_between_host_and_device(monkeypatch, wad, extra):
    """A tick under device_decisions() -- what a captured tick runs --
    makes no host read and takes no data from the host, so that it can be
    captured as a CUDA graph. The kernels' plain versions, which stand in
    for the kernels on the CPU, are left out."""
    from tpu_doom_torch import _numerics
    from tpu_doom_torch.ops import collision, raster

    sim = _torch_sim(batch=3, wad_file=wad, **extra)
    s = _fallback_state(sim, True) if wad == ":test:" else sim.reset()
    a = _torch_actions({k: v[0] for k, v in _action_seq(1, 3).items()})
    ps = sim.portal_scene() or {}
    mode = _HostTraffic([])
    mode.add([s, a, list(ps.values()), list(sim.scene), list(_numerics._SCALARS.values())])

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
        idx, _ = sim.render(sim.step(s, a))
    assert mode.found == []
    assert idx.shape == (3, H, W)


def test_launch_count_bookkeeping():
    """Graph replays add their launches through ops.add_launches, B2's
    per-env launches included; launch_counts adds the conditional bodies'
    (none live here)."""
    from tpu_doom_torch import ops

    ops.reset_launch_counts()
    ops.add_launches({"scatter_live": 3, "render_portal_fused": 2,
                      "render_portal_fused_per_env": 2})
    counts = ops.launch_counts()
    assert counts["scatter_live"] == 3 and counts["render_portal_fused"] == 2
    assert counts["render_portal_fused_per_env"] == 2 and counts["player_move"] == 0
    assert counts == ops.host_launch_counts()
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
