"""The port's LevelBank (`tpu_doom_torch.models.level_bank`) against the
JAX package's on identical inputs, on the CPU (every kernel wrapper takes
its plain version here; tests/test_torch_cuda.py replays the captured
bank tick on the card).

Tolerances:
* `pad_level_arrays` and `reset`: bitwise.
* `step` (30 ticks) and `step_with_exits`: the active mask and `moved`
  bitwise; discrete state fields equal, float fields within
  tests/test_torch_sim.py's TRAJECTORY_DRIFT_CEILING (1e-3).
* `render` against JAX's bank under `portal_jnp` (the reference
  configuration): per env within RENDER_CEILING, the counts measured
  here, never above the verify legs' 16 px.
* The bank's render of a level against the port's DoomSim of that level
  alone: bitwise (the padding is inert), on small and big members and
  under both portal backends.
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from tpu_doom_torch.graphs import device_decisions
from tpu_doom_torch.models import DoomSim as TorchSim
from tpu_doom_torch.models import LevelBank, pad_level_arrays
from tpu_doom_torch.sim.state import Actions, SimState, state_from_numpy, state_to_numpy
from tpu_doom_torch.utils.config import GameConfig as TorchConfig
from tpu_doom_torch.utils.config import PlayerConfig as TorchPlayer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJECTORY_DRIFT_CEILING = 1e-3  # tests/test_torch_sim.py
DISCRETE = ("fly", "noclip", "eff_active", "eff_has_second", "trig_alive",
            "exit_triggered", "tick")
PAIRS = {
    "e1m1_e1m2": ((":test:", 0), (":test:", 1)),
    "e1m1_map01": ((":test:", 0), (":doom2:", 0)),
}
# Measured port-vs-JAX portal_jnp mismatches per env of the bank renders
# below: 1 px on one env under portal, 0 under portal_jnp; the ceilings
# leave headroom and stay under the verify legs' 16 px.
RENDER_CEILING = {"portal": 4, "portal_jnp": 2}
EXIT_POS = [-2.56, 0.68, -14.7]  # E1M1's exit switch (tests/test_bank.py)
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _load_test_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_levels(specs):
    from tpu_doom.geom.builder import compile_level
    from tpu_doom.wad import wadgen
    from tpu_doom.wad.archive import Archive
    from tpu_doom.wad.meta import WadMetadata
    from tpu_doom.wad.tex import TextureDirectory

    meta = WadMetadata.from_file(os.path.join(ROOT, "assets/meta/doom.toml"))
    builders = {":test:": wadgen.build_test_wad, ":doom2:": wadgen.build_doom2_wad}
    out = []
    for wad_file, level in specs:
        wad = Archive(builders[wad_file](), source=wad_file)
        out.append(compile_level(wad, TextureDirectory(wad, meta), meta, level))
    return out


@functools.lru_cache(maxsize=None)
def _port_levels(specs):
    from tpu_doom_torch.geom.builder import compile_level
    from tpu_doom_torch.models.doom_sim import open_wad
    from tpu_doom_torch.wad.meta import WadMetadata
    from tpu_doom_torch.wad.tex import TextureDirectory

    meta = WadMetadata.from_file(os.path.join(ROOT, "assets/meta/doom.toml"))
    out = []
    for wad_file, level in specs:
        wad = open_wad(wad_file)
        out.append(compile_level(wad, TextureDirectory(wad, meta), meta, level))
    return out


PLAYER = dict(clip_substeps=1, enable_noclip=False)  # tests/test_bank.py's


def _banks(specs, **kw):
    """(JAX LevelBank, port LevelBank on the CPU) of the same levels."""
    from tpu_doom.models.level_bank import LevelBank as JaxBank
    from tpu_doom.utils.config import GameConfig, PlayerConfig

    base = dict(wad_file=":test:", width=64, height=40)
    base.update(kw)
    jb = JaxBank(_jax_levels(specs), GameConfig(player=PlayerConfig(**PLAYER), **base))
    tb = LevelBank(_port_levels(specs), TorchConfig(player=TorchPlayer(**PLAYER), **base),
                   "cpu")
    return jb, tb


def _stacked_actions(L, E, seed=0, push=None):
    """Seeded (L, E) actions as numpy: walking and turning, no toggles."""
    rng = np.random.default_rng(seed)
    n = L * E
    acts = dict(
        movement=rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32),
        look=np.stack([rng.uniform(-0.05, 0.05, n), np.zeros(n)], 1).astype(np.float32),
        jump=np.zeros(n, bool), fly_toggle=np.zeros(n, bool), clip_toggle=np.zeros(n, bool),
        push=np.zeros(n, bool) if push is None else np.asarray(push).reshape(n),
        shoot=np.zeros(n, bool))
    return {k: v.reshape((L, E) + v.shape[1:]) for k, v in acts.items()}


def _jax_actions(acts):
    from tpu_doom.sim.state import Actions as JaxActions

    return JaxActions(**{k: jnp.asarray(v) for k, v in acts.items()})


def _torch_actions(acts):
    return Actions(**{k: torch.as_tensor(v) for k, v in acts.items()})


def _assert_state_close(got: SimState, want):
    got, want = state_to_numpy(got), TO_NP(want)._asdict()
    for k in SimState._fields:
        if k in DISCRETE:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TRAJECTORY_DRIFT_CEILING, err_msg=k)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_pad_level_arrays_matches_jax(pair):
    """Every padded field bitwise JAX's, the unit normal in the pad rows
    included."""
    from tpu_doom.models.level_bank import pad_level_arrays as jax_pad

    want = jax_pad(_jax_levels(PAIRS[pair]))
    got = pad_level_arrays(_port_levels(PAIRS[pair]))
    for g, w in zip(got, want):
        assert g.num_objects == w.num_objects
        for f in dataclasses.fields(w):
            if f.name in ("portal", "stats"):
                continue
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    short = min(range(2), key=lambda i: _port_levels(PAIRS[pair])[i].coll_normal.shape[0])
    n = _port_levels(PAIRS[pair])[short].coll_normal.shape[0]
    assert (got[short].coll_normal[n:, 1] == 1.0).all()


@pytest.fixture(scope="module", params=sorted(PAIRS))
def banks(request):
    return request.param, _banks(PAIRS[request.param])


def test_reset_matches_jax(banks):
    _, (jb, tb) = banks
    want = TO_NP(jb.reset(3))._asdict()
    got = state_to_numpy(tb.reset(3))
    for k in SimState._fields:
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8),
                                      err_msg=k)


def test_step_30_ticks_matches_jax(banks):
    """30 ticks of `step` with seeded walking and turning, every level
    unrolled: within the trajectory drift ceiling of JAX's."""
    _, (jb, tb) = banks
    acts = _stacked_actions(2, 3)
    js, ts = jb.reset(3), tb.reset(3)
    ja, ta = _jax_actions(acts), _torch_actions(acts)
    jstep = jax.jit(jb.step)
    for _ in range(30):
        js, ts = jstep(js, ja), tb.step(ts, ta)
    _assert_state_close(ts, js)
    assert not torch.equal(ts.pos, tb.reset(3).pos)


@pytest.mark.parametrize("backend,size", [("portal", (64, 40)), ("portal_jnp", (48, 32))])
def test_render_matches_jax(backend, size):
    """E1M1 + MAP01 at reset with seeded yaws: the port's bank render under
    `portal` and `portal_jnp` against JAX's bank under `portal_jnp`."""
    W, H = size
    jb, _ = _banks(PAIRS["e1m1_map01"], raster_backend="portal_jnp", width=W, height=H,
                   portal_crossings=10, render_env_chunk=0)
    _, tb = _banks(PAIRS["e1m1_map01"], raster_backend=backend, width=W, height=H,
                   portal_crossings=10)
    yaw = np.random.default_rng(3).uniform(0, 6.28, (2, 3)).astype(np.float32)
    js = jb.reset(3)._replace(yaw=jnp.asarray(yaw))
    ji, jc = (np.asarray(x) for x in jb.render(js))
    ti, tc = tb.render(state_from_numpy(TO_NP(js), "cpu"))
    assert ti.shape == (2, 3, H, W) and ti.dtype == torch.uint8
    n = (ti.numpy() != ji).sum(axis=(2, 3))
    nc = (tc.numpy() != jc).sum(axis=(2, 3))
    assert n.max() <= RENDER_CEILING[backend] and nc.max() <= RENDER_CEILING[backend], (n, nc)
    assert jc.mean() > 0.9


def _levels_alone(specs, tb, state, **kw):
    """Each level of the bank rendered by a DoomSim of that level alone."""
    cfg = tb.cfg
    for lv, (wad_file, level) in enumerate(specs):
        sim = TorchSim(TorchConfig(wad_file=wad_file, initial_level_index=level,
                                   width=cfg.width, height=cfg.height,
                                   raster_backend=cfg.raster_backend,
                                   portal_crossings=cfg.portal_crossings, **kw), "cpu")
        yield lv, sim.render(SimState(*(x[lv] for x in state)))


ALONE_CASES = {
    # (levels, backend, extra config)
    "e1m1_e1m2": (PAIRS["e1m1_e1m2"], "portal_jnp", {}),
    "e1m1_map01": (PAIRS["e1m1_map01"], "portal", {}),
    "e1m1_map01_jnp": (PAIRS["e1m1_map01"], "portal_jnp", {}),
    # A member with more than 192 walk rows puts every level on the
    # big-level walk (the visible-seg cull, B4's plain version), and with
    # portal_global_segs_max=1024 on the active-set path.
    "big_member": (((":test:", 0), (":texstress:10x16", 0)), "portal", {}),
    "big_member_active_set": (((":test:", 0), (":texstress:10x16", 0)), "portal",
                              dict(portal_global_segs_max=1024)),
}


@pytest.mark.parametrize("case", list(ALONE_CASES))
def test_bank_render_equals_levels_alone(case):
    """The bank's render of each level == that level rendered alone by the
    port's DoomSim, bitwise (JAX's test_bank_portal_matches_standalone)."""
    specs, backend, extra = ALONE_CASES[case]
    W, H = (48, 32) if backend == "portal_jnp" else (64, 40)
    tb = LevelBank(_port_levels(specs),
                   TorchConfig(wad_file=":test:", width=W, height=H, raster_backend=backend,
                               portal_crossings=10, **extra), "cpu")
    if case.startswith("big_member"):
        assert tb.pscenes["has_back"].shape[1] > 192
    s = tb.reset(2)._replace(yaw=torch.tensor([[0.0, 2.5], [1.2, 4.4]]))
    idx, cov = tb.render(s)
    for lv, (i1, c1) in _levels_alone(specs, tb, s, **extra):
        assert torch.equal(idx[lv], i1) and torch.equal(cov[lv], c1), lv
    assert float(cov.float().mean()) > 0.9


def test_hole_table_padding_reaches_every_texel():
    """E1M1 (holes, 534 texel rows) beside :texstress:6x24 (holeless,
    1,353 rows) under portal_jnp: the hole table pads to ceil(1,353 / 8) =
    170 rows of -128 (the JAX package pads to E1M1's 67, which B8
    refuses), and each level renders as it does alone."""
    specs = ((":test:", 0), (":texstress:6x24", 0))
    tb = LevelBank(_port_levels(specs),
                   TorchConfig(wad_file=":test:", width=48, height=32,
                               raster_backend="portal_jnp", portal_crossings=10), "cpu")
    assert tuple(tb.pscenes["tex_i8"].shape) == (2, 1353, 128)
    assert tuple(tb.pscenes["hole_bytes"].shape) == (2, 170, 128)
    assert bool((tb.pscenes["hole_bytes"][1] == -128).all())
    s = tb.reset(2)._replace(yaw=torch.tensor([[0.0, 2.5], [1.2, 4.4]]))
    idx, cov = tb.render(s)
    for lv, (i1, c1) in _levels_alone(specs, tb, s):
        assert torch.equal(idx[lv], i1) and torch.equal(cov[lv], c1), lv


def _exit_case(case):
    """tests/test_bank.py:172-247's setups -> (active (2, 2), push (2, 2),
    ticks, park env (0, 0) at the exit every tick)."""
    push = np.array([[True, False], [False, False]])
    if case == "migrates":
        return np.array([[True, True], [False, False]]), push, 1, False
    if case == "capacity_fallback":
        return np.ones((2, 2), bool), push, 1, False
    return np.array([[True, True], [False, False]]), push, 6, True  # soak


@pytest.mark.parametrize("case", ["migrates", "capacity_fallback", "soak"])
def test_step_with_exits_matches_jax(case):
    """Exit migration on the device against JAX's step_with_exits: an env
    at E1M1's exit switch respawns at E1M2's start in a free slot of its
    group, or in place when the group is full; over the soak the active
    count holds. Active mask and `moved` bitwise, states within the
    ceilings, every exit flag cleared."""
    jb, tb = _banks(PAIRS["e1m1_e1m2"])
    active, push, ticks, park = _exit_case(case)
    acts = _stacked_actions(2, 2, seed=5, push=push)
    acts["movement"][:] = 0.0
    js, ts = jb.reset(2), tb.reset(2)
    ja, ta = _jax_actions(acts), _torch_actions(acts)
    jact, tact = jnp.asarray(active), torch.as_tensor(active)
    jfn = jax.jit(jb.step_with_exits)
    moved_any = False
    for t in range(ticks):
        if t == 0 or park:
            js = js._replace(pos=js.pos.at[0, 0].set(jnp.asarray(EXIT_POS)))
            pos = ts.pos.clone()
            pos[0, 0] = torch.tensor(EXIT_POS)
            ts = ts._replace(pos=pos)
        js, jact, jmoved = jfn(js, jact, ja)
        ts, tact, tmoved = tb.step_with_exits(ts, tact, ta)
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact), err_msg=str(t))
        np.testing.assert_array_equal(tmoved.numpy(), np.asarray(jmoved), err_msg=str(t))
        _assert_state_close(ts, js)
        assert int(tact.sum()) == int(active.sum())
        assert not bool(ts.exit_triggered.any())
        moved_any = moved_any or bool(tmoved.any())
    assert moved_any == (case != "capacity_fallback")
    if case == "capacity_fallback":  # reset in place at E1M1's start
        assert torch.equal(ts.pos[0, 0], tb.initial_states(2).pos[0, 0])


def test_bank_tick_moves_nothing_between_host_and_device(monkeypatch):
    """A bank tick (step_with_exits, then every level's render) under
    device_decisions() -- what the captured bank tick runs -- makes no host
    read and takes no data from the host (tests/test_torch_rollout.py's
    TorchDispatchMode), with an exit firing and the triangle fallback on."""
    from tpu_doom_torch import _numerics
    from tpu_doom_torch.ops import collision, raster

    rollout = _load_test_module("test_torch_rollout")
    specs = PAIRS["e1m1_map01"]
    tb = LevelBank(_port_levels(specs),
                   TorchConfig(wad_file=":test:", width=64, height=40,
                               raster_backend="portal", portal_pitch="triangle"), "cpu")
    s = tb.reset(3)
    pos, pitch = s.pos.clone(), s.pitch.clone()
    pos[0, 0] = torch.tensor(EXIT_POS)
    pitch[:, 1] = 0.3
    s = s._replace(pos=pos, pitch=pitch)
    active = torch.tensor([[True, True, True], [True, False, False]])
    push = np.zeros((2, 3), bool)
    push[0, 0] = True
    a = _torch_actions(_stacked_actions(2, 3, push=push))
    tb.render(tb.step(s, a))  # makes the cached device scalars
    mode = rollout._HostTraffic([])
    mode.add([s, active, a, list(tb.scenes),
              [v for v in tb.pscenes.values() if isinstance(v, torch.Tensor)],
              list(_numerics._SCALARS.values())])

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
        s2, act2, moved = tb.step_with_exits(s, active, a)
        idx, _ = tb.render(s2)
    assert mode.found == []
    assert idx.shape == (2, 3, 40, 64)
    assert bool(moved[0, 0]) and bool(act2[1, 1]) and not bool(act2[0, 0])
