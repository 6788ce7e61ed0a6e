"""The port's `tpu_doom_torch.parallel` and `entry.dryrun_multichip` on
the CPU, in one world of 4 gloo processes (a 2 x 2 ('dp', 'tp') mesh),
against the unsharded port and the JAX package:

(a) dryrun_multichip's main leg (:test: at 64x40, batch 4, one step +
    render) and bank leg (E1M1 + MAP01, E = 2): every rank's state shard
    and frame row band bitwise the same envs and rows of the unsharded
    port's run;
(b) `mean_metric` within 1e-6 relative of JAX's `mean_metric` on the same
    seeded per-env values over a (2, 2) mesh of conftest's virtual CPU
    devices (the sums' order differs), and the dry run's `mean_y` within
    tests/test_torch_sim.py's single-tick tolerance (1e-5) of JAX's
    sharded step;
(c) the bank's exit migration across shards: the env at E1M1's exit
    switch (tests/test_torch_bank.py's parking) sits on dp rank 1 and the
    first free slot of E1M2's group on dp rank 0; the sharded
    `step_with_exits` bitwise the unsharded port's bank in state, active
    mask and moved envs, which match JAX's step_with_exits as in
    `test_step_with_exits_matches_jax`;
(d) dryrun_multichip prints both OK lines on every rank;
(e) set-up: `initialize` / `initialize_from_env` join nothing with
    nothing set, `make_mesh` raises without a world and when dp * tp is
    not the world size, and `launch` reports a failing rank.
The ranks run the port only; JAX runs in this process. ~40 s.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tpu_doom_torch.parallel import launch

EXIT_POS = [-2.56, 0.68, -14.7]  # E1M1's exit switch (tests/test_bank.py)
WORLD, W, H = 4, 64, 40
MEAN_METRIC_RTOL = 1e-6
STEP_ATOL = 1e-5  # tests/test_torch_sim.py: one tick against JAX
# Exit cases on (L, E) = (2, 4), dp = 2: env (0, 2) (dp rank 1) parked at
# the exit and pushing; E1M2's free slots 0 and 1 lie on dp rank 0.
# name -> (active, ticks, park every tick).
BANK_CASES = {
    "migrates": ([[True] * 4, [False, False, True, True]], 1, False),
    "capacity_fallback": ([[True] * 4] * 2, 1, False),
    "soak": ([[True] * 4, [False, False, True, True]], 4, True),
}
PARKED = (0, 2)


def _exit_run(bank, active, acts, ticks, park, mesh=None):
    """`ticks` step_with_exits of `bank` from reset with env PARKED put at
    the exit first (every tick with `park`) -> ([(active, moved)] per
    tick, final state) as numpy. Under `mesh` the (L, E) tensors are this
    rank's dp block and only the rank holding PARKED moves it."""
    from tpu_doom_torch.parallel.mesh import block, shard_batch_pytree
    from tpu_doom_torch.sim.state import Actions

    E = active.shape[1]
    state, act = bank.reset(E), torch.as_tensor(active)
    acts = Actions(**{k: torch.as_tensor(v) for k, v in acts.items()})
    envs = slice(0, E)
    if mesh is not None:
        envs = block(E, mesh, "dp")
        state, act, acts = (shard_batch_pytree(x, mesh, axis=1) for x in (state, act, acts))
    ticks_out = []
    for t in range(ticks):
        if (t == 0 or park) and envs.start <= PARKED[1] < envs.stop:
            pos = state.pos.clone()
            pos[PARKED[0], PARKED[1] - envs.start] = torch.tensor(EXIT_POS)
            state = state._replace(pos=pos)
        state, act, moved = bank.step_with_exits(state, act, acts)
        ticks_out.append((act.numpy().copy(), moved.numpy().copy()))
    return ticks_out, type(state)(*(x.numpy() for x in state))


def _exit_bank(mesh=None):
    from tpu_doom_torch.models import LevelBank
    from tpu_doom_torch.tools.banks import bank_levels
    from tpu_doom_torch.utils.config import GameConfig, PlayerConfig

    cfg = GameConfig(wad_file=":test:", width=W, height=H,
                     player=PlayerConfig(clip_substeps=1, enable_noclip=False))
    return LevelBank(bank_levels(((":test:", 0), (":test:", 1)), cfg), cfg, "cpu", mesh=mesh)


def _world(values, cases):
    """One rank of the test world: the dry run (its stdout kept), the
    seeded values' mean_metric, the bank's exit cases, a bad mesh."""
    from tpu_doom_torch.entry import dryrun_multichip
    from tpu_doom_torch.parallel import make_mesh, mean_metric, shard_batch_pytree

    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dry = dryrun_multichip(WORLD, device="cpu", width=W, height=H)
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    mean = float(mean_metric(shard_batch_pytree(torch.as_tensor(values), mesh), mesh))
    bank = _exit_bank(mesh)
    runs = {name: _exit_run(bank, *case, mesh=mesh) for name, case in cases.items()}
    try:
        make_mesh(dp=3, tp=1, device="cpu")
        mesh_error = None
    except ValueError as e:
        mesh_error = str(e)
    return dict(dry=dry, stdout=out.getvalue(), mean=mean, runs=runs,
                dp=mesh.get_local_rank("dp"), mesh_error=mesh_error)


def _fail(rank_to_fail):
    import torch.distributed as dist

    if dist.get_rank() == rank_to_fail:
        raise ValueError(f"rank {rank_to_fail} fails on purpose")
    return dist.get_rank()


def _case_inputs(name):
    """(active (2, 4) bool, numpy actions (2, 4, ...), ticks, park):
    tests/test_torch_bank.py's seeded actions, standing still, PARKED
    pushing."""
    from test_torch_bank import _stacked_actions

    active, ticks, park = BANK_CASES[name]
    push = np.zeros((2, 4), bool)
    push[PARKED] = True
    acts = _stacked_actions(2, 4, seed=5, push=push)
    acts["movement"][:] = 0.0
    return np.array(active), acts, ticks, park


@pytest.fixture(scope="module")
def values():
    return np.random.default_rng(7).standard_normal(8).astype(np.float32)


@pytest.fixture(scope="module")
def world(values):
    cases = {name: _case_inputs(name) for name in BANK_CASES}
    return launch(WORLD, _world, values, cases, device="cpu", backend="gloo")


def test_sharded_dry_run_equals_unsharded_port(world):
    """(a) Every rank's shards of both legs bitwise the unsharded port's
    same envs and rows; the tp ranks of a dp block hold the same envs."""
    from tpu_doom_torch.entry import dryrun_reference

    (state, frames, _), (bstate, active, moved, bidx) = dryrun_reference(2, "cpu", W, H)
    # spread_yaw turns every env apart: a shard in the wrong place shows.
    assert len({f.numpy().tobytes() for f in frames}) == 4
    assert all(len({f.numpy().tobytes() for f in lv}) == 2 for lv in bidx)
    rows_seen = set()
    for r in (w["dry"] for w in world):
        assert r["mesh"] == (2, 2) and not r["captured"]
        envs, rows, benvs = slice(*r["envs"]), slice(*r["rows"]), slice(*r["bank"]["envs"])
        rows_seen.add(r["rows"])
        assert r["frames"].shape == (2, H // 2, W)
        assert np.array_equal(r["frames"], frames[envs, rows].numpy())
        for got, want in zip(r["state"], state):
            assert np.array_equal(got, want[envs].numpy())
        b = r["bank"]
        assert np.array_equal(b["frames"], bidx[:, benvs, rows].numpy())
        assert np.array_equal(b["active"], active[:, benvs].numpy())
        assert np.array_equal(b["moved"], moved[:, benvs].numpy())
        for got, want in zip(b["state"], bstate):
            assert np.array_equal(got, want[:, benvs].numpy())
    assert rows_seen == {(0, H // 2), (H // 2, H)}


def test_mean_metric_matches_jax(world, values):
    """(b) The same seeded per-env values: the port's mean_metric on every
    rank within 1e-6 relative of JAX's over a 2 x 2 mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_doom.parallel.mesh import make_mesh, mean_metric

    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    want = float(mean_metric(jax.device_put(values, NamedSharding(mesh, P("dp"))), mesh))
    for w in world:
        assert abs(w["mean"] - want) <= MEAN_METRIC_RTOL * abs(want), (w["mean"], want)
    assert len({w["mean"] for w in world}) == 1


def test_dry_run_mean_y_matches_jax_sharded_step(world):
    """(b) The dry run's mean_y against JAX's step of the same sim sharded
    over a 2 x 2 mesh (`__graft_entry__.dryrun_multichip`'s placement)."""
    import jax

    from __graft_entry__ import _make_sim
    from tpu_doom.parallel.mesh import (
        make_mesh,
        mean_metric,
        replicate_pytree,
        shard_batch_pytree,
    )
    from tpu_doom.sim.step import step as sim_step

    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    sim = _make_sim(width=W, height=H, batch=4, backend="portal_jnp", crossings=8)
    scene = replicate_pytree(sim.scene, mesh)
    state = shard_batch_pytree(sim.reset(4), mesh)
    acts = shard_batch_pytree(sim.null_actions(4), mesh)
    state = jax.jit(lambda s, a: sim_step(scene, sim.config, s, a))(state, acts)
    want = float(mean_metric(state.pos[:, 1], mesh))
    for w in world:
        got = w["dry"]["metrics"]["mean_y"]
        assert abs(got - want) <= STEP_ATOL, (got, want)


@pytest.fixture(scope="module")
def jax_exit_bank():
    import jax

    from test_torch_bank import PAIRS, _banks

    jb, _ = _banks(PAIRS["e1m1_e1m2"])
    return jb, jax.jit(jb.step_with_exits)


@pytest.mark.parametrize("case", sorted(BANK_CASES))
def test_sharded_exit_migration_equals_unsharded_and_jax(world, jax_exit_bank, case):
    """(c) The sharded bank's ticks, dp blocks put together, bitwise the
    unsharded port's (active, moved every tick; the final state), the tp
    ranks alike; and the unsharded port against JAX's step_with_exits
    (active and moved bitwise, states within tests/test_torch_bank.py's
    ceilings). "migrates" and "soak" move PARKED from dp rank 1 into slot
    0 of E1M2's group, on dp rank 0."""
    import jax.numpy as jnp

    from test_torch_bank import _assert_state_close, _jax_actions
    from tpu_doom_torch.sim.state import SimState

    active, acts, ticks, park = _case_inputs(case)
    want_ticks, want_state = _exit_run(_exit_bank(), active, acts, ticks, park)
    for tp in (0, 1):
        blocks = sorted((w for w in world if w["dry"]["rank"] % 2 == tp),
                        key=lambda w: w["dp"])
        assert [w["dp"] for w in blocks] == [0, 1]
        runs = [w["runs"][case] for w in blocks]
        for t in range(ticks):
            for i in (0, 1):  # active, moved
                got = np.concatenate([run[0][t][i] for run in runs], axis=1)
                assert np.array_equal(got, want_ticks[t][i]), (case, tp, t, i)
        for f, x in enumerate(want_state):
            got = np.concatenate([run[1][f] for run in runs], axis=1)
            assert np.array_equal(got, x), (case, SimState._fields[f])
    moved_any = any(m.any() for _, m in want_ticks)
    assert moved_any == (case != "capacity_fallback")
    if moved_any:
        assert want_ticks[0][1][PARKED] and want_ticks[0][0][1, 0]  # rank 1 -> rank 0

    jb, jfn = jax_exit_bank
    js, jact, ja = jb.reset(4), jnp.asarray(active), _jax_actions(acts)
    for t in range(ticks):
        if t == 0 or park:
            js = js._replace(pos=js.pos.at[PARKED].set(jnp.asarray(EXIT_POS)))
        js, jact, jmoved = jfn(js, jact, ja)
        np.testing.assert_array_equal(want_ticks[t][0], np.asarray(jact), err_msg=str(t))
        np.testing.assert_array_equal(want_ticks[t][1], np.asarray(jmoved), err_msg=str(t))
    _assert_state_close(SimState(*(torch.as_tensor(x) for x in want_state)), js)


def test_dry_run_prints_both_ok_lines(world):
    """(d) Every rank printed the main leg's and the bank leg's OK line."""
    for w in world:
        lines = w["stdout"].splitlines()
        assert any(x.startswith("dryrun_multichip OK: mesh={'dp': 2, 'tp': 2} batch=4")
                   for x in lines), w["stdout"]
        assert any(x.startswith("dryrun_multichip bank leg OK: L=2 E=2") for x in lines)
        assert lines == w["dry"]["lines"]


def test_initialize_joins_nothing_when_nothing_is_set(monkeypatch):
    """(e) JAX's single-process rule: no coordinator and one process, or
    no TPUDOOM_* / torchrun variables, join no world."""
    from tpu_doom_torch.parallel import initialize, initialize_from_env

    for k in ("TPUDOOM_COORDINATOR", "TPUDOOM_NUM_PROCS", "TPUDOOM_PROC_ID",
              "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize(num_processes=1, device="cpu") is False
    assert initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_make_mesh_checks_the_world(world):
    """(e) Without a world make_mesh raises; in one, dp * tp must be the
    world size."""
    from tpu_doom_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(device="cpu")
    assert {w["mesh_error"] for w in world} == {"dp*tp (3*1) != world size 4"}


def test_launch_reports_a_failing_rank():
    """(e) A rank that raises fails the launch with its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(2, _fail, 1, device="cpu", backend="gloo")
