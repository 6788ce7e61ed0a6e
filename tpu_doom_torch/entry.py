"""The port's twin of `__graft_entry__.py`.

entry() -> (fn, example_args): one step + render of the flagship model
and example arguments.

    from tpu_doom_torch.entry import entry
    fn, (state, actions) = entry()            # on the card
    state, frames = fn(state, actions)

`fn` is a tick that `graphs.CapturedTick(fn, state, actions)` captures
as one CUDA graph: its state the SimState, its other output the (B, H, W)
u8 frames.

dryrun_multichip(n): one step + render of the flagship model, and one
tick of a two-level bank, with the envs sharded over the ('dp', 'tp')
mesh of an n-process world (`tpu_doom_torch.parallel`).

    python -m tpu_doom_torch.entry

runs entry() once, then dryrun_multichip(n) for n = DRYRUN_DEVICES (the
number of cards by default) when n > 1, or as this process's rank when
TPUDOOM_COORDINATOR / TPUDOOM_NUM_PROCS / TPUDOOM_PROC_ID or torchrun
(`torchrun --nproc-per-node N -m tpu_doom_torch.entry`) set up a world.
"""

from __future__ import annotations

import math
import os

import torch


def entry_sim(device="cuda", width=64, height=40, batch=2, crossings=12):
    """The DoomSim `entry()` drives: the synthetic IWAD at 64x40, 2 envs,
    through the portal renderer, on `device` (`dryrun_multichip` asks for
    its own size)."""
    from .models import DoomSim
    from .utils.config import GameConfig, PlayerConfig

    return DoomSim(GameConfig(wad_file=":test:", width=width, height=height,
                              batch_size=batch, raster_backend="portal",
                              portal_crossings=crossings,
                              player=PlayerConfig(clip_substeps=2)), device)


def entry(device="cuda"):
    """(fn, (state, actions)): `fn(state, actions) -> (state, frames)`
    steps and renders `entry_sim(device)` (the card unless the caller
    asks for the CPU, where the kernels' plain versions run)."""
    from .render import render_dispatch
    from .sim.step import step as sim_step

    sim = entry_sim(device)
    scene, cfg, pscene = sim.scene, sim.config, sim.portal_scene()

    def fn(state, actions):
        state = sim_step(scene, cfg, state, actions)
        frames, _ = render_dispatch(scene, pscene, cfg, state, cfg.width, cfg.height)
        return state, frames

    return fn, (sim.reset(2), sim.null_actions(2))


DRYRUN_BANK = ((":test:", 0), (":doom2:", 0))


def dryrun_bank(width, height, device="cuda", mesh=None):
    """The bank of dryrun_multichip's bank leg: E1M1 and MAP01 through
    portal (`__graft_entry__.py:156-167`), under `mesh` if one is given."""
    from .models import LevelBank
    from .tools.banks import bank_levels
    from .utils.config import GameConfig, PlayerConfig

    cfg = GameConfig(wad_file=":test:", width=width, height=height,
                     raster_backend="portal", portal_crossings=8, render_env_chunk=0,
                     player=PlayerConfig(clip_substeps=1))
    return LevelBank(bank_levels(DRYRUN_BANK, cfg), cfg, device, mesh=mesh)


def spread_yaw(state):
    """`state` with env i of the E on its last axis turned by 2 pi i / E,
    so that every env of a dry run sees its own frame (a shard put in the
    wrong place then shows)."""
    E = state.yaw.shape[-1]
    turn = torch.arange(E, dtype=torch.float32, device=state.yaw.device) * (2 * math.pi / E)
    return state._replace(yaw=state.yaw + turn)


def _numpy(tree):
    return type(tree)(*(x.cpu().numpy() for x in tree))


def _bank_actions(L, E, device):
    from .sim.state import Actions, null_actions

    return Actions(*(x.reshape((L, E) + x.shape[1:]) for x in null_actions(L * E, device)))


def dryrun_reference(dp, device="cuda", width=320, height=200):
    """dryrun_multichip's two legs for a mesh of `dp`, unsharded and eager
    on `device` -> ((state, frames, covered), (bank state, active, moved,
    frames)): what every rank's shards equal."""
    from .render import render_dispatch
    from .sim.step import step as sim_step

    batch = 2 * dp
    sim = entry_sim(device, width, height, batch, crossings=8)
    bank = dryrun_bank(width, height, device)
    L, E = bank.num_levels, max(dp, 2)
    with torch.no_grad():
        state = sim_step(sim.scene, sim.config, spread_yaw(sim.reset(batch)),
                         sim.null_actions(batch))
        frames, covered = render_dispatch(sim.scene, sim.portal_scene(), sim.config, state,
                                          width, height)
        bstate, active, moved = bank.step_with_exits(
            spread_yaw(bank.reset(E)), torch.ones((L, E), dtype=torch.bool, device=device),
            _bank_actions(L, E, device))
        bidx, _ = bank.render(bstate, width, height)
    return (state, frames, covered), (bstate, active, moved, bidx)


def _run(tick, state, actions, captured):
    """One tick: captured as a CUDA graph and replayed once, or eagerly
    -> (state, *outs)."""
    from .graphs import CapturedTick

    if not captured:
        with torch.no_grad():
            return tick(state, actions)
    graph = CapturedTick(tick, state, actions)
    graph.replay()
    return (graph.state_buf, *graph.outs)


def _dryrun_rank(n, device, width, height) -> dict:
    """This rank's part of dryrun_multichip in the initialized world of n
    processes."""
    import torch.distributed as dist

    from .ops import launch_counts
    from .parallel.mesh import (block, frame_sharding, make_mesh, mean_metric, mesh_device,
                                replicate_pytree, shard_batch_pytree, shard_sim)
    from .render import render_dispatch
    from .sim.step import step as sim_step

    tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    mesh = make_mesh(dp=dp, tp=tp, device=device)
    dev = mesh_device(mesh)
    captured = dev.type == "cuda" and dist.get_backend() == "nccl"
    before = launch_counts()
    rank = dist.get_rank()
    lines = []

    # The main leg: 2 envs per dp shard of :test: through portal (B1, B2,
    # and B3 on overflow).
    batch = 2 * dp
    if height % tp:
        raise ValueError(f"height {height} does not split over tp={tp}")
    sim = entry_sim(dev, width, height, batch, crossings=8)
    cfg = sim.config
    pscene = replicate_pytree(sim.portal_scene(), mesh)
    scene, state, actions = shard_sim(sim.scene, spread_yaw(sim.reset(batch)),
                                      sim.null_actions(batch), mesh)
    envs, rows, _ = frame_sharding(mesh).index((batch, height, width))

    def tick(state, actions):
        state = sim_step(scene, cfg, state, actions)
        frames, covered = render_dispatch(scene, pscene, cfg, state, width, height)
        return (state, frames[:, rows], mean_metric(covered, mesh),
                mean_metric(state.pos[:, 1], mesh))

    state, band, coverage, mean_y = _run(tick, state, actions, captured)
    assert band.shape == (batch // dp, height // tp, width), band.shape
    metrics = {"coverage": float(coverage), "mean_y": float(mean_y)}
    assert metrics["coverage"] > 0.5, metrics
    lines.append(f"dryrun_multichip OK: mesh={{'dp': {dp}, 'tp': {tp}}} batch={batch}"
                 f" frames={(batch, height, width)} metrics={metrics} rank={rank}"
                 f" shard={tuple(band.shape)} captured={captured}")
    print(lines[-1], flush=True)
    out = dict(rank=rank, mesh=(dp, tp), captured=captured, envs=(envs.start, envs.stop),
               rows=(rows.start, rows.stop), state=_numpy(state), frames=band.cpu().numpy(),
               metrics=metrics)

    # The bank leg: (L, E) envs sharded on axis 1; exits migrate across
    # the dp shards through the bank's all-gather.
    bank = dryrun_bank(width, height, dev, mesh)
    L, E = bank.num_levels, max(dp, 2)
    bstate = shard_batch_pytree(spread_yaw(bank.reset(E)), mesh, axis=1)
    active = shard_batch_pytree(torch.ones((L, E), dtype=torch.bool, device=dev), mesh,
                                axis=1)
    acts = shard_batch_pytree(_bank_actions(L, E, dev), mesh, axis=1)

    def bank_tick(carry, acts):
        s, act = carry
        s, act, moved = bank.step_with_exits(s, act, acts)
        idx, cov = bank.render(s, width, height)
        return (s, act), idx[:, :, rows], mean_metric(cov, mesh), moved

    (bstate, active), bidx, bcov, moved = _run(bank_tick, (bstate, active), acts, captured)
    assert bidx.shape == (L, E // dp, height // tp, width), bidx.shape
    bank_cov = float(bcov)
    assert bank_cov > 0.5, bank_cov
    lines.append(f"dryrun_multichip bank leg OK: L={L} E={E} frames={(L, E, height, width)}"
                 f" coverage={bank_cov:.3f} rank={rank} shard={tuple(bidx.shape)}"
                 f" captured={captured}")
    print(lines[-1], flush=True)
    after = launch_counts()
    benvs = block(E, mesh, "dp")
    out["bank"] = dict(envs=(benvs.start, benvs.stop), state=_numpy(bstate),
                       active=active.cpu().numpy(), moved=moved.cpu().numpy(),
                       frames=bidx.cpu().numpy(), coverage=bank_cov)
    out.update(lines=lines, launches={k: after[k] - before[k] for k in after})
    return out


def dryrun_multichip(n: int, device="cuda", backend=None, width=320, height=200):
    """One step + render with the envs sharded over an n-process
    ('dp', 'tp') mesh, then one tick of a two-level bank under the same
    mesh: the twin of `__graft_entry__.dryrun_multichip`, at its shapes by
    default (tests pass smaller ones).

    Inside an initialized world of n processes it runs as this rank and
    returns this rank's result; otherwise it starts such a world on this
    host (`parallel.launch`: `backend`, NCCL on the card and gloo on the
    CPU by default) and returns every rank's, in rank order. The mesh has
    tp = 2 when n is even and at least 4, else 1; dp = n / tp.

    Main leg: 2 envs per dp shard of `:test:` through `portal` with
    portal_crossings=8 (B1, B2, and B3 for envs that overflow), turned
    apart (`spread_yaw`), one step and render on each rank's shard; the
    metrics `coverage` and `mean_y` through `mean_metric`. A tp rank
    renders its dp shard's full frames and keeps its row band
    (`frame_sharding`): what XLA does with an opaque custom call under
    `with_sharding_constraint`. Bank leg: E1M1 and MAP01, E = max(dp, 2)
    envs per level turned apart, the (L, E) state sharded on its env
    axis, one `step_with_exits` (its exit migration all-gathers the masks
    over dp) and render. Each leg prints its OK line.

    On the card under NCCL each leg's tick, its collectives inside, is
    captured as one CUDA graph (`graphs.CapturedTick`, after its eager
    warm-up tick) and replayed once; under gloo, which CUDA graphs cannot
    capture, and on the CPU, each leg runs eagerly. A rank's result:
    its env and row blocks, state shard, frame band and metrics per leg
    (numpy), its OK lines and its kernel launches."""
    import torch.distributed as dist

    from .models.doom_sim import checked_device
    from .parallel.distributed import launch

    checked_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"dryrun_multichip({n}) in a world of {dist.get_world_size()}")
        return _dryrun_rank(n, device, width, height)
    return launch(n, _dryrun_rank, n, device, width, height, device=device, backend=backend)


if __name__ == "__main__":
    import torch.distributed as dist

    from .parallel.distributed import initialize_from_env

    joined = initialize_from_env()
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry OK:", tuple(out[1].shape))
    n = (dist.get_world_size() if joined
         else int(os.environ.get("DRYRUN_DEVICES", str(torch.cuda.device_count()))))
    if n > 1:
        dryrun_multichip(n)
    if joined:
        dist.destroy_process_group()
