"""The per-tick step: time, move effects, player physics, triggers.

Port of `tpu_doom/sim/step.py` (step.py:26-185). With the shipped
collision config (`collision_backend="auto"`, the broad phase on) the six
collision sweeps per env go through kernel B1
(`ops.collision.player_move`), which launches the CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors. `"legacy"`, or the
broad phase off, runs the JAX package's other path: the `legacy` oracle
(`sim/player.py:step_player`), plain PyTorch on any device, against each
env's grid cell or, with the broad phase off, every triangle of the
level. `step_n` is the multi-tick loop (`tpu_doom/sim/step.py:188-208`).
"""

from __future__ import annotations

import torch

from .. import trace
from .collision import Contact, broadphase_rows, broadphase_triangles, offset_triangles
from .effects import animate_effects
from .player import look_direction, step_player, step_player_with_moves
from .state import Actions, SimState
from .triggers import apply_fired, poll_triggers

_EFF = ("eff_active", "eff_first", "eff_second", "eff_has_second",
        "eff_wait", "eff_speed")


def check_collision_config(pcfg) -> None:
    """"auto" (B1 on the broad phase's rows; the `legacy` oracle when the
    broad phase is off, as the JAX package's "auto" falls to it) and
    "legacy" are the port's; the other JAX names pick a TPU kernel."""
    if pcfg.collision_backend not in ("auto", "legacy"):
        raise ValueError(
            f"collision_backend={pcfg.collision_backend!r} names a JAX/TPU "
            "backend; the port picks kernel or plain version by device: use "
            "'auto', or 'legacy' for the sweep_sphere oracle")


def step(scene, cfg, state: SimState, actions: Actions) -> SimState:
    """Advance all envs by one 1/60 s tick."""
    check_collision_config(cfg.player)
    with trace.span("step"):
        return _step(scene, cfg, state, actions)


def _step(scene, cfg, state: SimState, actions: Actions) -> SimState:
    from ..ops.collision import player_move

    dt = cfg.timestep
    time = state.time + dt
    with trace.span("effects"):
        eff = animate_effects(state, dt)
    object_offset = eff["object_offset"]
    fly = state.fly ^ actions.fly_toggle
    noclip = state.noclip ^ actions.clip_toggle

    pcfg = cfg.player
    with trace.span("player"):
        if pcfg.collision_backend == "auto" and pcfg.collision_broadphase:
            rows = broadphase_rows(scene, object_offset, state.pos)  # (B, 13, M)
            zeros2 = torch.zeros_like(state.pos[:, :2])
            state8 = torch.cat([state.pos, state.vel, zeros2], dim=1)
            mv = player_move(
                rows, state8, radius=pcfg.radius, height=pcfg.height, dt=dt,
                substeps=pcfg.clip_substeps, enable_noclip=pcfg.enable_noclip,
            )
            ps = step_player_with_moves(
                pcfg, dt, Contact(time=mv[:, 0], normal=mv[:, 1:4]), mv[:, 4:7],
                mv[:, 7:10], mv[:, 10], state.pos, state.vel, state.yaw,
                state.pitch, fly, noclip, state.last_height_diff, actions.movement,
                actions.look, actions.jump,
            )
        else:
            if pcfg.collision_broadphase:
                tris = broadphase_triangles(scene, object_offset, state.pos)
            else:
                tris = (*offset_triangles(scene, object_offset), scene.coll_normal)
            ps = step_player(
                pcfg, dt, tris, state.pos, state.vel, state.yaw, state.pitch, fly,
                noclip, state.last_height_diff, actions.movement, actions.look,
                actions.jump,
            )

    # Triggers: `moved` uses the post-move velocity, as the reference.
    with trace.span("triggers"):
        moved = ps.vel * dt
        look3 = look_direction(ps.yaw, ps.pitch)
        fired = poll_triggers(scene, ps.pos[:, 0], ps.pos[:, 2], moved, look3,
                              actions.push, actions.shoot)
        trig_alive, exit_triggered, eff_d = apply_fired(
            scene, fired, state.trig_alive, state.exit_triggered,
            {k: eff[k] for k in _EFF},
        )
        return SimState(
            pos=ps.pos, vel=ps.vel, yaw=ps.yaw, pitch=ps.pitch, fly=fly,
            noclip=noclip, last_height_diff=ps.last_height_diff,
            object_offset=object_offset,
            **{k: eff_d[k] for k in _EFF},
            trig_alive=trig_alive, exit_triggered=exit_triggered, time=time,
            tick=state.tick + 1,
        )


def step_n(scene, cfg, state: SimState, action_seq, n: int, *, graphs=None) -> SimState:
    """n ticks with an (n, B, ...) Actions sequence, or n idle ticks for
    None: the JAX package's `step_n` (a `lax.scan` over `step`). CPU
    tensors step eagerly in a loop; on the card the tick is captured once
    as a CUDA graph and replayed n times (`graphs.TickGraphs`; pass one
    as `graphs` to keep its capture for later calls)."""
    from ..graphs import TickGraphs

    if graphs is None:
        graphs = TickGraphs(lambda s, a: step(scene, cfg, s, a))
    return graphs.run(state, action_seq, n)[0]
