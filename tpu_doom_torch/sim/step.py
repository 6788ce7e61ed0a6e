"""The per-tick step: time, move effects, player physics, triggers.

Port of `tpu_doom/sim/step.py` (step.py:26-185). With the shipped
collision config (`collision_backend="auto"`, the broad phase on) the
step is three kernels: S1 (`ops.step.effects_rows`: the effects, the
toggles and B1's rows), B1 (`ops.collision.player_move`: the six
collision sweeps per env) and S2 (`ops.step.player_triggers`: the player
math after the sweeps, the triggers, the clock). Each wrapper launches
its CUDA kernel for CUDA tensors and runs its plain version, this
module's PyTorch code, for CPU tensors. `"legacy"`, or the broad phase
off, runs the JAX package's other path in plain PyTorch on any device:
the `legacy` oracle (`sim/player.py:step_player`) against each env's grid
cell or, with the broad phase off, every triangle of the level. `step_n`
is the multi-tick loop (`tpu_doom/sim/step.py:188-208`).
"""

from __future__ import annotations

from .. import trace
from .collision import broadphase_triangles, offset_triangles
from .effects import animate_effects
from .player import look_direction, step_player
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


def effects_and_toggles(state: SimState, actions: Actions, dt: float):
    """The move effects animated by one tick (`animate_effects`' dict of
    (B, O) fields), and the fly and noclip toggles applied."""
    return (animate_effects(state, dt), state.fly ^ actions.fly_toggle,
            state.noclip ^ actions.clip_toggle)


def poll_and_apply(scene, dt, state: SimState, actions: Actions, eff, fly, noclip,
                   ps) -> SimState:
    """The triggers polled from the moved player `ps` (a PlayerStep),
    the fired ones applied to the effects `eff`: the new state."""
    # `moved` uses the post-move velocity, as the reference.
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
        object_offset=eff["object_offset"],
        **{k: eff_d[k] for k in _EFF},
        trig_alive=trig_alive, exit_triggered=exit_triggered, time=state.time + dt,
        tick=state.tick + 1,
    )


def _step(scene, cfg, state: SimState, actions: Actions) -> SimState:
    from ..ops.collision import player_move
    from ..ops.step import effects_rows, player_triggers

    dt = cfg.timestep
    pcfg = cfg.player
    if pcfg.collision_backend == "auto" and pcfg.collision_broadphase:
        with trace.span("effects"):
            eff, fly, noclip, rows, state8 = effects_rows(scene, state, actions, dt)
        with trace.span("player"):
            mv = player_move(
                rows, state8, radius=pcfg.radius, height=pcfg.height, dt=dt,
                substeps=pcfg.clip_substeps, enable_noclip=pcfg.enable_noclip,
            )
        with trace.span("triggers"):
            return player_triggers(scene, pcfg, dt, state, actions, eff, fly, noclip, mv)

    with trace.span("effects"):
        eff, fly, noclip = effects_and_toggles(state, actions, dt)
    with trace.span("player"):
        if pcfg.collision_broadphase:
            tris = broadphase_triangles(scene, eff["object_offset"], state.pos)
        else:
            tris = (*offset_triangles(scene, eff["object_offset"]), scene.coll_normal)
        ps = step_player(
            pcfg, dt, tris, state.pos, state.vel, state.yaw, state.pitch, fly,
            noclip, state.last_height_diff, actions.movement, actions.look,
            actions.jump,
        )
    with trace.span("triggers"):
        return poll_and_apply(scene, dt, state, actions, eff, fly, noclip, ps)


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
