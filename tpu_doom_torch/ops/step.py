"""Kernels S1 and S2: the step's work around kernel B1, one launch each.

Neither replaces a Pallas kernel: the JAX package's step,
`tpu_doom/sim/step.py`, runs this work as XLA ops around its
`player_move_pallas` call. In PyTorch it was ~495 small kernels a tic.

S1 `effects_rows` (csrc/step.cu `effects_rows_kernel`): the move effects
(`sim/effects.py:animate_effects`), the fly and noclip toggles, and B1's
inputs: the rows of each env's broad-phase grid cell with the objects'
new offsets (`sim/collision.py:broadphase_rows`, (B, 13, M)) and its state
(B, 8) [pos vel 0 0].

S2 `player_triggers` (csrc/step.cu `player_triggers_kernel`): from B1's
sweeps, the post-sweep player math (`sim/player.py:
step_player_with_moves`), the look direction, the trigger poll and the
fired effects (`sim/triggers.py`) and the clock: the new SimState, whose
object offsets and toggles are S1's.

The plain versions, `effects_rows_ref` and `player_triggers_ref`, are the
step's PyTorch code (`sim/step.py` keeps it for the `legacy` backend and
the broad phase off). The wrappers check shapes and dtypes, then run the
plain version for CPU tensors and launch the kernel for CUDA tensors,
which the card tests hold bitwise to it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .._build import check, load
from .._numerics import f32
from ..sim.collision import Contact, broadphase_rows
from ..sim.player import JUMP_SPEED, step_player_with_moves
from ..sim.state import SimState
from ..sim.step import effects_and_toggles, poll_and_apply

F, BOOL, I32 = torch.float32, torch.bool, torch.int32
# The objects' effect fields S1 animates (the rest pass through).
ANIMATED = ("object_offset", "eff_active", "eff_first", "eff_has_second", "eff_wait")
# The new state's fields S2 writes, in csrc/step.cu's struct PlayerOut order.
S2_OUT = ("pos", "vel", "yaw", "pitch", "last_height_diff", "time", "tick",
          "trig_alive", "exit_triggered", "eff_active", "eff_first", "eff_second",
          "eff_has_second", "eff_wait", "eff_speed")


def _checked(name, dev, specs):
    """The tensors of `specs` ((label, tensor, shape, dtype) each),
    contiguous; ValueError for a tensor of another shape, dtype or device."""
    out = []
    for label, t, shape, dtype in specs:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: {label} is {tuple(t.shape)} {t.dtype} on {t.device},"
                             f" wants {shape} {dtype} on {dev}")
        out.append(t.contiguous())
    return out


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _empty(like):
    """A contiguous tensor of `like`'s shape, dtype and device."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _device(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def effects_rows_ref(scene, state, actions, dt):
    """Plain PyTorch version of kernel S1 -> (eff, fly, noclip, rows,
    state8): eff the effect fields (`animate_effects`), rows (B, 13, M)
    and state8 (B, 8) kernel B1's inputs."""
    eff, fly, noclip = effects_and_toggles(state, actions, dt)
    rows = broadphase_rows(scene, eff["object_offset"], state.pos)
    zeros2 = torch.zeros_like(state.pos[:, :2])
    state8 = torch.cat([state.pos, state.vel, zeros2], dim=1)
    return eff, fly, noclip, rows, state8


def effects_rows(scene, state, actions, dt):
    """Kernel S1 for CUDA tensors, its plain version for CPU tensors."""
    dev = _device("effects_rows", state.pos)
    B, O = state.object_offset.shape
    cells, M = scene.bp_cells.shape
    T = scene.coll_v0.shape[0]
    bo = (B, O)
    ins = _checked("effects_rows", dev, [
        ("pos", state.pos, (B, 3), F), ("vel", state.vel, (B, 3), F),
        ("object_offset", state.object_offset, bo, F),
        ("eff_active", state.eff_active, bo, BOOL), ("eff_first", state.eff_first, bo, F),
        ("eff_second", state.eff_second, bo, F),
        ("eff_has_second", state.eff_has_second, bo, BOOL),
        ("eff_wait", state.eff_wait, bo, F), ("eff_speed", state.eff_speed, bo, F),
        ("fly", state.fly, (B,), BOOL), ("noclip", state.noclip, (B,), BOOL),
        ("fly_toggle", actions.fly_toggle, (B,), BOOL),
        ("clip_toggle", actions.clip_toggle, (B,), BOOL),
        ("bp_origin", scene.bp_origin, (2,), F), ("bp_inv_cell", scene.bp_inv_cell.reshape(-1), (1,), F),
        ("bp_dims", scene.bp_dims, (2,), I32), ("bp_cells", scene.bp_cells, (cells, M), I32),
        ("coll_v0", scene.coll_v0, (T, 3), F), ("coll_v1", scene.coll_v1, (T, 3), F),
        ("coll_v2", scene.coll_v2, (T, 3), F), ("coll_normal", scene.coll_normal, (T, 3), F),
        ("coll_object", scene.coll_object, (T,), I32),
    ])
    if dev.type == "cpu":
        return effects_rows_ref(scene, state, actions, dt)
    animated = {k: _empty(getattr(state, k)) for k in ANIMATED}
    fly, noclip = _empty(state.fly), _empty(state.noclip)
    rows = torch.empty((B, 13, M), dtype=F, device=dev)
    state8 = torch.empty((B, 8), dtype=F, device=dev)
    outs = [*animated.values(), fly, noclip, rows, state8]
    in_ptrs, out_ptrs = _pointers(ins), _pointers(outs)  # alive through the call
    check(load().tdt_effects_rows(
        ctypes.addressof(in_ptrs), len(ins), ctypes.addressof(out_ptrs), len(outs), B, O, M,
        f32(dt), torch.cuda.current_stream(dev).cuda_stream,
    ), "effects_rows")
    effects_rows.launches += 1
    eff = dict(animated, eff_second=state.eff_second, eff_speed=state.eff_speed)
    return eff, fly, noclip, rows, state8


effects_rows.launches = 0


def player_triggers_ref(scene, pcfg, dt, state, actions, eff, fly, noclip, mv):
    """Plain PyTorch version of kernel S2 -> the new SimState. mv: B1's
    (B, 16) output; eff, fly, noclip: S1's."""
    ps = step_player_with_moves(
        pcfg, dt, Contact(time=mv[:, 0], normal=mv[:, 1:4]), mv[:, 4:7], mv[:, 7:10],
        mv[:, 10], state.pos, state.vel, state.yaw, state.pitch, fly, noclip,
        state.last_height_diff, actions.movement, actions.look, actions.jump,
    )
    return poll_and_apply(scene, dt, state, actions, eff, fly, noclip, ps)


def player_triggers(scene, pcfg, dt, state, actions, eff, fly, noclip, mv):
    """Kernel S2 for CUDA tensors, its plain version for CPU tensors."""
    dev = _device("player_triggers", state.pos)
    B, O = state.object_offset.shape
    K, D = scene.trig_origin.shape[0], scene.eff_trigger.shape[0]
    bo, k, d = (B, O), (K,), (D,)
    ins = _checked("player_triggers", dev, [
        ("mv", mv, (B, 16), F), ("pos", state.pos, (B, 3), F), ("vel", state.vel, (B, 3), F),
        ("yaw", state.yaw, (B,), F), ("pitch", state.pitch, (B,), F),
        ("last_height_diff", state.last_height_diff, (B,), F), ("time", state.time, (B,), F),
        ("tick", state.tick, (B,), I32), ("trig_alive", state.trig_alive, (B, K), BOOL),
        ("exit_triggered", state.exit_triggered, (B,), I32),
        ("fly", fly, (B,), BOOL), ("noclip", noclip, (B,), BOOL),
        ("eff_active", eff["eff_active"], bo, BOOL), ("eff_first", eff["eff_first"], bo, F),
        ("eff_second", eff["eff_second"], bo, F),
        ("eff_has_second", eff["eff_has_second"], bo, BOOL),
        ("eff_wait", eff["eff_wait"], bo, F), ("eff_speed", eff["eff_speed"], bo, F),
        ("movement", actions.movement, (B, 2), F), ("look", actions.look, (B, 2), F),
        ("jump", actions.jump, (B,), BOOL), ("push", actions.push, (B,), BOOL),
        ("shoot", actions.shoot, (B,), BOOL),
        ("trig_origin", scene.trig_origin, (K, 2), F),
        ("trig_displace", scene.trig_displace, (K, 2), F),
        ("trig_length", scene.trig_length, k, F), ("trig_type", scene.trig_type, k, I32),
        ("trig_only_once", scene.trig_only_once, k, BOOL), ("trig_exit", scene.trig_exit, k, I32),
        ("eff_trigger", scene.eff_trigger, d, I32), ("eff_object", scene.eff_object, d, I32),
        ("eff_first_offset", scene.eff_first_offset, d, F),
        ("eff_second_offset", scene.eff_second_offset, d, F),
        ("eff_has_second", scene.eff_has_second, d, BOOL),
        ("eff_speed", scene.eff_speed, d, F), ("eff_wait", scene.eff_wait, d, F),
    ])
    if dev.type == "cpu":
        return player_triggers_ref(scene, pcfg, dt, state, actions, eff, fly, noclip, mv)
    new = {name: _empty(getattr(state, name)) for name in S2_OUT}
    outs = list(new.values())
    in_ptrs, out_ptrs = _pointers(ins), _pointers(outs)  # alive through the call
    half_pi = f32(math.pi / 2)
    check(load().tdt_player_triggers(
        ctypes.addressof(in_ptrs), len(ins), ctypes.addressof(out_ptrs), len(outs), B, K, D, O,
        f32(dt), f32(pcfg.height), f32(pcfg.move_force),
        f32(pcfg.friction), f32(pcfg.ground_drag), f32(pcfg.air_drag),
        f32(pcfg.spring_const_p), f32(pcfg.spring_const_d),
        f32(f32(1e-2) - half_pi), f32(half_pi - f32(1e-2)),
        float(np.float32(JUMP_SPEED) / np.float32(f32(dt))), int(bool(pcfg.enable_noclip)),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "player_triggers")
    player_triggers.launches += 1
    return SimState(**new, fly=fly, noclip=noclip, object_offset=eff["object_offset"])


player_triggers.launches = 0
