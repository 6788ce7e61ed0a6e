"""SimState and Actions: NamedTuples of (B, ...) tensors.

Port of `tpu_doom/sim/state.py`, plus numpy converters so the port and
the JAX package can run from identical inputs (a JAX state whose leaves
are turned into numpy arrays converts with `state_from_numpy`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .scene import Scene


class SimState(NamedTuple):
    pos: torch.Tensor  # (B, 3) f32
    vel: torch.Tensor  # (B, 3) f32
    yaw: torch.Tensor  # (B,) f32
    pitch: torch.Tensor  # (B,) f32
    fly: torch.Tensor  # (B,) bool
    noclip: torch.Tensor  # (B,) bool
    last_height_diff: torch.Tensor  # (B,) f32
    object_offset: torch.Tensor  # (B, O) f32
    eff_active: torch.Tensor  # (B, O) bool
    eff_first: torch.Tensor  # (B, O) f32
    eff_second: torch.Tensor  # (B, O) f32
    eff_has_second: torch.Tensor  # (B, O) bool
    eff_wait: torch.Tensor  # (B, O) f32
    eff_speed: torch.Tensor  # (B, O) f32
    trig_alive: torch.Tensor  # (B, K) bool
    exit_triggered: torch.Tensor  # (B,) i32: 0 none, 1 normal, 2 secret
    time: torch.Tensor  # (B,) f32
    tick: torch.Tensor  # (B,) i32

    @property
    def batch(self) -> int:
        return self.pos.shape[0]


class Actions(NamedTuple):
    movement: torch.Tensor  # (B, 2) strafe/forward in [-1, 1]
    look: torch.Tensor  # (B, 2) yaw/pitch deltas
    jump: torch.Tensor  # (B,) bool
    fly_toggle: torch.Tensor  # (B,) bool
    clip_toggle: torch.Tensor  # (B,) bool
    push: torch.Tensor  # (B,) bool
    shoot: torch.Tensor  # (B,) bool


def initial_state(scene: Scene, num_objects: int, batch: int) -> SimState:
    """Player at level start, doors/lifts at rest, all triggers alive."""
    dev = scene.device
    O = max(num_objects, 1)
    K = scene.trig_origin.shape[0]
    f32, b = torch.float32, torch.bool
    return SimState(
        pos=scene.start_pos.to(f32).expand(batch, 3).clone(),
        vel=torch.zeros((batch, 3), dtype=f32, device=dev),
        yaw=scene.start_yaw.to(f32).expand(batch).clone(),
        # 1e-8, not 0: PITCH_EPS in render/portal.py gates on it.
        pitch=torch.full((batch,), 1e-8, dtype=f32, device=dev),
        fly=torch.zeros((batch,), dtype=b, device=dev),
        noclip=torch.zeros((batch,), dtype=b, device=dev),
        last_height_diff=torch.zeros((batch,), dtype=f32, device=dev),
        object_offset=torch.zeros((batch, O), dtype=f32, device=dev),
        eff_active=torch.zeros((batch, O), dtype=b, device=dev),
        eff_first=torch.zeros((batch, O), dtype=f32, device=dev),
        eff_second=torch.zeros((batch, O), dtype=f32, device=dev),
        eff_has_second=torch.zeros((batch, O), dtype=b, device=dev),
        eff_wait=torch.zeros((batch, O), dtype=f32, device=dev),
        eff_speed=torch.zeros((batch, O), dtype=f32, device=dev),
        trig_alive=torch.ones((batch, K), dtype=b, device=dev),
        exit_triggered=torch.zeros((batch,), dtype=torch.int32, device=dev),
        time=torch.zeros((batch,), dtype=f32, device=dev),
        tick=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def null_actions(batch: int, device) -> Actions:
    f32, b = torch.float32, torch.bool
    return Actions(
        movement=torch.zeros((batch, 2), dtype=f32, device=device),
        look=torch.zeros((batch, 2), dtype=f32, device=device),
        jump=torch.zeros((batch,), dtype=b, device=device),
        fly_toggle=torch.zeros((batch,), dtype=b, device=device),
        clip_toggle=torch.zeros((batch,), dtype=b, device=device),
        push=torch.zeros((batch,), dtype=b, device=device),
        shoot=torch.zeros((batch,), dtype=b, device=device),
    )


def _from_numpy(cls, src, device):
    return cls(**{
        k: torch.as_tensor(np.array(getattr(src, k)), device=device)
        for k in cls._fields
    })


def state_from_numpy(state, device) -> SimState:
    """Any object with SimState's fields as array-likes (e.g. a JAX
    SimState) -> SimState of tensors on `device`."""
    return _from_numpy(SimState, state, device)


def actions_from_numpy(actions, device) -> Actions:
    return _from_numpy(Actions, actions, device)


def state_to_numpy(state: SimState) -> dict:
    """SimState -> {field: numpy array}."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in SimState._fields}
