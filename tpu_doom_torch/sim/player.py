"""Player physics after the collision sweeps: look, movement force, PD
ground spring, gravity, clip/noclip commit.

Port of `rotate_vec`, `look_direction` and `step_player_with_moves`
from `tpu_doom/sim/player.py`, over a written-out env batch: vectors are
(B, 3), scalars (B,). Three-term sums are written out in the order XLA
reduces them, and host scalars are rounded to f32 as JAX's weak types
are, so single ticks agree with the JAX step to an ulp or so.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._numerics import div, f32
from .collision import Contact

GRAVITY = 17.0  # ref player.rs:308
JUMP_SPEED = 5.0  # ref player.rs:233
FEET_RADIUS = 0.2  # ref player.rs:254-256
NOCLIP_PROBE_H = 2000.0  # ref player.rs:171


class PlayerStep(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    last_height_diff: torch.Tensor


def _sum3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def rotate_vec(yaw, pitch, v):
    """R_y(yaw) @ R_x(pitch) @ v for (B,) angles and (B, 3) vectors."""
    cx, sx = torch.cos(pitch), torch.sin(pitch)
    vy = v[:, 1] * cx - v[:, 2] * sx
    vz = v[:, 1] * sx + v[:, 2] * cx
    vx = v[:, 0]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([vx * cy + vz * sy, vy, -vx * sy + vz * cy], dim=1)


def look_direction(yaw, pitch):
    """Forward vector rot * (0, 0, -1) -> (B, 3)."""
    v = torch.zeros((yaw.shape[0], 3), dtype=torch.float32, device=yaw.device)
    v[:, 2].fill_(-1.0)
    return rotate_vec(yaw, pitch, v)


def _normalize_or_zero(v):
    m = torch.sqrt(_sum3(v, v))[:, None]
    return torch.where(m >= 1e-16, v / torch.where(m >= 1e-16, m, 1.0), 0.0)


def step_player_with_moves(cfg, timestep, ground: Contact, clipped_pos,
                           clipped_vel, nc_time, pos, vel, yaw, pitch, fly,
                           noclip, last_height_diff, movement, look, jump):
    """Post-sweep player math (ref player.rs:142-309) for the whole batch."""
    dt = f32(timestep)
    half_pi = f32(math.pi / 2)

    lo = f32(f32(1e-2) - half_pi) - pitch
    hi = f32(half_pi - f32(1e-2)) - pitch
    new_pitch = pitch + torch.minimum(torch.maximum(-look[:, 1], lo), hi)
    new_yaw = yaw - look[:, 0]

    grounded = ground.hit & (ground.time < 1.0)
    height = torch.where(grounded, cfg.height * ground.time, f32(cfg.height))
    ground_normal = torch.where(grounded[:, None], ground.normal, 0.0)

    zero = torch.zeros_like(movement[:, 0])
    move3 = torch.stack([movement[:, 0], zero, movement[:, 1]], dim=1)
    jump_up = torch.where(jump, 0.5, 0.0)
    fly_dir = _normalize_or_zero(
        torch.stack([movement[:, 0], jump_up, movement[:, 1]], dim=1)
    )
    fly_force = rotate_vec(new_yaw, new_pitch, fly_dir) * cfg.move_force

    walk = rotate_vec(new_yaw, new_pitch, move3)
    walk = torch.stack([walk[:, 0], zero, walk[:, 2]], dim=1)
    walk = _normalize_or_zero(walk) * cfg.move_force
    jumping = grounded & jump & (vel[:, 1] < 0.1)
    walk_grounded = torch.where(
        jumping[:, None],
        torch.stack(
            [walk[:, 0],
             torch.full_like(zero, float(np.float32(JUMP_SPEED) / np.float32(dt))),
             walk[:, 2]], dim=1),
        walk,
    )
    ground_force = torch.where(grounded[:, None], walk_grounded, walk * 0.1)
    move_force = torch.where(fly[:, None], fly_force, ground_force)

    speed = torch.sqrt(_sum3(vel, vel))[:, None]
    has_speed = speed > 0.0
    safe_speed = torch.where(has_speed, speed, 1.0)
    fly_slow = -vel * (cfg.friction / safe_speed + cfg.ground_drag * speed)
    tangential = vel - ground_normal * _sum3(ground_normal, vel)[:, None]
    tspeed = torch.sqrt(_sum3(tangential, tangential))[:, None]
    has_t = tspeed > 0.0
    ground_slow = torch.where(
        has_t,
        -tangential * (cfg.friction / torch.where(has_t, tspeed, 1.0)
                       + cfg.ground_drag * tspeed),
        0.0,
    )
    slowdown = torch.where(
        fly[:, None], fly_slow, torch.where(grounded[:, None], ground_slow, 0.0)
    )
    slowdown = slowdown - vel * cfg.air_drag * speed
    slow_norm = torch.sqrt(_sum3(slowdown, slowdown))[:, None]
    has_slow = has_speed & (slow_norm > 0.0)
    safe_norm = torch.where(has_slow, slow_norm, 1.0)
    max_slowdown = div(-_sum3(vel, slowdown)[:, None] / safe_norm, dt)
    clamped = torch.where(
        slow_norm >= max_slowdown, slowdown / safe_norm * max_slowdown, slowdown
    )
    force = move_force + torch.where(has_slow, clamped, 0.0)

    height_diff = f32(cfg.height) - height
    derivative = div(height_diff - last_height_diff, dt)
    fy = force[:, 1] + (height_diff * cfg.spring_const_p
                        + derivative * cfg.spring_const_d)
    fy = fy + torch.where(fly, 0.0, -GRAVITY)
    force = torch.stack([force[:, 0], fy, force[:, 2]], dim=1)

    if cfg.enable_noclip:
        old_y = pos[:, 1]
        npos = pos + vel * dt
        ground_y = torch.where(
            torch.isfinite(nc_time),
            npos[:, 1] + NOCLIP_PROBE_H * (0.5 - nc_time), old_y,
        )
        snap = ~fly & (npos[:, 1] <= ground_y)
        ny = torch.where(snap, ground_y, npos[:, 1])
        nvy = torch.where(snap & (vel[:, 1] < 0.0), 0.0, vel[:, 1])
        noclip_pos = torch.stack([npos[:, 0], ny, npos[:, 2]], dim=1)
        noclip_vel = torch.stack([vel[:, 0], nvy, vel[:, 2]], dim=1)
        new_pos = torch.where(noclip[:, None], noclip_pos, clipped_pos)
        new_vel = torch.where(noclip[:, None], noclip_vel, clipped_vel)
    else:
        new_pos, new_vel = clipped_pos, clipped_vel

    new_vel = new_vel + force * dt
    return PlayerStep(
        pos=new_pos, vel=new_vel, yaw=new_yaw, pitch=new_pitch,
        last_height_diff=height_diff,
    )
