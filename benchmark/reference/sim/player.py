"""Player physics: look, movement force, PD ground spring, gravity,
clip/noclip commit.

Port of `tpu_doom/sim/player.py` over a written-out env batch: vectors
are (B, 3), scalars (B,). `step_player_with_moves` is the math after the
collision sweeps, shared by both collision paths: kernel B1 computes the
sweeps on the main path; `step_player` runs them through the `legacy`
oracle (`sim/collision.py:sweep_sphere`), the clip substeps of
`_clip_move` and the noclip probe. Three-term sums are written out in the
order XLA reduces them, and host scalars are rounded to f32 as JAX's weak
types are, so single ticks agree with the JAX step to an ulp or so.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._numerics import div, f32, rdiv
from .collision import Contact, sweep_sphere

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
        noclip_pos, noclip_vel = _noclip_post(pos, vel, dt, fly, nc_time)
        new_pos = torch.where(noclip[:, None], noclip_pos, clipped_pos)
        new_vel = torch.where(noclip[:, None], noclip_vel, clipped_vel)
    else:
        new_pos, new_vel = clipped_pos, clipped_vel

    new_vel = new_vel + force * dt
    return PlayerStep(
        pos=new_pos, vel=new_vel, yaw=new_yaw, pitch=new_pitch,
        last_height_diff=height_diff,
    )


def _noclip_post(pos, vel, dt, fly, nc_time):
    """Free movement with a downward ground snap when not flying
    (player.rs:168-190), from the noclip probe's contact time."""
    old_y = pos[:, 1]
    npos = pos + vel * dt
    ground_y = torch.where(
        torch.isfinite(nc_time),
        npos[:, 1] + NOCLIP_PROBE_H * (0.5 - nc_time), old_y,
    )
    snap = ~fly & (npos[:, 1] <= ground_y)
    ny = torch.where(snap, ground_y, npos[:, 1])
    nvy = torch.where(snap & (vel[:, 1] < 0.0), 0.0, vel[:, 1])
    return (torch.stack([npos[:, 0], ny, npos[:, 2]], dim=1),
            torch.stack([vel[:, 0], nvy, vel[:, 2]], dim=1))


# ---------------------------------------------------------------------------
# The `legacy` collision path: the six sweeps through `sweep_sphere`.
# ---------------------------------------------------------------------------


def _sweep(tris, center, radius, displacement):
    """tris: (v0, v1, v2, normal) or (v0, v1, v2, normal, mask)."""
    v0, v1, v2, n = tris[:4]
    mask = tris[4] if len(tris) > 4 else None
    return sweep_sphere(center, radius, displacement, v0, v1, v2, n, mask)


def _axis_y(like, y: float):
    """(B, 3) vectors (0, y, 0)."""
    out = torch.zeros_like(like)
    out[:, 1].fill_(y)
    return out


def step_player(cfg, timestep, tris, pos, vel, yaw, pitch, fly, noclip,
                last_height_diff, movement, look, jump):
    """One tick of player physics with the sweeps run by the `legacy`
    oracle against each env's triangles `tris` (ref player.rs:359-408:
    force, then clip or noclip, then the position, then vel += force*dt)."""
    dt = f32(timestep)
    ground = _sweep(tris, pos, FEET_RADIUS, _axis_y(pos, -f32(cfg.height)))
    clipped_pos, clipped_vel = _clip_move(cfg, tris, pos, vel, dt, cfg.clip_substeps)
    if cfg.enable_noclip:
        nc_time = _noclip_probe(cfg, tris, pos, vel, dt)
    else:
        nc_time = torch.full_like(pos[:, 0], float("inf"))
    return step_player_with_moves(
        cfg, timestep, ground, clipped_pos, clipped_vel, nc_time, pos, vel,
        yaw, pitch, fly, noclip, last_height_diff, movement, look, jump)


def _clip_move(cfg, tris, pos, vel, dt, n_substeps: int):
    """The reference's sweep-project loop (player.rs:142-166) as a fixed
    number of masked substeps: advance to the contact, drop the normal
    component of the velocity, go on with the time left."""
    time_left = torch.full_like(pos[:, 0], dt)
    done = torch.zeros_like(pos[:, 0], dtype=torch.bool)
    for _ in range(n_substeps):
        displacement = vel * time_left[:, None]
        contact = _sweep(tris, pos, cfg.radius, displacement)
        dmag = torch.sqrt(_sum3(displacement, displacement))
        adjusted = contact.time - rdiv(0.001, torch.where(dmag > 0.0, dmag, 1.0))
        blocked = contact.hit & (adjusted < 1.0) & ~done
        t = torch.clamp(contact.time, 0.0, 1.0)
        pos = torch.where(
            done[:, None], pos,
            torch.where(blocked[:, None], pos + displacement * adjusted[:, None],
                        pos + displacement))
        vel = torch.where(
            blocked[:, None],
            vel - contact.normal * _sum3(contact.normal, vel)[:, None], vel)
        time_left = torch.where(blocked, time_left * (1.0 - t), time_left)
        done = done | ~blocked
    return pos, vel


def _noclip_probe(cfg, tris, pos, vel, dt):
    """The noclip ground probe (player.rs:168-178): from the moved
    position, a NOCLIP_PROBE_H-tall downward sweep with the clip radius ->
    contact time (B,), inf for none."""
    center = pos + vel * dt + _axis_y(pos, NOCLIP_PROBE_H / 2.0)
    return _sweep(tris, center, cfg.radius, _axis_y(pos, -NOCLIP_PROBE_H)).time
