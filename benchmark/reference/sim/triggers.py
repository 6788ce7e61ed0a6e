"""Trigger polling: walk-over / push / switch / gun line activation.

Port of `tpu_doom/sim/triggers.py` over (env, trigger): every function
takes the whole batch.
"""

from __future__ import annotations

import torch

from ..geom.builder import EXIT_NONE

T_ANY, T_PUSH, T_SWITCH, T_WALKOVER, T_GUN = 0, 1, 2, 3, 4

PUSH_RANGE = 0.5  # ref level.rs:90
SHOOT_RANGE = 100.0  # ref level.rs:91


def _segment_intersect(ox, oz, dx, dz, length, t_origin, t_displace, t_length):
    """Does each env's segment (o, d*len) cross each trigger segment?
    ox..length: (B, 1); t_*: (K, ...) tables. Returns (B, K) bool."""
    tdx, tdz = t_displace[:, 0], t_displace[:, 1]
    denom = dx * tdz - dz * tdx
    nonpar = torch.abs(denom) >= 1e-16
    rx = t_origin[:, 0] - ox
    rz = t_origin[:, 1] - oz
    offset = (rx * tdz - rz * tdx) / torch.where(nonpar, denom, 1.0)
    in_self = (offset >= 0.0) & (offset < length)
    px = ox + dx * offset
    pz = oz + dz * offset
    other = torch.where(
        torch.abs(tdx) > torch.abs(tdz),
        (px - t_origin[:, 0]) / torch.where(tdx == 0.0, 1.0, tdx),
        (pz - t_origin[:, 1]) / torch.where(tdz == 0.0, 1.0, tdz),
    )
    in_other = (other >= 0.0) & (other < t_length)
    return nonpar & in_self & in_other


def poll_triggers(scene, px, pz, moved, look_dir, push, shoot):
    """(B, K) fired mask. px, pz: (B,); moved, look_dir: (B, 3);
    push, shoot: (B,) bool."""
    wx, wz = -moved[:, 0:1], -moved[:, 2:3]
    wlen = torch.sqrt(wx * wx + wz * wz)
    some_walk = wlen >= 1e-16
    wdx = torch.where(some_walk, wx / torch.where(some_walk, wlen, 1.0), 0.0)
    wdz = torch.where(some_walk, wz / torch.where(some_walk, wlen, 1.0), 0.0)

    lx, lz = look_dir[:, 0:1], look_dir[:, 2:3]
    lmag = torch.sqrt(lx * lx + lz * lz)
    ok_look = lmag >= 1e-16
    lxn = torch.where(ok_look, lx / torch.where(ok_look, lmag, 1.0), 0.0)
    lzn = torch.where(ok_look, lz / torch.where(ok_look, lmag, 1.0), 0.0)
    push = push[:, None]
    shoot = shoot[:, None]
    arange = torch.where(push, PUSH_RANGE, SHOOT_RANGE)

    ox, oz = px[:, None], pz[:, None]
    walked_hit = _segment_intersect(
        ox, oz, wdx, wdz, wlen,
        scene.trig_origin, scene.trig_displace, scene.trig_length,
    )
    aim_hit = _segment_intersect(
        ox, oz, lxn, lzn, arange,
        scene.trig_origin, scene.trig_displace, scene.trig_length,
    ) & (push | shoot)

    ttype = scene.trig_type[None, :]
    return torch.where(
        ttype == T_WALKOVER,
        walked_hit,
        torch.where(
            (ttype == T_PUSH) | (ttype == T_SWITCH),
            aim_hit & push,
            torch.where(
                ttype == T_GUN,
                aim_hit & shoot,
                walked_hit | (aim_hit & push),
            ),
        ),
    )


def apply_fired(scene, fired, trig_alive, exit_triggered, eff_state):
    """Consume the (B, K) fired mask: insert move effects (last fired def
    per object wins), kill only_once triggers, raise the exit flag.
    eff_state is a dict of (B, O) tensors."""
    fired = fired & trig_alive
    D = scene.eff_trigger.shape[0]
    O = eff_state["eff_active"].shape[1]
    dev = fired.device
    if D > 0:
        def_fired = fired[:, scene.eff_trigger]  # (B, D)
        score = torch.where(
            def_fired, torch.arange(1, D + 1, dtype=torch.int32, device=dev), 0
        )
        onehot = scene.eff_object[None, :] == torch.arange(
            O, dtype=torch.int32, device=dev
        )[:, None]  # (O, D)
        best = torch.where(onehot[None], score[:, None, :], 0).amax(dim=2)
        has = best > 0
        idx = torch.clamp_min(best - 1, 0).long()
        eff_state = dict(
            eff_active=torch.where(has, True, eff_state["eff_active"]),
            eff_first=torch.where(
                has, scene.eff_first_offset[idx], eff_state["eff_first"]),
            eff_second=torch.where(
                has, scene.eff_second_offset[idx], eff_state["eff_second"]),
            eff_has_second=torch.where(
                has, scene.eff_has_second[idx], eff_state["eff_has_second"]),
            eff_wait=torch.where(has, scene.eff_wait[idx], eff_state["eff_wait"]),
            eff_speed=torch.where(
                has, scene.eff_speed[idx], eff_state["eff_speed"]),
        )

    trig_alive = trig_alive & ~(fired & scene.trig_only_once[None, :])
    if fired.shape[1] > 0:
        exit_code = torch.where(
            fired, scene.trig_exit[None, :], EXIT_NONE
        ).amax(dim=1).to(exit_triggered.dtype)
        exit_triggered = torch.maximum(exit_triggered, exit_code)
    return trig_alive, exit_triggered, eff_state
