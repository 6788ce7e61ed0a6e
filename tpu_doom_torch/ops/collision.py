"""Kernel B1: one tick's swept-sphere sequence per env.

Replaces `tpu_doom/ops/collision_pallas.py:player_move_pallas` (kernel
`_move_kernel`, math `_move_core` and `_sweep_tile`). Per env: a ground
probe (feet radius 0.2, -height), `substeps` clip-move substeps with
velocity projection, and the noclip probe (2000-unit drop), each a swept
sphere against the env's M broad-phase triangles; nearest hit, lower
triangle index on ties (as `jnp.argmin`).

CUDA design (csrc/player_move.cu): one warp per env; each lane sweeps
triangles lane, lane+32, ...; the nearest hit is a warp-shuffle min over
(dist, index). The sweeps run in order inside the warp. On this card the
kernel is latency bound: ~6 dependent sweeps of M = 102 triangles per
env on `:test:`, a few KB of rows per env.

`player_move_ref` is the plain PyTorch version, op for op the same
arithmetic; `player_move` takes it for CPU tensors and launches the
kernel for CUDA tensors.

Rows (B, 13, M): [0:3) v0 | [3:6) v1 | [6:9) v2 | [9:12) normal | [12] mask.
State (B, 8): [px py pz vx vy vz 0 0].
Output (B, 16): [0] ground t | [1:4) ground normal | [4:7) clip pos |
[7:10) clip vel | [10] noclip probe t | [11:16) zero.
"""

from __future__ import annotations

import torch

from .._build import check, load
from .._numerics import f32, rdiv

BIG = 1e4
INF = float("inf")
FEET_RADIUS = 0.2  # ref player.rs:254-256
NOCLIP_PROBE_H = 2000.0  # ref player.rs:171


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _sweep(rows, mask, cx, cy, cz, dx, dy, dz, radius):
    """Swept sphere vs the (B, M) triangle components; centre and
    displacement are (B, 1). Returns (time, nx, ny, nz), each (B, 1)."""
    (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z, nx, ny, nz) = rows
    speed = torch.sqrt(dx * dx + dy * dy + dz * dz)
    moving = speed > 0.0
    sp_safe = torch.where(moving, speed, 1.0)
    nvx, nvy, nvz = dx / sp_safe, dy / sp_safe, dz / sp_safe

    ndv = _dot(nx, ny, nz, nvx, nvy, nvz)
    facing = ndv < 0.0
    intercept = -_dot(v0x, v0y, v0z, nx, ny, nz)
    spd = _dot(cx, cy, cz, nx, ny, nz) + intercept
    not_behind = spd >= -radius

    min_dist = torch.full(mask.shape, BIG, dtype=torch.float32, device=mask.device)
    bnx = torch.zeros_like(min_dist)
    bny = torch.zeros_like(min_dist)
    bnz = torch.zeros_like(min_dist)

    # Plane face test (sphere.rs:45-53) with point-in-triangle.
    safe_ndv = torch.where(ndv == 0.0, -1.0, ndv)
    dist = -(spd - radius) / safe_ndv
    opx, opy, opz = cx + nvx * dist, cy + nvy * dist, cz + nvz * dist
    ux, uy, uz = v1x - v0x, v1y - v0y, v1z - v0z
    vx_, vy_, vz_ = v2x - v0x, v2y - v0y, v2z - v0z
    cnx = uy * vz_ - uz * vy_
    cny = uz * vx_ - ux * vz_
    cnz = ux * vy_ - uy * vx_
    wx, wy, wz = opx - v0x, opy - v0y, opz - v0z
    n2 = _dot(cnx, cny, cnz, cnx, cny, cnz)
    n2_safe = torch.where(n2 == 0.0, 1.0, n2)
    uwx = uy * wz - uz * wy
    uwy = uz * wx - ux * wz
    uwz = ux * wy - uy * wx
    gamma = _dot(uwx, uwy, uwz, cnx, cny, cnz) / n2_safe
    wvx = wy * vz_ - wz * vy_
    wvy = wz * vx_ - wx * vz_
    wvz = wx * vy_ - wy * vx_
    beta = _dot(wvx, wvy, wvz, cnx, cny, cnz) / n2_safe
    alpha = 1.0 - gamma - beta
    inside = (
        (n2 > 0.0)
        & (alpha >= 0.0) & (alpha <= 1.0)
        & (beta >= 0.0) & (beta <= 1.0)
        & (gamma >= 0.0) & (gamma <= 1.0)
    )
    plane_ok = (spd >= radius) & inside
    min_dist = torch.where(plane_ok, dist, min_dist)
    bnx = torch.where(plane_ok, nx, bnx)
    bny = torch.where(plane_ok, ny, bny)
    bnz = torch.where(plane_ok, nz, bnz)

    # Vertex tests (sphere.rs:55-64).
    cc = _dot(cx, cy, cz, cx, cy, cz)
    rr = radius * radius
    for px, py, pz in ((v0x, v0y, v0z), (v1x, v1y, v1z), (v2x, v2y, v2z)):
        b = 2.0 * _dot(-nvx, -nvy, -nvz, px - cx, py - cy, pz - cz)
        c = cc + _dot(px, py, pz, px, py, pz) - 2.0 * _dot(px, py, pz, cx, cy, cz) - rr
        disc = b * b - 4.0 * c
        okroot = disc >= 0.0
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        r1 = (-b + sq) / 2.0
        r2 = (-b - sq) / 2.0
        d = torch.where(okroot, torch.minimum(r1, r2), INF)
        ok = (d >= 0.0) & (d < min_dist)
        min_dist = torch.where(ok, d, min_dist)
        bnx = torch.where(ok, cx - (px - nvx * d), bnx)
        bny = torch.where(ok, cy - (py - nvy * d), bny)
        bnz = torch.where(ok, cz - (pz - nvz * d), bnz)

    # Edge tests (sphere.rs:67-119).
    for (e1x, e1y, e1z), (e2x, e2y, e2z) in (
        ((v0x, v0y, v0z), (v1x, v1y, v1z)),
        ((v1x, v1y, v1z), (v2x, v2y, v2z)),
        ((v2x, v2y, v2z), (v0x, v0y, v0z)),
    ):
        edx, edy, edz = e2x - e1x, e2y - e1y, e2z - e1z
        enx = nvy * edz - nvz * edy
        eny = nvz * edx - nvx * edz
        enz = nvx * edy - nvy * edx
        en_mag = torch.sqrt(_dot(enx, eny, enz, enx, eny, enz))
        en_ok = en_mag >= 1e-16
        en_div = torch.clamp_min(en_mag, 1e-30)
        enx = torch.where(en_ok, enx / en_div, 0.0)
        eny = torch.where(en_ok, eny / en_div, 0.0)
        enz = torch.where(en_ok, enz / en_div, 0.0)
        edge_intercept = -_dot(e1x, e1y, e1z, enx, eny, enz)
        edge_distance = _dot(cx, cy, cz, enx, eny, enz) + edge_intercept
        near_plane = torch.abs(edge_distance) <= radius
        circle_r = torch.sqrt(torch.clamp_min(rr - edge_distance * edge_distance, 0.0))
        ccx = cx - enx * edge_distance
        ccy = cy - eny * edge_distance
        ccz = cz - enz * edge_distance
        ecx, ecy, ecz = ccx - e1x, ccy - e1y, ccz - e1z
        edge_m2 = torch.clamp_min(_dot(edx, edy, edz, edx, edy, edz), 1e-30)
        fr = _dot(ecx, ecy, ecz, edx, edy, edz) / edge_m2
        olx, oly, olz = e1x + edx * fr, e1y + edy * fr, e1z + edz * fr
        dirx, diry, dirz = olx - ccx, oly - ccy, olz - ccz
        dmag = torch.sqrt(_dot(dirx, diry, dirz, dirx, diry, dirz))
        d_ok = dmag >= 1e-16
        d_div = torch.clamp_min(dmag, 1e-30)
        dirx = torch.where(d_ok, dirx / d_div, 0.0)
        diry = torch.where(d_ok, diry / d_div, 0.0)
        dirz = torch.where(d_ok, dirz / d_div, 0.0)
        cax = ccx + dirx * circle_r
        cay = ccy + diry * circle_r
        caz = ccz + dirz * circle_r

        a0, a1, a2 = torch.abs(enx), torch.abs(eny), torch.abs(enz)
        use12 = (a0 > a1) & (a0 > a2)
        use02 = ~use12 & (a1 > a2)
        use_z = use12 | use02

        def pick(x, y, z):
            return torch.where(use12, y, x), torch.where(use_z, z, y)

        p1x_, p1y_ = pick(cax, cay, caz)
        p2x_, p2y_ = pick(cax + nvx, cay + nvy, caz + nvz)
        q1x_, q1y_ = pick(e1x, e1y, e1z)
        q2x_, q2y_ = pick(e2x, e2y, e2z)
        d1x, d1y = p2x_ - p1x_, p2y_ - p1y_
        d2x, d2y = q1x_ - q2x_, q1y_ - q2y_
        denom = d2y * d1x - d2x * d1y
        nonpar = denom != 0.0
        tt = (d2x * (p1y_ - q1y_) - d2y * (p1x_ - q1x_)) / torch.where(
            nonpar, denom, 1.0)
        inx, iny, inz = cax + nvx * tt, cay + nvy * tt, caz + nvz * tt
        between = _dot(e1x - inx, e1y - iny, e1z - inz,
                       e2x - inx, e2y - iny, e2z - inz) <= 0.0
        ok = near_plane & nonpar & (tt >= 0.0) & (tt < min_dist) & between
        min_dist = torch.where(ok, tt, min_dist)
        bnx = torch.where(ok, cx - cax, bnx)
        bny = torch.where(ok, cy - cay, bny)
        bnz = torch.where(ok, cz - caz, bnz)

    valid = moving & facing & not_behind & (min_dist < BIG) & mask
    dist_or_inf = torch.where(valid, min_dist, INF)
    # First-index min (the argmin tie rule): torch.min returns the first
    # index of the minimum.
    m, bi = torch.min(dist_or_inf, dim=1, keepdim=True)
    # + 0.0: the JAX kernel sums the selected lane with zeros, which
    # turns a selected -0.0 into +0.0.
    onx = torch.gather(bnx, 1, bi) + 0.0
    ony = torch.gather(bny, 1, bi) + 0.0
    onz = torch.gather(bnz, 1, bi) + 0.0
    time = m / sp_safe
    nmag = torch.sqrt(onx * onx + ony * ony + onz * onz)
    n_ok = nmag >= 1e-16
    n_div = torch.clamp_min(nmag, 1e-30)
    return (time, torch.where(n_ok, onx / n_div, 0.0),
            torch.where(n_ok, ony / n_div, 0.0),
            torch.where(n_ok, onz / n_div, 0.0))


def player_move_ref(rows, state8, radius: float, height: float, dt: float,
                    substeps: int, enable_noclip: bool = True):
    """Plain PyTorch version of kernel B1 -> (B, 16) f32."""
    comp = tuple(rows[:, i] for i in range(12))
    mask = rows[:, 12] > 0.5
    radius, height, dt = f32(radius), f32(height), f32(dt)
    z1 = torch.zeros_like(state8[:, 0:1])
    px, py, pz = state8[:, 0:1], state8[:, 1:2], state8[:, 2:3]
    vx, vy, vz = state8[:, 3:4], state8[:, 4:5], state8[:, 5:6]

    gt, gnx, gny, gnz = _sweep(comp, mask, px, py, pz, z1, z1 - height, z1,
                               f32(FEET_RADIUS))

    cpx, cpy, cpz = px, py, pz
    cvx, cvy, cvz = vx, vy, vz
    time_left = z1 + dt
    done = z1 > 1.0
    for _ in range(substeps):
        dx, dy, dz = cvx * time_left, cvy * time_left, cvz * time_left
        ct, cnx, cny, cnz = _sweep(comp, mask, cpx, cpy, cpz, dx, dy, dz, radius)
        dmag = torch.sqrt(dx * dx + dy * dy + dz * dz)
        adjusted = ct - rdiv(0.001, torch.where(dmag > 0.0, dmag, 1.0))
        hit = ct < INF
        blocked = hit & (adjusted < 1.0) & ~done
        tcl = torch.clamp(ct, 0.0, 1.0)
        adv = torch.where(blocked, adjusted, 1.0)
        cpx = torch.where(done, cpx, cpx + dx * adv)
        cpy = torch.where(done, cpy, cpy + dy * adv)
        cpz = torch.where(done, cpz, cpz + dz * adv)
        ndv = cnx * cvx + cny * cvy + cnz * cvz
        cvx = torch.where(blocked, cvx - cnx * ndv, cvx)
        cvy = torch.where(blocked, cvy - cny * ndv, cvy)
        cvz = torch.where(blocked, cvz - cnz * ndv, cvz)
        time_left = torch.where(blocked, time_left * (1.0 - tcl), time_left)
        done = done | ~blocked

    if enable_noclip:
        ph = f32(NOCLIP_PROBE_H)
        nt, _, _, _ = _sweep(
            comp, mask, px + vx * dt, py + vy * dt + ph * 0.5, pz + vz * dt,
            z1, z1 - ph, z1, radius,
        )
    else:
        nt = torch.full_like(z1, INF)
    pad = torch.zeros((z1.shape[0], 5), dtype=torch.float32, device=z1.device)
    return torch.cat(
        [gt, gnx, gny, gnz, cpx, cpy, cpz, cvx, cvy, cvz, nt, pad], dim=1)


def player_move(rows, state8, radius: float, height: float, dt: float,
                substeps: int, enable_noclip: bool = True):
    """Kernel B1 for CUDA tensors, its plain version for CPU tensors."""
    if rows.device.type == "cpu":
        return player_move_ref(rows, state8, radius, height, dt, substeps,
                               enable_noclip)
    if rows.device.type != "cuda":
        raise ValueError(f"player_move: unsupported device {rows.device}")
    B, C, M = rows.shape
    if C != 13 or state8.shape != (B, 8) or M < 1:
        raise ValueError(f"player_move: bad shapes {rows.shape}, {state8.shape}")
    if rows.dtype != torch.float32 or state8.dtype != torch.float32:
        raise ValueError("player_move: rows and state8 must be float32")
    rows = rows.contiguous()
    state8 = state8.contiguous()
    out = torch.empty((B, 16), dtype=torch.float32, device=rows.device)
    lib = load()
    check(lib.tdt_player_move(
        rows.data_ptr(), state8.data_ptr(), out.data_ptr(), B, M,
        f32(radius), f32(height), f32(dt), int(substeps), int(bool(enable_noclip)),
        torch.cuda.current_stream(rows.device).cuda_stream,
    ), "player_move")
    player_move.launches += 1
    return out


player_move.launches = 0
