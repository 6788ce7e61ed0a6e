"""Swept-sphere collision against the level's triangle soup.

Port of `tpu_doom/sim/collision.py`: `Contact`, the broad-phase rows of
the movement kernel B1 (`broadphase_rows`), and the `legacy` oracle that
the JAX package keeps beside the kernel: `sweep_sphere` (the reference's
per-triangle face, vertex and edge tests, ref sphere.rs:16-129, then the
nearest contact over triangles), `offset_triangles` (the brute force over
every triangle) and `broadphase_triangles` (the player's grid cell). JAX
writes these for one env and vmaps them; here every function takes the
env batch as its leading axis: centres and displacements (B, 3),
triangles (B, T, 3). The JAX version selects rows with an exact one-hot
matmul; here it is an indexed load, plus `+ 0.0` where the matmul turns
-0.0 into +0.0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._numerics import f32, to_i32

BIG = 1e4
INF = float("inf")


class Contact(NamedTuple):
    time: torch.Tensor  # (B,) f32; inf when no contact
    normal: torch.Tensor  # (B, 3) f32

    @property
    def hit(self):
        return torch.isfinite(self.time)


def broadphase_rows(scene, object_offset, pos):
    """(B, 13, M) rows [v0 | v1 | v2 | normal | mask] of each env's XZ grid
    cell, with the object y-offset folded into the vertex rows.
    object_offset: (B, O); pos: (B, 3)."""
    rel0 = (pos[:, 0] - scene.bp_origin[0]) * scene.bp_inv_cell
    rel1 = (pos[:, 2] - scene.bp_origin[1]) * scene.bp_inv_cell
    dims = scene.bp_dims
    cx = torch.minimum(torch.clamp_min(to_i32(torch.floor(rel0)), 0), dims[0] - 1)
    cz = torch.minimum(torch.clamp_min(to_i32(torch.floor(rel1)), 0), dims[1] - 1)
    idx = scene.bp_cells[(cx * dims[1] + cz).long()]  # (B, M)
    mask = idx >= 0
    safe = torch.clamp_min(idx, 0).long()
    dy = torch.gather(object_offset, 1, scene.coll_object.long()[None, :].expand(
        object_offset.shape[0], -1)).gather(1, safe)  # (B, M)
    v0, v1, v2 = scene.coll_v0[safe], scene.coll_v1[safe], scene.coll_v2[safe]
    n = scene.coll_normal[safe]  # (B, M, 3)
    return torch.stack(
        [
            v0[..., 0], v0[..., 1] + dy, v0[..., 2],
            v1[..., 0], v1[..., 1] + dy, v1[..., 2],
            v2[..., 0], v2[..., 1] + dy, v2[..., 2],
            n[..., 0], n[..., 1], n[..., 2],
            mask.to(torch.float32),
        ],
        dim=1,
    )


# ---------------------------------------------------------------------------
# The `legacy` oracle (tpu_doom/sim/collision.py:38-262), batched over envs.
# ---------------------------------------------------------------------------


def _dot(a, b):
    """Sum over the last axis of 3, written out left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _lowest_quadratic_root(b, c):
    """Smaller root of x^2 + bx + c, or +inf when no real root (ref
    sphere.rs:142-157; the JAX form's a is 1 at its only call)."""
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    r1 = (-b + sq) / 2.0
    r2 = (-b - sq) / 2.0
    return torch.where(disc >= 0.0, torch.minimum(r1, r2), INF)


def _point_in_triangle(v0, v1, v2, p):
    """Barycentric containment (ref sphere.rs:171-183); all (..., 3)."""
    u = v1 - v0
    v = v2 - v0
    n = _cross(u, v)
    w = p - v0
    n2 = _dot(n, n)
    n2_safe = torch.where(n2 == 0.0, 1.0, n2)
    gamma = _dot(_cross(u, w), n) / n2_safe
    beta = _dot(_cross(w, v), n) / n2_safe
    alpha = 1.0 - gamma - beta
    return ((n2 > 0.0) & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0)
            & (beta <= 1.0) & (gamma >= 0.0) & (gamma <= 1.0))


def _edge_candidate(center, radius, nvel, e1, e2, min_dist, best_normal):
    """One edge test for every triangle (ref sphere.rs:67-119): centre
    and nvel (B, 1, 3), edges (B, T, 3). Returns the updated (min_dist,
    best_normal)."""
    edge = e2 - e1
    en = _cross(nvel.expand_as(edge), edge)
    en_mag = torch.sqrt(_dot(en, en))[..., None]
    en = torch.where(en_mag >= 1e-16, en / torch.clamp_min(en_mag, 1e-30), 0.0)
    edge_intercept = -_dot(e1, en)
    edge_distance = _dot(center, en) + edge_intercept
    near_plane = torch.abs(edge_distance) <= radius

    circle_r = torch.sqrt(torch.clamp_min(
        f32(radius * radius) - edge_distance * edge_distance, 0.0))[..., None]
    circle_c = center - en * edge_distance[..., None]
    e1c = circle_c - e1
    edge_m2 = torch.clamp_min(_dot(edge, edge), 1e-30)
    on_line = e1 + edge * (_dot(e1c, edge) / edge_m2)[..., None]
    dir_ = on_line - circle_c
    dmag = torch.sqrt(_dot(dir_, dir_))[..., None]
    dir_ = torch.where(dmag >= 1e-16, dir_ / torch.clamp_min(dmag, 1e-30), 0.0)
    cand = circle_c + dir_ * circle_r

    # Project onto the two axes other than |edge normal|'s largest
    # (ref sphere.rs:87-100).
    a0, a1, a2 = torch.abs(en[..., 0]), torch.abs(en[..., 1]), torch.abs(en[..., 2])
    use12 = (a0 > a1) & (a0 > a2)
    use_z = use12 | (~use12 & (a1 > a2))

    def pick(v):
        return (torch.where(use12, v[..., 1], v[..., 0]),
                torch.where(use_z, v[..., 2], v[..., 1]))

    p1x, p1y = pick(cand)
    p2x, p2y = pick(cand + nvel)
    e1x, e1y = pick(e1)
    e2x, e2y = pick(e2)
    # intersect_line_line (ref sphere.rs:159-169)
    d1x, d1y = p2x - p1x, p2y - p1y
    d2x, d2y = e1x - e2x, e1y - e2y
    denom = d2y * d1x - d2x * d1y
    nonpar = denom != 0.0
    t = (d2x * (p1y - e1y) - d2y * (p1x - e1x)) / torch.where(nonpar, denom, 1.0)

    inter = cand + nvel * t[..., None]
    between = _dot(e1 - inter, e2 - inter) <= 0.0
    ok = near_plane & nonpar & (t >= 0.0) & (t < min_dist) & between
    return (torch.where(ok, t, min_dist),
            torch.where(ok[..., None], center - cand, best_normal))


def sweep_sphere(center, radius, displacement, v0, v1, v2, normal, tri_mask=None):
    """First contact of each env's swept sphere against its triangles:
    centre and displacement (B, 3), vertices and normals (B, T, 3),
    `tri_mask` (B, T) (False rows never touch). Returns Contact(time (B,)
    as a fraction of the displacement, inf for none; unit normal (B, 3)),
    nearest hit, lowest triangle index on ties (as `jnp.argmin`)."""
    radius = f32(radius)
    speed = torch.sqrt(_dot(displacement, displacement))  # (B,)
    moving = speed > 0.0
    sp_safe = torch.where(moving, speed, 1.0)
    nvel = (displacement / sp_safe[:, None])[:, None, :]  # (B, 1, 3)
    center = center[:, None, :]

    ndv = _dot(normal, nvel)  # (B, T)
    facing = ndv < 0.0
    intercept = -_dot(v0, normal)
    spd = _dot(center, normal) + intercept
    not_behind = spd >= -radius

    min_dist = torch.full(spd.shape, BIG, dtype=torch.float32, device=spd.device)
    best_normal = torch.zeros_like(v0)

    # Plane face test (sphere.rs:45-53).
    safe_ndv = torch.where(ndv == 0.0, -1.0, ndv)
    dist = -(spd - radius) / safe_ndv
    on_plane = center + nvel * dist[..., None]
    plane_ok = (spd >= radius) & _point_in_triangle(v0, v1, v2, on_plane)
    min_dist = torch.where(plane_ok, dist, min_dist)
    best_normal = torch.where(plane_ok[..., None], normal, best_normal)

    # Vertex tests (sphere.rs:55-64): the sphere against line (v, v - nvel).
    cc = _dot(center, center)
    rr = f32(radius * radius)
    for vert in (v0, v1, v2):
        b = 2.0 * _dot(-nvel, vert - center)
        c = cc + _dot(vert, vert) - 2.0 * _dot(vert, center) - rr
        d = _lowest_quadratic_root(b, c)
        ok = (d >= 0.0) & (d < min_dist)
        min_dist = torch.where(ok, d, min_dist)
        best_normal = torch.where(ok[..., None], center - (vert - nvel * d[..., None]),
                                  best_normal)

    # Edge tests (sphere.rs:67-119).
    for e1, e2 in ((v0, v1), (v1, v2), (v2, v0)):
        min_dist, best_normal = _edge_candidate(center, radius, nvel, e1, e2,
                                                min_dist, best_normal)

    valid = moving[:, None] & facing & not_behind & (min_dist < BIG)
    if tri_mask is not None:
        valid = valid & tri_mask
    dist_or_inf = torch.where(valid, min_dist, INF)
    m, best = torch.min(dist_or_inf, dim=1)  # the first index of the minimum
    n = torch.gather(best_normal, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    nmag = torch.sqrt(_dot(n, n))[:, None]
    n = torch.where(nmag >= 1e-16, n / torch.clamp_min(nmag, 1e-30), 0.0)
    return Contact(time=m / sp_safe, normal=n)


def _y_shift(dy):
    zero = torch.zeros_like(dy)
    return torch.stack([zero, dy, zero], dim=-1)


def offset_triangles(scene, object_offset):
    """Every collision triangle with its object's y offset, per env:
    object_offset (B, O) -> (v0, v1, v2), each (B, T, 3); normals are
    invariant under translation."""
    shift = _y_shift(object_offset[:, scene.coll_object.long()])  # (B, T, 3)
    return scene.coll_v0 + shift, scene.coll_v1 + shift, scene.coll_v2 + shift


def broadphase_triangles(scene, object_offset, pos):
    """The triangles of each env's XZ grid cell (geom/broadphase.py) with
    their object offsets -> (v0, v1, v2, normal, mask): (B, M, 3) each and
    mask (B, M). object_offset: (B, O); pos: (B, 3)."""
    rel0 = (pos[:, 0] - scene.bp_origin[0]) * scene.bp_inv_cell
    rel1 = (pos[:, 2] - scene.bp_origin[1]) * scene.bp_inv_cell
    dims = scene.bp_dims
    cx = torch.minimum(torch.clamp_min(to_i32(torch.floor(rel0)), 0), dims[0] - 1)
    cz = torch.minimum(torch.clamp_min(to_i32(torch.floor(rel1)), 0), dims[1] - 1)
    idx = scene.bp_cells[(cx * dims[1] + cz).long()]  # (B, M)
    safe = torch.clamp_min(idx, 0).long()
    dy = torch.gather(object_offset[:, scene.coll_object.long()], 1, safe) + 0.0
    shift = _y_shift(dy)
    return (scene.coll_v0[safe] + shift, scene.coll_v1[safe] + shift,
            scene.coll_v2[safe] + shift, scene.coll_normal[safe] + 0.0, idx >= 0)
