"""Collision broad-phase: uniform XZ grid over the level's triangles.

The reference culls collision work with a BSP descent per query
(game/src/world.rs:40-82). A pointer-chasing descent is hostile to
lockstep SPMD, so the TPU build uses the classic broad-phase instead:
a uniform grid over the level's XZ footprint where each cell lists every
triangle whose XZ-projected triangle (expanded by the player's largest
query radius) intersects the cell. At runtime an env gathers its cell's
fixed-width triangle list and sweeps only those.

Cell lists ignore Y entirely (the noclip ground probe sweeps 2000 units
vertically, so vertical culling would be unsound anyway). The expansion
margin covers the head/feet radii plus the largest per-tick displacement;
a per-tick assertion is unnecessary because the sweep itself is still
exact -- a too-small margin could only *miss* contacts for supersonic
velocities, bounded below by construction.
"""

from __future__ import annotations

import numpy as np

# Queries that must be covered by the margin (game units):
#   head/feet radius <= 0.2, per-tick displacement at terminal speeds
#   (~10 u/s / 60) ~ 0.17, plus slack for jump impulses (5 u/s velocity
#   spike -> 0.083/tick) and the biased clip substeps.
DEFAULT_MARGIN = 1.0


def build_grid(v0, v1, v2, cell_size: float = 2.56, margin: float = DEFAULT_MARGIN):
    """Bin triangles into a uniform XZ grid.

    Returns (origin (2,), inv_cell, nx, nz, cells (NC, M) i32 padded with
    -1) where NC = nx*nz and M is the max per-cell count."""
    xs = np.stack([v0[:, 0], v1[:, 0], v2[:, 0]], axis=1)
    zs = np.stack([v0[:, 2], v1[:, 2], v2[:, 2]], axis=1)
    t = len(v0)
    if t == 0:
        return (
            np.zeros(2, np.float32),
            np.float32(1.0 / cell_size),
            1,
            1,
            np.full((1, 1), -1, np.int32),
        )
    xmin, xmax = xs.min() - margin, xs.max() + margin
    zmin, zmax = zs.min() - margin, zs.max() + margin
    nx = max(int(np.ceil((xmax - xmin) / cell_size)), 1)
    nz = max(int(np.ceil((zmax - zmin) / cell_size)), 1)
    origin = np.array([xmin, zmin], dtype=np.float32)

    # Conservative: a triangle joins every cell its expanded XZ bounding
    # box touches.
    tx0 = np.floor((xs.min(axis=1) - margin - xmin) / cell_size).astype(np.int64)
    tx1 = np.floor((xs.max(axis=1) + margin - xmin) / cell_size).astype(np.int64)
    tz0 = np.floor((zs.min(axis=1) - margin - zmin) / cell_size).astype(np.int64)
    tz1 = np.floor((zs.max(axis=1) + margin - zmin) / cell_size).astype(np.int64)
    tx0 = np.clip(tx0, 0, nx - 1)
    tx1 = np.clip(tx1, 0, nx - 1)
    tz0 = np.clip(tz0, 0, nz - 1)
    tz1 = np.clip(tz1, 0, nz - 1)

    lists: list[list[int]] = [[] for _ in range(nx * nz)]
    for i in range(t):
        for cx in range(tx0[i], tx1[i] + 1):
            for cz in range(tz0[i], tz1[i] + 1):
                lists[cx * nz + cz].append(i)
    m = max(max((len(l) for l in lists), default=1), 1)
    cells = np.full((nx * nz, m), -1, dtype=np.int32)
    for c, l in enumerate(lists):
        cells[c, : len(l)] = l
    return origin, np.float32(1.0 / cell_size), nx, nz, cells
