"""chip_smoke.py's byte counts for the bounds of B2 and B8, against a
count made pixel by pixel on the CPU.

The bound of a kernel whose reads depend on the data counts what these
inputs need: `portal_bytes` (B2, both table modes) and `shade_bytes`
(B8) count it with whole-tensor operations from the plain version's
walk, each table read (texel, hole byte, colormap entry; B2's sky texel)
as the distinct 32-byte sector that holds it, the unit DRAM moves. Here the winners come
another way (the first prefix of the records that covers a pixel) and
each env, column and pixel is counted in a Python loop. Tolerance: exact
(integers).

B4's bound reads the sectors of the rows it selects
(`row_sector_bytes`), B5's each source block once
(`block_source_bytes`), each held to a count made row by row and block
by block.

B3's and B9's bounds count one coverage test per covering (pixel,
triangle) pair (`peel_pairs`), held to a count made triangle by triangle.

B1's bound counts the sweeps its inputs need (`player_move_sweeps`):
each env's clip substeps stop at the first that is not blocked, which
leaves the plain version's output unchanged (held bitwise here), and the
count is held to one made env by env.
"""

import importlib.util
import os

import pytest
import torch

from tpu_doom_torch._numerics import f32
from tpu_doom_torch.models import DoomSim
from tpu_doom_torch.ops.raster import (
    MASKED_FAMILY,
    RECORDS_PER_CROSSING,
    _classify,
    _ndc_rows,
    _shade_address,
    classify_alpha_ref,
)
from tpu_doom_torch.render.portal import fused_inputs, oracle_inputs
from tpu_doom_torch.utils.config import GameConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 24, 16
GRATE_POS = [-3.5, 1.0, -9.0]  # a view of :test:'s masked grate


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state(wad, **extra):
    sim = DoomSim(GameConfig(wad_file=wad, width=W, height=H, batch_size=2,
                             raster_backend="portal", **extra), "cpu")
    s = sim.reset()._replace(yaw=torch.tensor([0.0, 2.0]))
    if wad == ":test:":
        pos = s.pos.clone()
        pos[0] = torch.tensor(GRATE_POS)
        s = s._replace(pos=pos)
    return sim, s


SECTOR = 32  # bytes DRAM moves at once


def _table_entry(tex, hole_bytes, b, lin):
    """(texel's 32-byte sector, texel 0..255, hole byte's sector or None,
    is hole)."""
    if tex.dim() == 3:
        v = int(tex[b].reshape(-1)[lin])
        offset = (b * tex[b].numel() + lin) * tex.element_size()
        return offset // SECTOR, min(v, 255), None, v == 256
    v1 = int(tex.reshape(-1)[lin]) + 128
    if hole_bytes is None:
        return lin // SECTOR, v1, None, False
    hbyte = int(hole_bytes.reshape(-1)[lin >> 3]) + 128
    return lin // SECTOR, v1, (lin >> 3) // SECTOR, (hbyte >> (lin & 7)) & 1 == 1


def _portal_bytes_by_pixel(args, kw):
    (records, words, cam, hc, dxz, sky_x, sky_y, sky_tex, tex, hole_bytes, _, height,
     p11, n_rows) = args
    shear = kw["shear"]
    B, R, _, width = records.shape
    y, ndc0 = _ndc_rows(height, "cpu")
    ndc_y = ndc0 + shear[:, None, None]
    cam_y = cam[:, 1, None, None]
    covering = records.clone()
    covering[:, :, 2] = 1.0  # any covered pixel classifies to kind 1
    win = torch.full((B, height, width), -1)
    for r in range(R - 1, -1, -1):
        prefix = _classify(covering[:, :r + 1], words, cam_y, hc, ndc_y, y, f32(p11), False)
        win[prefix[:, 0] == 1.0] = r
    ch = _classify(records, words, cam_y, hc, ndc_y, y, f32(p11), False)
    lin, crow, _, _ = _shade_address(
        ch, ndc_y, dxz[:, 0, None, :], dxz[:, 1, None, :], cam[:, 0, None, None], cam_y,
        cam[:, 2, None, None], f32(p11), n_rows, tex.shape[-2])
    # The u8 and bool frames: 2 bytes a pixel.
    total = 2 * B * height * width + 4 * (cam.numel() + shear.numel())
    texels, holes, cmap, skies = set(), set(), set(), set()
    sky_rows = set()  # (env, row) with a sky pixel: its sky_y entry
    for b in range(B):
        for c in range(width):
            w = win[b, :, c].tolist()
            last = R - 1 if min(w) < 0 else max(w)
            total += 8 * (last + 1)
            for r in range(MASKED_FAMILY, last + 1, RECORDS_PER_CROSSING):
                y0, y1 = float(records[b, r, 0, c]), float(records[b, r, 1, c])
                if any(y0 <= h + 0.5 < y1 and (w[h] < 0 or w[h] >= r) for h in range(height)):
                    total += 4
                    if float(records[b, r, 13, c]) > 0.5:
                        total += 8 + (0 if r in w else 24)
            for r in {x for x in w if x >= 0}:
                kind = float(records[b, r, 2, c])
                total += 4 * (11 if kind in (2.0, 4.0) else 1 if kind in (0.0, 3.0) else 6)
            flat_column = sky_column = False
            for h in range(height):
                kind = float(ch[b, 0, h, c])
                if kind == 3.0:  # the sky texel's sector, its row and column
                    sky_column = True
                    sky_rows.add((b, h))
                    skies.add((int(sky_y[b, h]) * sky_tex.shape[1] + int(sky_x[b, c]))
                              // SECTOR)
                if kind in (0.0, 3.0):
                    continue
                flat_column |= kind not in (2.0, 4.0)
                key, v1, hbyte, hole = _table_entry(tex, hole_bytes, b, int(lin[b, h, c]))
                texels.add(key)
                if hbyte is not None:
                    holes.add(hbyte)
                if not hole:
                    cmap.add((int(crow[b, h, c]) * 256 + v1) // SECTOR)
            total += 8 * flat_column + 4 * sky_column
    return total + 4 * len(sky_rows) + SECTOR * (len(texels) + len(holes) + len(cmap)
                                                 + len(skies))


@pytest.mark.parametrize("wad, extra, per_env", [
    (":test:", {}, False),
    (":texstress:10x16", {}, False),
    (":texstress:10x16", dict(portal_global_segs_max=1024), True),
])
def test_portal_bytes_counts_each_column(wad, extra, per_env):
    """B2's bound bytes equal the count made column by column, in both
    table modes, with masked records flagged on :test: (env 0 at the
    grate); the count lies between the outputs and every input once."""
    cs = _chip_smoke()
    sim, s = _state(wad, **extra)
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, W, H, s)
    assert (args[8].dim() == 3) == per_env
    if wad == ":test:":
        assert bool((args[0][:, MASKED_FAMILY::RECORDS_PER_CROSSING, 13] > 0.5).any())
    got = cs.portal_bytes(args, kw)
    assert got == _portal_bytes_by_pixel(args, kw)
    whole = cs.nbytes(*[a for a in args if isinstance(a, torch.Tensor)], kw["shear"])
    assert 2 * 2 * W * H < got < whole + 2 * 2 * W * H  # the frames: u8 + bool


def test_shade_bytes_counts_each_pixel():
    """B8's bound bytes equal the count made pixel by pixel on the
    `portal_jnp` configuration's inputs."""
    cs = _chip_smoke()
    sim, s = _state(":test:")
    cargs, sargs, shear, _ = oracle_inputs(sim.portal_scene(), sim.scene, sim.config,
                                           W, H, s)
    ch = classify_alpha_ref(*cargs, shear=shear).reshape(2, 11, -1)
    dxz, ndc_y, _, cam, tex, hole_bytes, _, p11, n_rows = sargs
    lin, crow, _, _ = _shade_address(
        ch, ndc_y + shear[:, None], dxz[:, 0], dxz[:, 1], cam[:, 0, None], cam[:, 1, None],
        cam[:, 2, None], f32(p11), n_rows, tex.shape[0])
    B, _, P = ch.shape
    total = 12 * B * P + 4 * (ndc_y.numel() + cam.numel() + shear.numel())
    texels, holes, cmap = set(), set(), set()
    for b in range(B):
        for p in range(P):
            kind = float(ch[b, 0, p])
            total += 4 * (kind == 3.0)
            if kind in (0.0, 3.0):
                continue
            total += 40 if kind in (2.0, 4.0) else 28
            key, v1, hbyte, hole = _table_entry(tex, hole_bytes, b, int(lin[b, p]))
            texels.add(key)
            holes.add(hbyte)
            if not hole:
                cmap.add((int(crow[b, p]) * 256 + v1) // SECTOR)
    want = total + SECTOR * (len(texels) + len(holes) + len(cmap))
    assert cs.shade_bytes(ch, sargs, shear) == want


@pytest.mark.parametrize("C", [74, 8, 3])
def test_row_sector_bytes_counts_each_row(C):
    """B4's table reads: the 32-byte sectors that hold the selected rows
    (indices clamped to [0, S), as B4 clamps), each once, against a count
    made row by row; rows of 296, 32 and 12 bytes, so rows share sectors
    or fill them exactly."""
    import numpy as np

    cs = _chip_smoke()
    B, S, N = 3, 40, 50
    idx = torch.as_tensor(np.random.default_rng(C).integers(-2, S + 2, (B, N)),
                          dtype=torch.int32)
    sectors = set()
    for b in range(B):
        for r in {min(max(int(i), 0), S - 1) for i in idx[b]}:
            start = (b * S + r) * C * 4
            sectors.update(range(start // SECTOR, (start + C * 4 - 1) // SECTOR + 1))
    got = cs.row_sector_bytes(idx, torch.zeros((B, S, C)))
    assert got == SECTOR * len(sectors) < B * S * C * 4 + SECTOR


def test_block_source_bytes_counts_each_block():
    """B5's table reads: each 8-row source block that some env copies,
    once, against a count made block by block; blocks past the table
    (and counts of 0) read nothing."""
    import numpy as np

    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    S, B, C = 80, 4, 6
    meta = np.stack([rng.integers(-1, S // 8 + 2, (B, C)), rng.integers(0, 9, (B, C)),
                     rng.integers(0, 4, (B, C))], axis=-1).astype(np.int32)
    blocks = {g + i for g, _, n in meta.reshape(-1, 3) for i in range(n)
              if 0 <= g + i < S // 8}
    got = cs.block_source_bytes(torch.as_tensor(meta), torch.zeros((S, 128), dtype=torch.int16))
    assert got == len(blocks) * 8 * 128 * 2
    assert 0 < len(blocks) < int(meta[..., 2].sum())  # envs share blocks


# ---------------------------------------------------------------------------
# B1's early exit and the sweeps its bound counts.
# ---------------------------------------------------------------------------

MOVE_KW = dict(radius=0.19, height=0.21, dt=1.0 / 60.0)
# (pos, vel) on :test: driven into walls at speed: the clip substeps stay
# blocked for 2, 2, 3, 3, 4 and 4 substeps before the first that is not.
WALL_POSES = [
    ([-5.322443, 0.517154, -2.971954], [29.607201, -0.396883, -16.145632]),
    ([-4.924472, 0.579896, -4.392363], [-37.535091, 3.734373, -29.851299]),
    ([-2.598571, 0.782959, -6.101626], [31.295546, 1.346841, -18.249713]),
    ([-4.506347, 0.242570, -9.900106], [-13.988363, -4.495687, 27.924831]),
    ([-3.197642, 0.270342, -6.258263], [-21.719618, 1.646252, 31.182529]),
    ([-4.589288, 0.524732, -9.854610], [1.065998, -4.526350, -22.857860]),
]


def _move_inputs():
    """B1's rows and state8 on :test: for the 16 poses of
    test_torch_sim.py's test_player_move_ref_matches_jax_move_core
    (default_rng(0)), then the WALL_POSES."""
    import numpy as np

    from tpu_doom_torch.sim.collision import broadphase_rows

    sim = DoomSim(GameConfig(wad_file=":test:", raster_backend="portal"), "cpu")
    rng = np.random.default_rng(0)
    s = sim.reset(16)
    jitter = rng.uniform(-0.5, 0.5, (16, 3)) * np.array([1.0, 0.3, 1.0])
    pos = (s.pos.numpy() + jitter).astype(np.float32)
    pos[8:] += np.array([0.3, -0.2, -6.0], np.float32)  # door corridor
    vel = rng.uniform(-3.0, 3.0, (16, 3)).astype(np.float32)
    pos = np.concatenate([pos, np.array([p for p, _ in WALL_POSES], np.float32)])
    vel = np.concatenate([vel, np.array([v for _, v in WALL_POSES], np.float32)])
    pos, vel = torch.as_tensor(pos), torch.as_tensor(vel)
    offsets = torch.zeros((pos.shape[0], s.object_offset.shape[1]))
    rows = broadphase_rows(sim.scene, offsets, pos)
    return rows, torch.cat([pos, vel, torch.zeros((pos.shape[0], 2))], 1)


def test_player_move_early_exit_leaves_the_output():
    """The invariant B1's early exit rests on: per env, player_move_ref
    with 4 substeps equals it with the substeps cut to that env's first
    substep that is not blocked (bitwise), on the 16 poses and on poses
    driven into walls, which stay blocked for 2-4 substeps."""
    from tpu_doom_torch.ops.collision import player_move_ref

    rows, st8 = _move_inputs()
    runs = _chip_smoke().clip_substeps_run(rows, st8, MOVE_KW["radius"], MOVE_KW["dt"], 4)
    assert runs[:16].tolist() == [1] * 16
    assert runs[16:].tolist() == [2, 2, 3, 3, 4, 4]
    full = player_move_ref(rows, st8, substeps=4, **MOVE_KW)
    for k in (1, 2, 3):
        cut = player_move_ref(rows, st8, substeps=k, **MOVE_KW)
        done = runs <= k
        assert torch.equal(cut[done].view(torch.int32), full[done].view(torch.int32)), k
        # An env still blocked after k substeps moves on in the next.
        assert not bool((cut[~done, 4:10] == full[~done, 4:10]).all(1).any()), k


def _substeps_run_env(rows, st8, substeps, radius, dt):
    """One env's clip substeps, counted in a loop that stops at the first
    substep that is not blocked, as the kernel does."""
    from tpu_doom_torch._numerics import f32, rdiv
    from tpu_doom_torch.ops.collision import INF, _sweep

    comp = tuple(rows[None, i] for i in range(12))
    mask = rows[None, 12] > 0.5
    p = [st8[None, k:k + 1] for k in range(3)]
    v = [st8[None, k:k + 1] for k in range(3, 6)]
    time_left = torch.zeros((1, 1)) + f32(dt)
    for s in range(substeps):
        d = [x * time_left for x in v]
        ct, nx, ny, nz = _sweep(comp, mask, *p, *d, f32(radius))
        dmag = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        adjusted = ct - rdiv(0.001, torch.where(dmag > 0.0, dmag, 1.0))
        if not bool((ct < INF) & (adjusted < 1.0)):
            return s + 1
        p = [x + dx * adjusted for x, dx in zip(p, d)]
        ndv = nx * v[0] + ny * v[1] + nz * v[2]
        v = [x - n * ndv for x, n in zip(v, (nx, ny, nz))]
        time_left = time_left * (1.0 - torch.clamp(ct, 0.0, 1.0))
    return substeps


@pytest.mark.parametrize("enable_noclip", [True, False])
def test_player_move_sweeps_counts_each_env(enable_noclip):
    """B1's bound counts per env the ground probe, the noclip probe when
    it is on, and the clip substeps through the first that is not
    blocked: equal to a count made env by env. Tolerance: exact."""
    cs = _chip_smoke()
    rows, st8 = _move_inputs()
    runs = [_substeps_run_env(rows[b], st8[b], 4, MOVE_KW["radius"], MOVE_KW["dt"])
            for b in range(rows.shape[0])]
    radius, dt = MOVE_KW["radius"], MOVE_KW["dt"]
    assert cs.clip_substeps_run(rows, st8, radius, dt, 4).tolist() == runs
    want = sum(runs) + len(runs) * (2 if enable_noclip else 1)
    assert cs.player_move_sweeps(rows, st8, radius, dt, 4, enable_noclip) == want


# ---------------------------------------------------------------------------
# B3's and B9's bound: one coverage test per covering (pixel, triangle) pair.
# ---------------------------------------------------------------------------


def _pairs_by_triangle(rows, grid, ybounds=None, tile_p=None, chunk_t=None):
    """The covering pairs counted env by env and triangle by triangle, in
    numpy float32 one rounding at a time, with B3's window-y cull checked
    per chunk of chunk_t rows against each pixel's run of tile_p pixels."""
    import numpy as np

    px, py = grid[0].numpy(), grid[1].numpy()
    P = px.size
    runs = np.concatenate([py, np.zeros(-P % tile_p if tile_p else 0, np.float32)])
    if tile_p:
        runs = runs.reshape(-1, tile_p)
        y_lo = np.repeat(runs.min(1) - 1.0, tile_p)[:P]
        y_hi = np.repeat(runs.max(1) + 1.0, tile_p)[:P]
    n = 0
    for b in range(rows.shape[0]):
        for t in range(rows.shape[1]):
            s = rows[b, t].numpy()
            lam0, lam1, lam2, z, slam = (s[i] * px + s[i + 1] * py + s[i + 2]
                                         for i in (0, 3, 6, 9, 12))
            cov = ((s[15] > 0.0) & (lam0 >= 0.0) & (lam1 >= 0.0) & (lam2 >= 0.0)
                   & (slam > 0.0) & (z >= -1.0) & (z <= 1.0))
            if ybounds is not None:
                chunk = ybounds[b, t // chunk_t * chunk_t:][:chunk_t].numpy()
                cov &= (chunk[:, 0].min() <= y_hi) & (chunk[:, 1].max() >= y_lo)
            n += int(cov.sum())
    return n


@pytest.mark.parametrize("wad", [":test:", ":texstress:10x16"])
def test_peel_pairs_counts_each_env(wad):
    """B3's and B9's bound count one coverage test per covering (pixel,
    triangle) pair, whatever the number of layers: `peel_pairs` equals the
    count made env by env and triangle by triangle, on B9's rows and on
    B3's y-sorted rows with its window-y cull (chunks of 16 rows, runs of
    64 pixels), which on a level's own rows drops no covering pair.
    Tolerance: exact."""
    from tpu_doom_torch.ops import pack_triangle_rows
    from tpu_doom_torch.render import raster as R

    cs = _chip_smoke()
    sim = DoomSim(GameConfig(wad_file=wad, width=W, height=H, batch_size=2,
                             raster_backend="auto"), "cpu")
    s = sim.reset()._replace(yaw=torch.tensor([0.9, 2.2]), pitch=torch.tensor([0.3, -0.35]))
    rows, _, grid, yb, _ = R.peel_inputs(sim.scene, sim.config, W, H, s)
    prep = R.prepare(sim.scene, sim.config, W, H, s)
    rows16 = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    n = cs.peel_pairs(rows16, grid)
    assert n == _pairs_by_triangle(rows16, grid)
    assert 0 < n < rows16.shape[0] * rows16.shape[1] * grid.shape[1]
    assert cs.peel_pairs(rows, grid, yb, tile_p=64, chunk_t=16) == n
    assert _pairs_by_triangle(rows, grid, yb, tile_p=64, chunk_t=16) == n
    # Every other chunk's bounds moved above the image: the cull then
    # drops its covering pairs.
    bad = yb.clone()
    bad[:, (torch.arange(yb.shape[1]) // 16) % 2 == 1] = torch.tensor([H + 10.0, H + 11.0])
    cut = cs.peel_pairs(rows, grid, bad, tile_p=64, chunk_t=16)
    assert cut == _pairs_by_triangle(rows, grid, bad, tile_p=64, chunk_t=16) and cut < n
