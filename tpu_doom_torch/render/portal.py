"""Portal (column) renderer: the 2.5D fast path.

Port of `tpu_doom/render/portal.py` (see its docstring for the method):
per env, every screen column's ray is crossed with every seg and sprite
billboard, the nearest crossings are walked front to back carrying the
vertical clip window, and each crossing emits up to five window-clipped
span records plus bit-packed alpha words for its masked family. Kernel
B2 (`ops.raster.render_portal_fused`) then classifies and shades every
pixel; under `raster_backend="portal_jnp"` kernel B7 (`classify_alpha`)
classifies and kernel B8 (`shade_portal`) shades, as two stages. Envs
that overflow a budget (live crossings, visible segs, active texels), and
pitched envs under `portal_pitch="triangle"`, render through the exact
triangle path (kernel B3, or B9 under `portal_jnp`) instead.

The JAX walk selects per-crossing attributes with exact one-hot matmuls;
here they are indexed loads. `vmap` becomes the leading env dimension:
per-seg tables are (B, SD, C), crossings (B, K, W).

Big levels (more than 192 walk rows, segs + sprites, at the shipped
defaults) take the big-level walk:
* the visible-seg cull (`portal_visible_segs`, on any level where
  0 < SV < SD): a conservative per-row test keeps at most SV rows per env
  before the crossing math; envs with more visible rows overflow;
* the attribute select through kernel B4 (`ops.raster.select_rows`)
  when crossing compaction is off;
* the active-set texel path when the compact texel table exceeds
  `portal_global_segs_max`: per-seg live counts (kernel B6
  `scatter_live` with the select, a scatter-add otherwise) mark the
  texture cells each env sees, the cells get slots of a
  `portal_active_segs`-row per-env table, kernel B5 (`gather_cells`)
  fills it from the aligned table `tex_full`, and B2 reads it in its
  per-env mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._numerics import cos_sin, div, f32, to_i32
from ..geom.portal import PortalTable
from ..ops.raster import (
    classify_alpha,
    gather_cells,
    render_portal_fused,
    scatter_live,
    select_rows,
    shade_portal,
)
from ..sim.lights import light_table_u8
from .camera import tan_f32
from .raster import ANIM_FPS, anim_atlas_uv, render_frames, sky_x_texel, sky_y_texel

BIG_T = 1e30  # finite depth sentinel for invalid crossings
PITCH_EPS = 1e-5  # |pitch| above this engages the y-shear (or fallback)
SMALL_LEVEL_ROWS = 192  # S+D walk rows the small-level branch covers

# Record channel layout (same as the JAX package).
R_Y0, R_Y1, R_KIND, R_P0 = 0, 1, 2, 3
R_TSX, R_TSY, R_CBASE, R_LIGHT, R_W = 4, 5, 6, 7, 8
R_T1, R_T2, R_LOW, R_HIGH = 9, 10, 11, 12
R_MASKED, R_AX, R_AY = 13, 14, 15
NCH = 16
KIND_NONE, KIND_FLAT, KIND_WALL, KIND_SKY, KIND_DECOR = 0.0, 1.0, 2.0, 3.0, 4.0
RECORDS_PER_CROSSING = 5

# Per-seg attribute table columns, the JAX table's 74
# (portal.py:694-720). PIECE0 + 16 * pi + j is piece pi's column j.
(C_HB, C_FC, C_FF, C_FCS, C_FFS, C_BCS, C_BFS, C_CEILROW, C_FLOORROW,
 C_BCROW, C_BFROW, C_LFLAT) = range(12)
C_CA, C_FA, C_SOLID, C_SPRITE, C_CCB, C_FCB, C_CCID, C_FCID = (
    12, 16, 20, 21, 22, 23, 24, 25)
PIECE0, PIECE_C = 26, 16
(P_EXISTS, P_MASKED, P_LOW, P_HIGH, P_A, P_B, P_T1, P_T2, P_LIGHT, P_AB,
 P_EXMASK, P_CB, P_CID) = 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 14, 15
# The clip-window prefix's columns: has_back, the four row heights, solid.
PREFIX_COLS = [C_HB, C_CEILROW, C_FLOORROW, C_BCROW, C_BFROW, C_SOLID]
SLOT_ROWS = 8  # active-table slots are allocated in 8-row blocks


def compact_crossings(cfg, sd: int) -> int:
    """Crossing-compaction budget (explicit wins; -1 = AUTO: 8 on small
    levels)."""
    kc = int(cfg.portal_compact_crossings)
    if kc < 0:
        kc = 8 if sd <= SMALL_LEVEL_ROWS else 0
    return kc


def visible_segs(cfg, sd: int) -> int:
    """Visible-seg budget SV for a level with sd walk rows (portal.py:
    118-136): explicit portal_visible_segs wins (0 = off); -1 = AUTO: off
    on small levels, else 0.7 * sd rounded up to a multiple of 64, at
    least 256. Never below portal_crossings."""
    sv = int(cfg.portal_visible_segs)
    if sv < 0:
        if sd <= SMALL_LEVEL_ROWS:
            return 0
        sv = max(256, -(-(sd * 7) // 10 // 64) * 64)
    return max(sv, int(cfg.portal_crossings)) if sv else 0


def active_segs(pscene, cfg) -> int:
    """Rows of each env's active texel table: portal_active_segs when the
    level's compact table exceeds portal_global_segs_max (the active-set
    path), else 0 (B2 reads the global table)."""
    if pscene["tex_i8"].shape[0] > int(cfg.portal_global_segs_max):
        return int(cfg.portal_active_segs)
    return 0


# ---------------------------------------------------------------------------
# Host-side table packing (numpy), copied from the JAX module.
# ---------------------------------------------------------------------------


def _pack_alpha_words(combo_atlas, combo_dims):
    """Per-atlas-column bit-packed alpha of the walls (plane 1) and decor
    (plane 2) planes: (2*wc, n_words) int32, column x = walls column x,
    column wc+x = decor column x; bit y of word y//32 = texel (y, x)
    opaque (portal.py:151-184, without the byte split the TPU's bf16
    fetch needed)."""
    combo0 = np.asarray(combo_atlas[0])
    wc = combo0.shape[2]
    dims = np.asarray(combo_dims)
    hc = max(int(dims[1, 0]), int(dims[2, 0]), 1)
    n_words = max(-(-hc // 32), 1)
    cols = np.zeros((2 * wc, n_words), dtype=np.uint32)
    for plane, base in ((1, 0), (2, wc)):
        alpha = (combo0[plane, :hc] < 256).astype(np.uint32)  # (hc, wc)
        for yy in range(hc):
            cols[base:base + wc, yy >> 5] |= alpha[yy] << np.uint32(yy & 31)
    return cols.view(np.int32), n_words, hc, wc


def _frame_coords(ax, ay, tsx, row_h, atlas_w, frame):
    """Host copy of the animation frame placement for one frame."""
    au = ax + frame * tsx
    n_rows = math.ceil((au + tsx) / atlas_w) - 1 if atlas_w else 0
    safe_ts = tsx if tsx else 1.0
    au = au + ((atlas_w - ax) % safe_ts) * n_rows
    av = ay + n_rows * row_h
    return au, av


def _pack_layout(t: PortalTable, raws, flats_w, walls_w, align: bool) -> dict:
    """One compact texel-table layout (portal.py:235-344): every texture
    cell a record can sample, each animation frame contiguous with a +1
    guard row/col. align=True starts every cell on a 1024-texel (8-row)
    boundary, the active-set gather's block unit; align=False packs dense.
    Returns the flat table (texel 0..255, 256 = transparent), per source
    the frame-0 base and cell id (-1 for a degenerate cell), each cell's
    (base, length), and whether a non-masked reference reaches a hole."""
    S = t.p1.shape[0]
    D = t.sprite_center.shape[0]
    cells: dict = {}  # key -> (cell id, base)
    cell_blocks: list = []  # (base, length) per cell id
    cell_has_hole: list = []
    chunks: list = []
    size = 0
    nonmasked_holes = False

    def cell(plane, a6, atlas_w, masked_ref=False):
        nonlocal size, nonmasked_holes
        ax, ay, tsx, tsy, row_h, nf = (float(v) for v in a6)
        nf = max(int(nf), 1)
        itsx, itsy = int(tsx), int(tsy)
        if itsx <= 0 or itsy <= 0:
            return 0.0, -1
        key = (plane, ax, ay, tsx, tsy, row_h, nf)
        if key not in cells:
            pad = (-size) % 1024 if align else 0
            if pad:
                chunks.append(np.zeros((pad,), np.int32))
                size += pad
            cells[key] = (len(cell_blocks), size)
            blen = nf * (itsx + 1) * (itsy + 1)
            cell_blocks.append((size, blen))
            raw = raws[plane]
            ph, pw = raw.shape
            has_hole = False
            for f in range(nf):
                ax_f, ay_f = _frame_coords(ax, ay, tsx, row_h, atlas_w, f)
                ys = (int(ay_f) + np.arange(itsy + 1)) % ph
                xs = (int(ax_f) + np.arange(itsx + 1)) % pw
                block = raw[np.ix_(ys, xs)]
                has_hole = has_hole or bool((block >= 256).any())
                chunks.append(block.reshape(-1))
            size += blen
            cell_has_hole.append(has_hole)
        cid, base = cells[key]
        if not masked_ref and cell_has_hole[cid]:
            nonmasked_holes = True
        return float(base), cid

    fl = [cell(0, np.asarray(t.floor_atlas)[s], flats_w) for s in range(S)]
    ce = [cell(0, np.asarray(t.ceil_atlas)[s], flats_w) for s in range(S)]
    ptrans = np.asarray(t.piece_transparent)
    pc = [cell(1, np.asarray(t.piece_atlas)[s, pi], walls_w,
               masked_ref=bool(ptrans[s, pi]))
          for s in range(S) for pi in range(3)]
    sp = [cell(2, np.asarray(t.sprite_atlas)[d], walls_w, masked_ref=True)
          for d in range(D)]
    flat_tab = (np.concatenate(chunks) if chunks
                else np.zeros((1,), np.int32)).astype(np.int32)
    flat_tab = np.pad(flat_tab, (0, (-flat_tab.size) % 128))

    def split(pairs, shape):
        cb = np.array([b for b, _ in pairs], np.float32).reshape(shape)
        cid = np.array([c for _, c in pairs], np.int32).reshape(shape)
        return cb, cid

    out = dict(flat_tab=flat_tab, cell_blocks=cell_blocks,
               nonmasked_holes=nonmasked_holes)
    for name, pairs, shape in (("floor", fl, (S,)), ("ceil", ce, (S,)),
                               ("piece", pc, (S, 3)), ("sprite", sp, (D,))):
        out[name + "_cb"], out[name + "_cid"] = split(pairs, shape)
    return out


def _pack_compact_cells(t: PortalTable, arrays):
    """The compact per-cell texel tables (portal.py:198-404). Returns
    tex_i8 (S1, 128) s8 (texel - 128, dense layout), hole_bytes (Sh, 128)
    s8 or None when no non-masked cell has a hole, cmap_i8 (64, 128) s8,
    tex_full (S_al + 8, 128) int16 (the aligned layout for the active
    set: texel 0..255, 256 = hole, +8 guard rows for the 8-row block
    copies), and a dict of per-source bases (dense, and `_al` aligned),
    cell ids and per-cell segment ranges."""
    flats = np.asarray(arrays.flats_atlas)
    walls_i = np.asarray(arrays.walls_atlas_index)
    walls_a = np.asarray(arrays.walls_atlas_alpha)
    decor_i = np.asarray(arrays.decor_atlas_index)
    decor_a = np.asarray(arrays.decor_atlas_alpha)

    def plane_raw(p):
        if p == 0:
            return flats.astype(np.int32)
        idx, alpha = (walls_i, walls_a) if p == 1 else (decor_i, decor_a)
        if idx.size == 0:
            return np.zeros((1, 1), np.int32)
        return np.where(alpha, idx.astype(np.int32), 256)

    raws = [plane_raw(p) for p in range(3)]
    flats_w = float(max(flats.shape[1], 1))
    walls_w = float(max(walls_i.shape[1], 1)) if walls_i.size else 1.0
    dense = _pack_layout(t, raws, flats_w, walls_w, align=False)
    al = _pack_layout(t, raws, flats_w, walls_w, align=True)
    # Cell ids are insertion-ordered and alignment only moves bases.
    for name in ("floor_cid", "ceil_cid", "piece_cid", "sprite_cid"):
        assert np.array_equal(dense[name], al[name]), name

    flat_tab = dense["flat_tab"]
    tex_i8 = ((flat_tab & 255) - 128).astype(np.int8).reshape(-1, 128)
    hole_bytes = None
    if dense["nonmasked_holes"]:
        hole_bits = (flat_tab >= 256).astype(np.uint8)
        hbits = np.pad(hole_bits, (0, (-hole_bits.size) % 8)).reshape(-1, 8)
        hb = (hbits * (1 << np.arange(8))).sum(axis=1)
        hb = np.pad(hb, (0, (-hb.size) % 128))
        hole_bytes = (hb - 128).astype(np.int8).reshape(-1, 128)
    cmaps = np.asarray(arrays.colormaps)[:32].astype(np.int32)
    cmap_i8 = (cmaps - 128).astype(np.int8).reshape(-1, 128)
    tex_full = np.pad(al["flat_tab"].astype(np.int16).reshape(-1, 128),
                      ((0, SLOT_ROWS), (0, 0)))

    blocks = al["cell_blocks"]
    C = max(len(blocks), 1)
    cell_gseg0 = np.zeros((C,), np.int32)
    cell_nsegs = np.zeros((C,), np.int32)
    for cid, (base, blen) in enumerate(blocks):
        cell_gseg0[cid] = base >> 7
        cell_nsegs[cid] = ((base + blen - 1) >> 7) - (base >> 7) + 1
    bases = dict(cell_gseg0=cell_gseg0, cell_nsegs=cell_nsegs)
    for name in ("floor", "ceil", "piece", "sprite"):
        bases[name + "_cbase"] = dense[name + "_cb"]
        bases[name + "_cbase_al"] = al[name + "_cb"]
        bases[name + "_cid"] = dense[name + "_cid"]
    return tex_i8, hole_bytes, cmap_i8, tex_full, bases


def portal_scene_from_table(table: PortalTable, arrays, device) -> dict:
    """PortalTable + LevelArrays -> dict of tensors on `device`: the
    unified (S+D)-row crossing tables (sprites fill the middle piece
    slot), the packed alpha words, the compact texel / hole / colormap
    tables and the colormapped sky texture."""
    t = table
    S = t.p1.shape[0]
    D = t.sprite_center.shape[0]

    def cat(seg, spr):
        return np.concatenate([np.asarray(seg), np.asarray(spr)], axis=0)

    zs = np.zeros((D,), np.float32)
    zb = np.zeros((D,), bool)
    zi = np.zeros((D,), np.int32)
    z6 = np.zeros((D, 6), np.float32)

    def piece_cat(seg_arr, mid_val, fill=0.0):
        spr = np.full((D, 3), fill, np.asarray(seg_arr).dtype)
        spr[:, 1] = mid_val
        return np.concatenate([np.asarray(seg_arr), spr], axis=0)

    spr_atlas = np.zeros((D, 3, 6), np.float32)
    spr_atlas[:, 1, :] = np.asarray(t.sprite_atlas, np.float32)
    out = {
        "p1": np.asarray(t.p1), "p2": np.asarray(t.p2),
        "sprite_center": np.asarray(t.sprite_center).reshape(D, 2),
        "sprite_half": np.asarray(t.sprite_half),
        "hmin": np.asarray(t.hmin), "hmax": np.asarray(t.hmax),
        "has_back": cat(t.has_back, np.ones((D,), bool)),
        "is_solid": np.concatenate([np.ones((S,), bool), np.zeros((D,), bool)]),
        "is_sprite": np.concatenate([np.zeros((S,), bool), np.ones((D,), bool)]),
        "f_floor": cat(t.f_floor, zs), "f_ceil": cat(t.f_ceil, zs),
        "b_floor": cat(t.b_floor, zs), "b_ceil": cat(t.b_ceil, zs),
        "f_floor_obj": cat(t.f_floor_obj, zi), "f_ceil_obj": cat(t.f_ceil_obj, zi),
        "b_floor_obj": cat(t.b_floor_obj, zi), "b_ceil_obj": cat(t.b_ceil_obj, zi),
        "f_floor_sky": cat(t.f_floor_sky, zb), "f_ceil_sky": cat(t.f_ceil_sky, zb),
        "b_floor_sky": cat(t.b_floor_sky, zb), "b_ceil_sky": cat(t.b_ceil_sky, zb),
        "flat_light": cat(t.flat_light, zi),
        "floor_atlas": cat(t.floor_atlas, z6), "ceil_atlas": cat(t.ceil_atlas, z6),
        "piece_exists": piece_cat(t.piece_exists, True, False),
        "piece_low": piece_cat(t.piece_low, t.sprite_low),
        "piece_high": piece_cat(t.piece_high, t.sprite_high),
        "piece_obj": piece_cat(t.piece_obj, t.sprite_obj),
        "piece_s1": piece_cat(t.piece_s1, 0.0),
        "piece_s2": piece_cat(t.piece_s2, t.sprite_s2),
        "piece_t1": piece_cat(t.piece_t1, t.sprite_t1),
        "piece_t2": piece_cat(t.piece_t2, t.sprite_t2),
        "piece_light": piece_cat(t.piece_light, t.sprite_light),
        "piece_scroll": piece_cat(t.piece_scroll, 0.0),
        "piece_masked": piece_cat(t.piece_transparent, True, False),
        "piece_atlas": np.concatenate([np.asarray(t.piece_atlas), spr_atlas], axis=0),
    }
    words, n_words, hc, wc = _pack_alpha_words(arrays.combo_atlas, arrays.combo_dims)
    out["alpha_words"] = words
    tex_i8, hole_bytes, cmap_i8, tex_full, bases = _pack_compact_cells(t, arrays)
    out["tex_i8"] = tex_i8
    out["cmap_i8"] = cmap_i8
    if hole_bytes is not None:
        out["hole_bytes"] = hole_bytes
    # Per-source frame-0 bases: dense (tex_i8) and aligned (tex_full).
    for sfx in ("", "_al"):
        out["floor_cbase" + sfx] = cat(bases["floor_cbase" + sfx], zs)
        out["ceil_cbase" + sfx] = cat(bases["ceil_cbase" + sfx], zs)
        spr_pc = np.zeros((D, 3), np.float32)
        spr_pc[:, 1] = bases["sprite_cbase" + sfx]
        out["piece_cbase" + sfx] = np.concatenate(
            [bases["piece_cbase" + sfx], spr_pc], axis=0)
    # Active-set tables: per-source cell ids as f32 table columns (-1 for
    # none), each cell's segment run, the (S+D, C) row -> cell union
    # matrix, and the aligned texel table.
    neg = np.full((D,), -1.0, np.float32)
    out["floor_cid"] = cat(bases["floor_cid"].astype(np.float32), neg)
    out["ceil_cid"] = cat(bases["ceil_cid"].astype(np.float32), neg)
    spr_cid3 = np.full((D, 3), -1.0, np.float32)
    spr_cid3[:, 1] = bases["sprite_cid"]
    out["piece_cid"] = np.concatenate(
        [bases["piece_cid"].astype(np.float32), spr_cid3], axis=0)
    out["cell_gseg0"] = bases["cell_gseg0"].astype(np.float32)
    out["cell_nsegs"] = bases["cell_nsegs"].astype(np.float32)
    cell_m = np.zeros((S + D, out["cell_gseg0"].shape[0]), np.float32)
    rows = np.arange(S + D)
    for cid in (out["floor_cid"], out["ceil_cid"], *out["piece_cid"].T):
        ok = cid >= 0
        cell_m[rows[ok], cid[ok].astype(np.int64)] = 1.0
    out["cell_m"] = cell_m
    out["tex_full"] = tex_full
    sky = np.asarray(arrays.sky_index).astype(np.int32)
    out["sky_tex"] = np.asarray(arrays.colormaps)[0].astype(np.int32)[sky]
    pscene = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
              for k, v in out.items()}
    pscene["hc"] = hc
    return pscene


# ---------------------------------------------------------------------------
# The walk.
# ---------------------------------------------------------------------------


def _projection(cfg, width, height):
    """(p00, p11) as the walk computes them in f32."""
    f = float(np.float32(1.0) / np.float32(tan_f32(f32(math.radians(cfg.fov)) / 2.0)))
    aspect = (width / height) * cfg.player.aspect_ratio_correction
    return float(np.float32(f) / np.float32(aspect)), f


def _shear_terms(pitch, p11):
    """(sin, cos, shear_ndc) of the pitch, gated by PITCH_EPS; the trig
    rounded once from float64 (`_numerics.cos_sin`)."""
    on = torch.abs(pitch) > PITCH_EPS
    c, s = cos_sin(pitch)
    sp = torch.where(on, s, 0.0)
    cp = torch.where(on, c, 1.0)
    return sp, cp, p11 * sp / cp


def _anim_frame(num_frames, time):
    nf = num_frames.to(torch.float32)
    return torch.floor(torch.remainder(div(time, ANIM_FPS), torch.clamp_min(nf, 1.0)))


def _visible_rows(p1, p2, o, fwd, right, p00, pcfg):
    """Conservative per-row visibility (portal.py:743-777) -> (B, SD)
    bool: the camera strictly on the row's front side, the row not
    wholly before near or beyond far in forward depth, and not wholly
    outside either edge of the frustum wedge. A culled row cannot yield
    a valid crossing."""
    ox, oz = o[:, None, 0], o[:, None, 1]
    e = p2 - p1
    po = p1 - o[:, None, :]
    q1 = (p1[..., 0] - ox) * fwd[:, None, 0] + (p1[..., 1] - oz) * fwd[:, None, 1]
    q2 = (p2[..., 0] - ox) * fwd[:, None, 0] + (p2[..., 1] - oz) * fwd[:, None, 1]
    front = po[..., 0] * e[..., 1] - po[..., 1] * e[..., 0] > 0.0
    xvmax = f32(1.0 / p00)
    dl = fwd + right * (-xvmax)
    dr = fwd + right * xvmax

    def side(dd, p):
        return dd[:, None, 0] * (p[..., 1] - oz) - dd[:, None, 1] * (p[..., 0] - ox)

    cl1, cl2 = side(dl, p1), side(dl, p2)
    cr1, cr2 = side(dr, p1), side(dr, p2)
    return (front & (torch.maximum(q1, q2) > pcfg.near)
            & (torch.minimum(q1, q2) < pcfg.far)
            & ~((cl1 < 0.0) & (cl2 < 0.0)) & ~((cr1 > 0.0) & (cr2 > 0.0)))


def _gather_rows(x, rows):
    """x (B, S, C)[b, rows[b, j]] -> (B, J, C); `+ 0.0` as the JAX
    one-hot select turns -0.0 into +0.0."""
    return torch.gather(x, 1, rows[:, :, None].expand(-1, -1, x.shape[2])) + 0.0


def _active_set(pt, seg_live_f, act: int):
    """Active-set allocation (portal.py:1036-1079) from per-row live
    counts (B, SD) -> (gather_meta (B, C, 3) i32 in 8-row blocks
    [source, slot, count], slot_start (B, C) f32 rows, overflow (B,)).

    A cell is visible when a live row samples it; visible cells get
    consecutive slots of whole 8-row blocks (the f32 cumsum is exact:
    multiples of 8 below 2**24). An env needing more than `act` rows
    overflows; its meta is still clamped so every block lands below row
    `act`, because B5 runs on every env."""
    cell_vis = (seg_live_f > 0.5).to(torch.float32) @ pt["cell_m"] > 0.5  # (B, C)
    nseg_act = torch.where(cell_vis, pt["cell_nsegs"], 0.0)
    nblk8 = torch.where(cell_vis, torch.ceil(nseg_act / 8.0), 0.0)
    nseg_slot = nblk8 * 8.0
    cum = torch.cumsum(nseg_slot, dim=1)
    slot_start = cum - nseg_slot  # exclusive prefix
    overflow = cum[:, -1] > float(act)
    max_blk = float(act // SLOT_ROWS)
    nblk_safe = torch.clamp_min(torch.minimum(nblk8, max_blk - slot_start / 8.0), 0.0)
    slot_safe = torch.clamp_max(slot_start / 8.0, max_blk)
    gseg0 = (pt["cell_gseg0"] / 8.0).expand_as(slot_safe)
    meta = torch.stack([gseg0, slot_safe, nblk_safe], dim=-1).to(torch.int32)
    return meta, slot_start, overflow


def walk(pt, scene, cfg, width, height, n_cross, state, active_segs: int = 0):
    """Crossings + column walk for every env -> (records (B, R, 16, W),
    alpha words (B, K, n_words, W) i32, aux dict). active_segs > 0 runs
    the active-set allocation: aux["gather_meta"] then drives kernel B5,
    and every record's texel base points into the env's active table."""
    pcfg = cfg.player
    H, W = height, width
    p00, p11 = _projection(cfg, W, H)
    pos, yaw, pitch = state.pos, state.yaw, state.pitch
    objoff, time = state.object_offset, state.time
    B = pos.shape[0]
    dev = pos.device
    SD = pt["has_back"].shape[0]

    cy_, sy_ = cos_sin(yaw)
    sp_, cp_, shear_ndc = _shear_terms(pitch, p11)
    cam = pos + pcfg.camera_height * torch.stack([sy_ * sp_, cp_, cy_ * sp_], dim=1)
    row_shear = 0.5 * H * shear_ndc
    cx, cyw, cz = cam[:, 0], cam[:, 1], cam[:, 2]
    fwd = torch.stack([-sy_, -cy_], dim=1)  # (B, 2)
    right = torch.stack([cy_, -sy_], dim=1)

    i = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    # Compiled JAX divides by a constant as a multiply by its f32
    # reciprocal; the rays and light levels follow it (ROADMAP C).
    ndc_x = 2.0 * i * f32(1.0 / W) - 1.0
    xv = ndc_x * f32(1.0 / p00)
    d = fwd[:, None, :] + right[:, None, :] * xv[None, :, None]  # (B, W, 2)

    lights_f = light_table_u8(scene, time).to(torch.float32) * f32(1.0 / 255.0)  # (B, L)
    ls = lights_f.shape[1]

    def row_of(h, tt, cyw_, shear_):
        ndc_y = p11 * (h - cyw_) / tt
        return H - (ndc_y + 1.0) * 0.5 * H + shear_

    tcol = time[:, None]  # (B, 1)

    def anim_base(a6, atlas_w):
        base = anim_atlas_uv(a6[..., 0:2], a6[..., 2:4], a6[..., 4],
                             a6[..., 5].to(torch.int32), atlas_w,
                             tcol.reshape((B,) + (1,) * (a6.dim() - 1)))
        return base, a6[..., 2:4]

    flats_w = float(scene.flats_atlas.shape[1])
    walls_w = float(scene.walls_atlas_index.shape[1])
    hmin, hmax = pt["hmin"], pt["hmax"]
    NEG, POS = -1e9, 1e9

    def off(obj):
        return objoff[:, obj.long()]

    def light_of(idx):
        return lights_f[:, idx.long().clamp(0, ls - 1)]

    fc_s = pt["f_ceil"] + off(pt["f_ceil_obj"])
    ff_s = pt["f_floor"] + off(pt["f_floor_obj"])
    fcs_s = pt["f_ceil_sky"].expand(B, -1)
    ffs_s = pt["f_floor_sky"].expand(B, -1)
    bcs_s = pt["b_ceil_sky"].expand(B, -1)
    bfs_s = pt["b_floor_sky"].expand(B, -1)
    ca_b, ca_t = anim_base(pt["ceil_atlas"], flats_w)
    fa_b, fa_t = anim_base(pt["floor_atlas"], flats_w)
    plow_s = pt["piece_low"] + off(pt["piece_obj"].reshape(-1)).reshape(B, SD, 3)
    phigh_s = pt["piece_high"] + off(pt["piece_obj"].reshape(-1)).reshape(B, SD, 3)
    pa_s = pt["piece_s1"] + pt["piece_scroll"] * time[:, None, None]
    pb_s = pt["piece_s2"] - pt["piece_s1"]
    pl_s = light_of(pt["piece_light"].reshape(-1)).reshape(B, SD, 3)
    wa_b, wa_t = anim_base(pt["piece_atlas"], walls_w)  # (B, SD, 3, 2)

    def cbase_t(cb0, a6, t_):
        fr = _anim_frame(a6[..., 5], t_)
        return cb0 + fr * (a6[..., 2] + 1.0) * (a6[..., 3] + 1.0)

    # The active set samples the aligned tex_full layout, the global path
    # the dense tex_i8 one.
    sfx = "_al" if active_segs else ""
    ceil_cb_t = cbase_t(pt["ceil_cbase" + sfx], pt["ceil_atlas"], tcol)
    floor_cb_t = cbase_t(pt["floor_cbase" + sfx], pt["floor_atlas"], tcol)
    piece_cb_t = cbase_t(pt["piece_cbase" + sfx], pt["piece_atlas"], tcol[:, :, None])

    def bexp(x):
        return x.to(torch.float32).expand(B, SD)

    cols = [
        bexp(pt["has_back"]), fc_s, ff_s, bexp(fcs_s), bexp(ffs_s),
        bexp(bcs_s), bexp(bfs_s),
        torch.where(fcs_s, hmax, fc_s),
        torch.where(ffs_s, hmin, ff_s),
        torch.where(bcs_s, hmax, pt["b_ceil"] + off(pt["b_ceil_obj"])),
        torch.where(bfs_s, hmin, pt["b_floor"] + off(pt["b_floor_obj"])),
        light_of(pt["flat_light"]),
        ca_b[..., 0], ca_b[..., 1], bexp(ca_t[..., 0]), bexp(ca_t[..., 1]),
        fa_b[..., 0], fa_b[..., 1], bexp(fa_t[..., 0]), bexp(fa_t[..., 1]),
        bexp(pt["is_solid"]), bexp(pt["is_sprite"]),
        ceil_cb_t, floor_cb_t, bexp(pt["ceil_cid"]), bexp(pt["floor_cid"]),
    ]
    for pi in range(3):
        cols += [
            bexp(pt["piece_exists"][:, pi]), bexp(pt["piece_masked"][:, pi]),
            plow_s[..., pi], phigh_s[..., pi], pa_s[..., pi], bexp(pb_s[:, pi]),
            bexp(pt["piece_t1"][:, pi]), bexp(pt["piece_t2"][:, pi]), pl_s[..., pi],
            wa_b[:, :, pi, 0], wa_b[:, :, pi, 1],
            bexp(wa_t[:, pi, 0]), bexp(wa_t[:, pi, 1]),
            bexp(pt["piece_exists"][:, pi] & pt["piece_masked"][:, pi]),
            piece_cb_t[..., pi], bexp(pt["piece_cid"][:, pi]),
        ]
    table = torch.stack([c.to(torch.float32) for c in cols], dim=2)  # (B, SD, C)

    # Sprite billboard endpoints: center -+ right * half.
    spc, sph = pt["sprite_center"], pt["sprite_half"]
    sp_off = right[:, None, :] * sph[None, :, None]
    p1 = torch.cat([pt["p1"].expand(B, -1, -1), spc - sp_off], dim=1)  # (B, SD, 2)
    p2 = torch.cat([pt["p2"].expand(B, -1, -1), spc + sp_off], dim=1)
    o = torch.stack([cx, cz], dim=1)

    # --- visible-seg cull: at most SV rows per env, visible ones first in
    # row order (a stable sort); envs with more visible rows overflow.
    SD_full = SD
    SV = visible_segs(cfg, SD_full)
    overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    ordv = None
    if 0 < SV < SD_full:
        vis = _visible_rows(p1, p2, o, fwd, right, p00, pcfg)
        overflow = vis.sum(dim=1) > SV
        ordv = torch.sort((~vis).to(torch.int32), dim=1, stable=True).indices[:, :SV]
        p1, p2 = _gather_rows(p1, ordv), _gather_rows(p2, ordv)
        table = _gather_rows(table, ordv)
        SD = SV

    # --- crossings (B, W, SD) ---------------------------------------------
    e = p2 - p1
    po = p1 - o[:, None, :]
    d0, d1 = d[:, :, None, 0], d[:, :, None, 1]
    e0, e1 = e[:, None, :, 0], e[:, None, :, 1]
    po0, po1 = po[:, None, :, 0], po[:, None, :, 1]
    denom = d0 * e1 - d1 * e0
    safe = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    t = (po0 * e1 - po1 * e0) / safe
    u = (po0 * d1 - po1 * d0) / safe
    valid = ((torch.abs(denom) >= 1e-12) & (denom > 0.0) & (t > pcfg.near)
             & (t < pcfg.far) & (u >= 0.0) & (u <= 1.0))
    td = torch.where(valid, t, BIG_T)
    # Stable sort: equal depths keep seg-id order.
    td_s, order = torch.sort(td, dim=2, stable=True)
    K = min(n_cross, SD)
    order = order[:, :, :K]
    idx = order.transpose(1, 2)  # (B, K, W)
    t = td_s[:, :, :K].transpose(1, 2)
    uf = torch.gather(u, 2, order).transpose(1, 2)

    valid = t < BIG_T / 10.0
    safe_t = torch.where(valid, t, 1.0)
    cyw3, shear3 = cyw[:, None, None], row_shear[:, None, None]

    def select(cols, ix):
        """Attribute columns `cols` (a slice, or a list stacked from views:
        an index list would be copied to the device on every call) at the
        crossings' seg ids -> (B, K, W, n)."""
        Bk, Kk, Wk = ix.shape
        sub = (table[:, :, cols] if isinstance(cols, slice)
               else torch.stack([table[:, :, c] for c in cols], dim=2))
        flat = ix.reshape(Bk, Kk * Wk, 1).expand(-1, -1, sub.shape[2])
        return torch.gather(sub, 1, flat).reshape(Bk, Kk, Wk, sub.shape[2])

    # Attribute select. On big levels without crossing compaction, kernel
    # B4 selects all columns at every crossing in one pass, read by both
    # the clip-window prefix and the records; otherwise gathers select
    # the prefix columns now and all columns after compaction.
    K_c = compact_crossings(cfg, SD_full)
    use_sel = (cfg.portal_select_rows != "off" and K_c == 0
               and SD_full > SMALL_LEVEL_ROWS)
    if use_sel:
        idx_flat = idx.reshape(B, K * W).to(torch.int32)
        vals_cn = select_rows(idx_flat, table)  # (B, C, K * W)

        def col(c):
            return vals_cn[:, c].reshape(B, K, W)

        pre = [col(c) for c in PREFIX_COLS]
    else:
        sv = select(PREFIX_COLS, idx)
        pre = [sv[..., j] for j in range(len(PREFIX_COLS))]
    hb_p = pre[0] > 0.5
    solid_p = pre[5] > 0.5
    r_fc_p = row_of(pre[1], safe_t, cyw3, shear3)
    r_ff_p = row_of(pre[2], safe_t, cyw3, shear3)
    row_bc = row_of(pre[3], safe_t, cyw3, shear3)
    row_bf = row_of(pre[4], safe_t, cyw3, shear3)

    # Clip-window prefix over crossings (cummax / cummin along K).
    vs = valid & solid_p
    step_top = torch.where(vs, torch.where(hb_p, torch.maximum(r_fc_p, row_bc), r_fc_p), NEG)
    step_bot = torch.where(vs, torch.where(hb_p, torch.minimum(r_ff_p, row_bf), r_ff_p), POS)
    cum_top = torch.cummax(step_top, dim=1).values
    cum_bot = torch.cummin(step_bot, dim=1).values
    top = torch.clamp_min(
        torch.cat([torch.full_like(cum_top[:, :1], NEG), cum_top[:, :-1]], dim=1), 0.0)
    bot = torch.clamp_max(
        torch.cat([torch.full_like(cum_bot[:, :1], POS), cum_bot[:, :-1]], dim=1),
        float(H))
    top1_p = torch.where(solid_p, torch.maximum(top, r_fc_p), top)
    bot1_p = torch.where(solid_p, torch.minimum(bot, r_ff_p), bot)
    new_top = torch.where(hb_p, torch.maximum(top1_p, row_bc), top1_p)
    new_bot = torch.where(hb_p, torch.minimum(bot1_p, row_bf), bot1_p)
    blocker = (vs & (~hb_p | (new_top >= new_bot))) | ~valid
    blocked = torch.cummax(blocker.to(torch.int32), dim=1).values > 0
    done_before = torch.cat(
        [torch.zeros_like(blocked[:, :1]), blocked[:, :-1]], dim=1)
    live = valid & ~done_before

    # --- crossing compaction: the first K_c crossings live in any column.
    if 0 < K_c < n_cross:
        live_k = live.any(dim=2)  # (B, K)
        overflow = overflow | (live_k.sum(dim=1) > K_c)
        ordk = torch.sort((~live_k).to(torch.int32), dim=1, stable=True).indices[:, :K_c]
        g = ordk[:, :, None].expand(-1, -1, W)
        t = torch.gather(t, 1, g)
        uf = torch.gather(uf, 1, g)
        idx = torch.gather(idx, 1, g)
        live = torch.gather(live, 1, g)
        top = torch.gather(top, 1, g)
        bot = torch.gather(bot, 1, g)
        valid = t < BIG_T / 10.0
        safe_t = torch.where(valid, t, 1.0)
        K_eff = ordk.shape[1]
    else:
        K_eff = K

    # --- active-set allocation (texel tables above portal_global_segs_max).
    if active_segs:
        live_f = live.to(torch.float32).reshape(B, -1)
        if use_sel:
            seg_live_f = scatter_live(idx_flat, live_f, SD)
        else:
            seg_live_f = torch.zeros((B, SD), dtype=torch.float32, device=dev)
            seg_live_f.scatter_add_(1, idx.reshape(B, -1), live_f)
        if ordv is not None:
            # Compacted rows home to level rows (ordv's rows are distinct;
            # rows past the visible count are invisible and count 0).
            seg_live_f = torch.zeros((B, SD_full), dtype=torch.float32,
                                     device=dev).scatter_(1, ordv, seg_live_f)
        gather_meta, slot_start, ovf = _active_set(pt, seg_live_f, active_segs)
        overflow = overflow | ovf
        gseg0 = pt["cell_gseg0"]
        n_cells = gseg0.shape[0]

        def remap_cb(cb, cid):
            """Texel bases into the env's active table."""
            ci = cid.to(torch.int64).clamp(0, n_cells - 1)
            slot = torch.gather(slot_start, 1, ci.reshape(B, -1)).reshape(ci.shape)
            shift = (slot - gseg0[ci]) * 128.0
            return torch.where(cid < 0.0, 0.0, cb + shift)
    else:
        gather_meta = None

        def remap_cb(cb, cid):
            return cb

    if not use_sel:
        vals = select(slice(None), idx)  # (B, K_eff, W, C)

        def col(c):
            return vals[..., c]

    hb = col(C_HB) > 0.5
    solid = col(C_SOLID) > 0.5
    sprite = col(C_SPRITE) > 0.5
    fc, ff = col(C_FC), col(C_FF)
    fcs, ffs = col(C_FCS) > 0.5, col(C_FFS) > 0.5
    bcs, bfs = col(C_BCS) > 0.5, col(C_BFS) > 0.5
    light_flat = col(C_LFLAT)
    r_fc = row_of(col(C_CEILROW), safe_t, cyw3, shear3)
    r_ff = row_of(col(C_FLOORROW), safe_t, cyw3, shear3)
    top1 = torch.where(solid, torch.maximum(top, r_fc), top)
    bot1 = torch.where(solid, torch.minimum(bot, r_ff), bot)

    recs = []
    zero = torch.zeros((B, K_eff, W), dtype=torch.float32, device=dev)

    def rec(y0, y1, kind, p0=0.0, ab=None, light=0.0, w=0.0, t1=0.0, t2=0.0,
            low=0.0, high=0.0, masked=0.0, cbase=0.0, ok=None):
        # Every channel is gated by ok; `+ zero` also turns -0.0 into +0.0
        # exactly as the JAX walk's gate does.
        def gate(v):
            return torch.where(ok, v, 0.0) + zero

        ch = [None] * NCH
        ch[R_Y0] = torch.where(ok, y0, 1e9) + zero
        ch[R_Y1] = torch.where(ok, y1, -1e9) + zero
        ch[R_KIND] = torch.where(ok, kind, KIND_NONE) + zero
        ch[R_P0] = gate(p0)
        if ab is None:
            for c in (R_AX, R_AY, R_TSX, R_TSY):
                ch[c] = zero
        else:
            ch[R_AX], ch[R_AY] = gate(ab[0]), gate(ab[1])
            ch[R_TSX], ch[R_TSY] = gate(ab[2]), gate(ab[3])
        ch[R_MASKED] = torch.where(ok, masked, 0.0) + zero
        ch[R_CBASE] = gate(cbase)
        ch[R_LIGHT] = gate(light)
        ch[R_W] = gate(w)
        ch[R_T1] = gate(t1)
        ch[R_T2] = gate(t2)
        ch[R_LOW] = gate(low)
        ch[R_HIGH] = gate(high)
        recs.append(torch.stack(ch, dim=2))  # (B, K_eff, NCH, W)

    # Ceiling span, with the sky band at sky -> non-sky boundaries folded in.
    band_c = fcs & (~hb | ~bcs)
    rec(top,
        torch.where(band_c, torch.minimum(bot1, row_of(fc, safe_t, cyw3, shear3)),
                    torch.minimum(bot, r_fc)),
        torch.where(fcs, KIND_SKY, KIND_FLAT),
        p0=col(C_CEILROW), ab=tuple(col(C_CA + j) for j in range(4)),
        light=light_flat, cbase=remap_cb(col(C_CCB), col(C_CCID)), ok=live & solid)
    # Floor span, with its sky band.
    band_f = ffs & (~hb | ~bfs)
    rec(torch.where(band_f, torch.maximum(top1, row_of(ff, safe_t, cyw3, shear3)),
                    torch.maximum(top, r_ff)),
        torch.where(band_f, bot1, bot),
        torch.where(ffs, KIND_SKY, KIND_FLAT),
        p0=col(C_FLOORROW), ab=tuple(col(C_FA + j) for j in range(4)),
        light=light_flat, cbase=remap_cb(col(C_FCB), col(C_FCID)), ok=live & solid)
    # Wall pieces lower / middle / upper (sprites ride the middle).
    for pi in range(3):
        c0 = PIECE0 + pi * PIECE_C
        pe = col(c0 + P_EXISTS) > 0.5
        masked = col(c0 + P_EXMASK) > 0.5
        plow, phigh = col(c0 + P_LOW), col(c0 + P_HIGH)
        uu = col(c0 + P_A) + col(c0 + P_B) * uf
        if pi == 1:
            kind = torch.where(sprite, KIND_DECOR, KIND_WALL)
        else:
            kind = torch.full_like(zero, KIND_WALL)
        rec(torch.maximum(top1, row_of(phigh, safe_t, cyw3, shear3)),
            torch.minimum(bot1, row_of(plow, safe_t, cyw3, shear3)),
            kind, p0=uu, ab=tuple(col(c0 + P_AB + j) for j in range(4)),
            light=col(c0 + P_LIGHT), w=t, t1=col(c0 + P_T1), t2=col(c0 + P_T2),
            low=plow, high=phigh, masked=masked.to(torch.float32),
            cbase=remap_cb(col(c0 + P_CB), col(c0 + P_CID)), ok=live & pe)

    # Masked alpha words: one texture column per crossing and screen column.
    c0m = PIECE0 + PIECE_C
    uu_m = col(c0m + P_A) + col(c0m + P_B) * uf
    tsx_m, ax_m = col(c0m + P_AB + 2), col(c0m + P_AB)
    aw = pt["alpha_words"]  # (2*wc, n_words)
    wc = aw.shape[0] // 2
    u1 = torch.remainder(uu_m, torch.where(tsx_m == 0.0, 1.0, tsx_m)) + ax_m
    x_t = torch.remainder(to_i32(torch.floor(u1)), wc)
    col_idx = x_t + torch.where(sprite, wc, 0)
    words = aw[col_idx.long()].permute(0, 1, 3, 2).contiguous()  # (B, K, n_words, W)

    records = torch.stack(recs, dim=2).reshape(B, K_eff * RECORDS_PER_CROSSING, NCH, W)
    aux = dict(cam=cam, d=d, sy=sy_, cy=cy_, sp=sp_, cp=cp_, shear=shear_ndc,
               overflow=overflow)
    if gather_meta is not None:
        aux["gather_meta"] = gather_meta
    return records, words, aux


def sky_image(pt, scene, cfg, width, height, sy_, cy_, sp_, cp_,
              window_rows: bool = False):
    """Per-env colormapped sky image (B, H, W) f32: the sky's texel
    coordinates are row/column separable, so two row gathers.

    Image row j takes its ndc from y = j + 0.5, as the JAX package's
    `_sky_image` (B2's input) does, or with `window_rows` from the window
    y = H - j - 0.5, as its `_shade_portal` (the `portal_jnp` shade) and
    the triangle path do. The band fold mirrors the two onto each other at
    zero pitch; under pitch they differ."""
    pcfg = cfg.player
    H, W = height, width
    p00, p11 = _projection(cfg, W, H)
    dev = sy_.device
    r1z = cy_ * sp_
    r2z = cy_ * cp_
    far, near = pcfg.far, pcfg.near
    c22 = (far + near) / (near - far)
    fwd_x = p00 * (-sy_)
    fwd_z = c22 * r2z
    fwd_w = -r2z
    v_r0 = torch.atan2(fwd_x, fwd_z)[:, None]
    v_r1 = ((p11 * r1z) / torch.where(fwd_w == 0.0, 1.0, fwd_w))[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    j = torch.arange(H, dtype=torch.float32, device=dev)
    ys = H - j - 0.5 if window_rows else j + 0.5
    ndc_x = div(xs, 0.5 * W) - 1.0
    ndc_yf = div(ys, 0.5 * H) - 1.0
    sky_u = ndc_x - div(4.0 * v_r0, f32(math.pi))  # (B, W)
    sky_v = -ndc_yf + 1.0 + v_r1  # (B, H)
    sky_x = sky_x_texel(scene, sky_u)
    sky_y = sky_y_texel(scene, sky_v)
    tex = pt["sky_tex"].to(torch.float32)  # (hs, ws)
    rows = tex[sky_y.long()]  # (B, H, ws)
    return torch.gather(rows, 2, sky_x.long()[:, None, :].expand(-1, H, -1))


def fused_inputs(pscene, scene, cfg, width, height, state):
    """Walk every env and assemble kernel B2's arguments: returns (args,
    keyword args, overflow (B,) bool) for `render_portal_fused`. On the
    active-set path kernel B5 builds the per-env texel tables first."""
    act = active_segs(pscene, cfg)
    records, words, aux = walk(pscene, scene, cfg, width, height,
                               int(cfg.portal_crossings), state, active_segs=act)
    dxz = aux["d"].transpose(1, 2).contiguous()  # (B, 2, W)
    sky = sky_image(pscene, scene, cfg, width, height, aux["sy"], aux["cy"],
                    aux["sp"], aux["cp"])
    if act:
        tex = gather_cells(aux["gather_meta"], pscene["tex_full"], act)  # (B, act, 128)
        hole = None
    else:
        tex, hole = pscene["tex_i8"], pscene.get("hole_bytes")
    p11 = 1.0 / math.tan(math.radians(cfg.fov) / 2.0)
    args = (records, words, aux["cam"], pscene["hc"], dxz, sky, tex, hole,
            pscene["cmap_i8"], height, p11, scene.palette_lut.shape[0])
    return args, dict(shear=aux["shear"]), aux["overflow"]


def oracle_inputs(pscene, scene, cfg, width, height, state):
    """Walk every env and assemble the `portal_jnp` configuration's kernel
    arguments: returns (B7's args, B8's args after its channels, shear
    (B,), overflow (B,) bool). B8's sky image is `_shade_portal`'s
    (`sky_image(window_rows=True)`). The JAX package takes no active set
    on this path, so B8 reads the dense global table on every level; a holeless
    level gets a full-size table of empty hole bytes (ceil(S1 / 8) rows
    of -128), never the TPU's (1, 128) stub, which B8 would read past."""
    H, W = height, width
    records, words, aux = walk(pscene, scene, cfg, W, H,
                               int(cfg.portal_crossings), state)
    B = records.shape[0]
    P = H * W
    dev = records.device
    p11 = 1.0 / math.tan(math.radians(cfg.fov) / 2.0)
    dxz = aux["d"].transpose(1, 2)[:, :, None, :].expand(B, 2, H, W).reshape(B, 2, P)
    sky = sky_image(pscene, scene, cfg, W, H, aux["sy"], aux["cy"], aux["sp"],
                    aux["cp"], window_rows=True).reshape(B, P)
    y = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    ndc_y = (1.0 - div(2.0 * y, float(H)))[:, None].expand(H, W).reshape(1, P)
    tex = pscene["tex_i8"]
    hole = pscene.get("hole_bytes")
    if hole is None:
        hole = torch.full((-(-tex.shape[0] // 8), 128), -128, dtype=torch.int8,
                          device=dev)
    classify_args = (records, words, aux["cam"][:, 1], pscene["hc"], H, p11)
    shade_args = (dxz, ndc_y, sky, aux["cam"], tex, hole, pscene["cmap_i8"], p11,
                  scene.palette_lut.shape[0])
    return classify_args, shade_args, aux["shear"], aux["overflow"]


def render_portal_zero_pitch(pscene, scene, cfg, state, width, height):
    """The column-walk path proper (pitch as y-shear) -> (idx u8, covered
    bool, overflow (B,) bool): B2, or B7 then B8 under `portal_jnp`."""
    if cfg.raster_backend == "portal_jnp":
        cargs, sargs, shear, overflow = oracle_inputs(
            pscene, scene, cfg, width, height, state)
        ch = classify_alpha(*cargs, shear=shear)
        B = ch.shape[0]
        del cargs  # the records and words: B8 needs neither
        idx_f, cov_f = shade_portal(ch.reshape(B, 11, -1), *sargs, shear=shear)
        idx_f = idx_f.reshape(B, height, width)
        cov_f = cov_f.reshape(B, height, width)
    else:
        args, kw, overflow = fused_inputs(pscene, scene, cfg, width, height, state)
        idx_f, cov_f = render_portal_fused(*args, **kw)
    return idx_f.to(torch.uint8), cov_f > 0.5, overflow


# Envs one run of a captured tick's fallback renders through the
# triangle path (render_frames_portal).
FALLBACK_ENVS = 32
_FALLBACK_TALLY: dict = {}  # device -> 0-d int64 count of fallback envs


def fallback_tally(device) -> torch.Tensor:
    """A 0-d int64 tensor on `device` to which every later portal frame
    adds, on the device, its number of envs on the triangle fallback.
    Made at the first call, which must come before the captures it is to
    count; zero it and read it as any tensor."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _FALLBACK_TALLY:
        _FALLBACK_TALLY[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return _FALLBACK_TALLY[dev]


def render_frames_portal(pscene, scene, cfg, state, width, height):
    """(indices (B, H, W) u8, covered (B, H, W) bool) via the portal path,
    with the exact triangle fallback for overflowed envs (and pitched
    ones under portal_pitch="triangle"): B3's path, or the "jnp" path
    under `portal_jnp` (raster.render_frames picks by the config).

    Eagerly the host reads whether any env falls back, one flag per frame,
    and renders those envs alone. Inside a captured tick that decision
    stays on the device (`graphs.device_while`; the JAX package's
    `lax.cond`) and shapes cannot depend on the data: the envs in the
    order fallen first (a stable argsort) are cut into blocks of
    FALLBACK_ENVS (the last block ends at the last env), and a WHILE node
    renders one block per run through the triangle path while fallen envs
    remain; the fallen ones among its envs take its frame (`jnp.where`).
    The work follows the number of fallen envs, the graph holds one node
    for it, and the memory it keeps is one block's. Each env renders on
    its own, so all forms give the same frames."""
    from ..graphs import decides_on_device, device_while

    idx, cov, overflow = render_portal_zero_pitch(
        pscene, scene, cfg, state, width, height)
    if cfg.portal_pitch == "triangle":
        fall = (torch.abs(state.pitch) > PITCH_EPS) | overflow
    else:
        fall = overflow
    tally = _FALLBACK_TALLY.get(fall.device)
    if tally is not None:
        tally.add_(fall.sum())
    if decides_on_device(fall):
        B = fall.shape[0]
        n = min(FALLBACK_ENVS, B)
        order = torch.argsort((~fall).to(torch.uint8), stable=True)
        n_fall = fall.sum()
        block = torch.zeros((), dtype=torch.int64, device=fall.device)
        lanes = torch.arange(n, device=fall.device)

        def render_block():
            sel = order[torch.clamp(block * n, max=B - n) + lanes]
            idx_t, cov_t = render_frames(
                scene, cfg, type(state)(*(x[sel] for x in state)), width, height)
            took = fall[sel][:, None, None]
            idx.index_put_((sel,), torch.where(took, idx_t, idx[sel]))
            cov.index_put_((sel,), torch.where(took, cov_t, cov[sel]))
            block.add_(1)

        device_while(lambda: block * n < n_fall, render_block, -(-B // n))
    elif bool(fall.any()):
        sel = torch.nonzero(fall).flatten()
        sub = type(state)(*(x[sel] for x in state))
        idx_t, cov_t = render_frames(scene, cfg, sub, width, height)
        idx = idx.index_copy(0, sel, idx_t)
        cov = cov.index_copy(0, sel, cov_t)
    return idx, cov
