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
per-seg tables are (B, SD, C), crossings (B, K, W). Kernel W0
(`ops.walk.walk_table`) builds the per-(env, row) attribute table (its
per-level columns precomputed once, `walk_static`) and on big levels the
visible-seg cull; kernel W1 (`ops.walk.walk_cross`) then crosses every
column's ray with every row, keeps the K nearest and runs the clip
window, and kernel W2 (`ops.walk.walk_records`) compacts the crossings
and writes the span records and alpha words, on every level. B2 takes
the sky as its separable texel coordinates (`sky_coords`) and the u8 sky
texture, and writes the frames as u8 / bool.

Big levels (more than 192 walk rows, segs + sprites, at the shipped
defaults) take the big-level walk:
* the visible-seg cull (`portal_visible_segs`, on any level where
  0 < SV < SD; in W0): a conservative per-row test keeps at most SV rows
  per env before the crossing math; envs with more visible rows overflow;
* when crossing compaction is off, kernel B4 (`ops.raster.select_rows`)
  selects every attribute column at every crossing in one pass, and W2
  reads that selection instead of the table;
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

from .. import trace
from .._numerics import cos_sin, div, f32, to_i32
from ..geom.portal import PortalTable
from ..ops.raster import (
    classify_alpha,
    gather_cells,
    render_portal_fused,
    scatter_live,
    select_rows,
    shade_portal,
    sky_gather,
)
from ..ops.walk import (
    C_BCS,
    C_BFS,
    C_CA,
    C_CCID,
    C_FA,
    C_FCID,
    C_FCS,
    C_FFS,
    C_HB,
    C_SOLID,
    C_SPRITE,
    P_AB,
    P_B,
    P_CID,
    P_EXISTS,
    P_EXMASK,
    P_MASKED,
    P_T1,
    P_T2,
    PIECE0,
    PIECE_C,
    SMALL_LEVEL_ROWS,
    STATIC_COLS,
    compact_order,
    walk_cross,
    walk_records,
    walk_table,
)
from ..sim.lights import light_table_u8
from .camera import tan_f32
from .raster import ANIM_FPS, anim_atlas_uv, render_frames, sky_x_texel, sky_y_texel

PITCH_EPS = 1e-5  # |pitch| above this engages the y-shear (or fallback)
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


def _walk_static(out) -> np.ndarray:
    """The attribute table's columns that depend on no env (the flags,
    tile sizes, texture rows, the pieces' u span and the cell ids), once
    per level -> (S+D, len(STATIC_COLS)) f32, column k the table's column
    STATIC_COLS[k]. The per-tick table build computes the same values
    (`walk_table_ref`); kernel W0 copies them from here."""
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    cols = {
        C_HB: out["has_back"], C_FCS: out["f_ceil_sky"], C_FFS: out["f_floor_sky"],
        C_BCS: out["b_ceil_sky"], C_BFS: out["b_floor_sky"],
        C_CA + 2: out["ceil_atlas"][:, 2], C_CA + 3: out["ceil_atlas"][:, 3],
        C_FA + 2: out["floor_atlas"][:, 2], C_FA + 3: out["floor_atlas"][:, 3],
        C_SOLID: out["is_solid"], C_SPRITE: out["is_sprite"],
        C_CCID: out["ceil_cid"], C_FCID: out["floor_cid"],
    }
    for pi in range(3):
        c0 = PIECE0 + pi * PIECE_C
        exists, masked = out["piece_exists"][:, pi], out["piece_masked"][:, pi]
        cols.update({
            c0 + P_EXISTS: exists, c0 + P_MASKED: masked,
            c0 + P_B: f(out["piece_s2"][:, pi]) - f(out["piece_s1"][:, pi]),
            c0 + P_T1: out["piece_t1"][:, pi], c0 + P_T2: out["piece_t2"][:, pi],
            c0 + P_AB + 2: out["piece_atlas"][:, pi, 2],
            c0 + P_AB + 3: out["piece_atlas"][:, pi, 3],
            c0 + P_EXMASK: exists & masked, c0 + P_CID: out["piece_cid"][:, pi],
        })
    return np.stack([f(cols[c]) for c in STATIC_COLS], axis=1)


def portal_scene_from_table(table: PortalTable, arrays, device) -> dict:
    """PortalTable + LevelArrays -> dict of tensors on `device`: the
    unified (S+D)-row crossing tables (sprites fill the middle piece
    slot), the attribute table's per-level columns (`walk_static`), the
    packed alpha words, the compact texel / hole / colormap tables and
    the colormapped sky texture (u8)."""
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
    # The colormapped sky texture: palette indices, so u8 (B2 reads it at
    # sky pixels).
    sky = np.asarray(arrays.sky_index).astype(np.int32)
    out["sky_tex"] = np.asarray(arrays.colormaps)[0].astype(np.uint8)[sky]
    out["walk_static"] = _walk_static(out)
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


def _visible_rows(p1, p2, o, fwd, right, p00, near: float, far: float):
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
    return (front & (torch.maximum(q1, q2) > near)
            & (torch.minimum(q1, q2) < far)
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


def walk_table_ref(pt, lights_f, objoff, time, right, fwd, o, p00: float,
                   near: float, far: float, sv: int, flats_w: float, walls_w: float,
                   aligned: bool):
    """Plain version of kernel W0 (`ops.walk.walk_table`): the walk's
    per-(env, row) attribute table (portal.py:652-720) and, where sv > 0,
    the visible-seg cull (portal.py:730-790).

    pt the portal scene; lights_f (B, L) the light levels; objoff (B, O)
    the movable objects' offsets; time (B,); right, fwd (B, 2) the
    camera's xz axes and o (B, 2) its xz position; p00 the projection's
    x scale; `aligned` takes the texel bases of the active set's aligned
    layout. Returns the table (B, SD', 74) f32, the rows' endpoints p1,
    p2 (B, SD', 2) (sprites as billboards facing the camera), `ordv` (B,
    sv) int64, the level rows the cull kept in order (visible rows first
    in row order, then the invisible ones: a stable sort), or None, the
    overflow (B,) bool (more than sv rows visible), and each env's count
    of visible rows (B,) int32, or None. SD' is sv where sv > 0, else the
    level's S+D rows."""
    B = time.shape[0]
    SD = pt["has_back"].shape[0]
    ls = lights_f.shape[1]
    tcol = time[:, None]  # (B, 1)

    def anim_base(a6, atlas_w):
        base = anim_atlas_uv(a6[..., 0:2], a6[..., 2:4], a6[..., 4],
                             a6[..., 5].to(torch.int32), atlas_w,
                             tcol.reshape((B,) + (1,) * (a6.dim() - 1)))
        return base, a6[..., 2:4]

    hmin, hmax = pt["hmin"], pt["hmax"]

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
    sfx = "_al" if aligned else ""
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

    overflow = torch.zeros((B,), dtype=torch.bool, device=time.device)
    ordv = n_vis = None
    if sv:
        vis = _visible_rows(p1, p2, o, fwd, right, p00, near, far)
        n_vis = vis.sum(dim=1).to(torch.int32)
        overflow = n_vis > sv
        ordv = torch.sort((~vis).to(torch.int32), dim=1, stable=True).indices[:, :sv]
        p1, p2 = _gather_rows(p1, ordv), _gather_rows(p2, ordv)
        table = _gather_rows(table, ordv)
    return table, p1, p2, ordv, overflow, n_vis


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
    o = torch.stack([cx, cz], dim=1)

    # --- the attribute table, and on big levels the visible-seg cull: at
    # most SV rows per env, visible ones first in row order; envs with
    # more visible rows overflow (W0).
    SD_full = SD
    SV = visible_segs(cfg, SD_full)
    table, p1, p2, ordv, overflow, n_vis = walk_table(
        pt, lights_f, objoff, time, right, fwd, o, p00, pcfg.near, pcfg.far,
        SV if 0 < SV < SD_full else 0, float(scene.flats_atlas.shape[1]),
        float(scene.walls_atlas_index.shape[1]), bool(active_segs))
    if n_vis is not None:  # the cull ran: so far the overflow is its alone
        trace.count("cull_overflow_envs", overflow)
        trace.count("visible_rows", n_vis)
    SD = table.shape[1]

    # --- crossings, the K nearest per column and the clip window (W1).
    K = min(n_cross, SD)
    t, uf, idx, live, top, bot, mask = walk_cross(
        p1, p2, o, d, table, cyw, row_shear, pcfg.near, pcfg.far, p11, H, K)

    # --- records and alpha words of the first K_c crossings live in any
    # column (crossing compaction; all K without it): W2 on every level.
    K_c = compact_crossings(cfg, SD_full)
    kc = K_c if 0 < K_c < n_cross else 0
    # On big levels without crossing compaction, kernel B4 selects every
    # attribute column at every crossing in one pass, and W2 reads that.
    use_sel = (cfg.portal_select_rows != "off" and K_c == 0
               and SD_full > SMALL_LEVEL_ROWS)
    idx_flat = idx.reshape(B, K * W) if use_sel else None

    # --- active-set allocation (texel tables above portal_global_segs_max).
    shift = gather_meta = None
    if active_segs:
        # The seg-live counts take the compacted crossings' liveness.
        kept_idx, kept_live = idx, live
        if kc:
            g = compact_order(mask, K, kc)[:, :, None].expand(-1, -1, W)
            kept_idx, kept_live = torch.gather(idx, 1, g), torch.gather(live, 1, g)
        live_f = kept_live.to(torch.float32).reshape(B, -1)
        if use_sel:
            seg_live_f = scatter_live(idx_flat, live_f, SD)
        else:
            seg_live_f = torch.zeros((B, SD), dtype=torch.float32, device=dev)
            seg_live_f.scatter_add_(1, kept_idx.long().reshape(B, -1), live_f)
        if ordv is not None:
            # Compacted rows home to level rows (ordv's rows are distinct;
            # rows past the visible count are invisible and count 0).
            seg_live_f = torch.zeros((B, SD_full), dtype=torch.float32,
                                     device=dev).scatter_(1, ordv, seg_live_f)
        gather_meta, slot_start, ovf = _active_set(pt, seg_live_f, active_segs)
        overflow = overflow | ovf
        # Each cell's move of its texel bases into the env's active table.
        shift = (slot_start - pt["cell_gseg0"][None, :]) * 128.0

    sel = None
    if use_sel:
        with trace.span("select"):
            sel = select_rows(idx_flat, table)  # (B, C, K * W)
    records, words, overflow = walk_records(
        t, uf, idx, live, top, bot, mask, overflow, None if use_sel else table,
        pt["alpha_words"], cyw, row_shear, p11, H, kc, shift, sel)

    aux = dict(cam=cam, d=d, sy=sy_, cy=cy_, sp=sp_, cp=cp_, shear=shear_ndc,
               overflow=overflow)
    if gather_meta is not None:
        aux["gather_meta"] = gather_meta
    return records, words, aux


def sky_coords(scene, cfg, width, height, sy_, cy_, sp_, cp_,
               window_rows: bool = False):
    """The sky's texel coordinates, which are row/column separable: the
    column of each image column, sky_x (B, W) i32, and the row of each
    image row, sky_y (B, H) i32; pixel (j, i) of env b shows
    sky_tex[sky_y[b, j], sky_x[b, i]].

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
    return (sky_x_texel(scene, sky_u).to(torch.int32),
            sky_y_texel(scene, sky_v).to(torch.int32))


def sky_image(pt, scene, cfg, width, height, sy_, cy_, sp_, cp_,
              window_rows: bool = False):
    """Per-env colormapped sky image (B, H, W) f32: `sky_coords` and two
    row gathers of the sky texture (`ops.raster.sky_gather`). B8's input
    (the `portal_jnp` configuration); B2 takes the coordinates."""
    sky_x, sky_y = sky_coords(scene, cfg, width, height, sy_, cy_, sp_, cp_,
                              window_rows)
    return sky_gather(sky_x, sky_y, pt["sky_tex"])


def fused_inputs(pscene, scene, cfg, width, height, state, walked=None):
    """Walk every env (unless `walked` holds `walk`'s result) and assemble
    kernel B2's arguments: returns (args, keyword args, overflow (B,)
    bool) for `render_portal_fused`. On the active-set path kernel B5
    builds the per-env texel tables first."""
    act = active_segs(pscene, cfg)
    records, words, aux = walked or walk(pscene, scene, cfg, width, height,
                                         int(cfg.portal_crossings), state, active_segs=act)
    dxz = aux["d"].transpose(1, 2).contiguous()  # (B, 2, W)
    sky_x, sky_y = sky_coords(scene, cfg, width, height, aux["sy"], aux["cy"],
                              aux["sp"], aux["cp"])
    if act:
        tex = gather_cells(aux["gather_meta"], pscene["tex_full"], act)  # (B, act, 128)
        hole = None
    else:
        tex, hole = pscene["tex_i8"], pscene.get("hole_bytes")
    p11 = 1.0 / math.tan(math.radians(cfg.fov) / 2.0)
    args = (records, words, aux["cam"], pscene["hc"], dxz, sky_x, sky_y,
            pscene["sky_tex"], tex, hole, pscene["cmap_i8"], height, p11,
            scene.palette_lut.shape[0])
    return args, dict(shear=aux["shear"]), aux["overflow"]


def oracle_inputs(pscene, scene, cfg, width, height, state, walked=None):
    """Walk every env (unless `walked` holds `walk`'s result, made with no
    active set) and assemble the `portal_jnp` configuration's kernel
    arguments: returns (B7's args, B8's args after its channels, shear
    (B,), overflow (B,) bool). B8's sky image is `_shade_portal`'s
    (`sky_image(window_rows=True)`). The JAX package takes no active set
    on this path, so B8 reads the dense global table on every level; a holeless
    level gets a full-size table of empty hole bytes (ceil(S1 / 8) rows
    of -128), never the TPU's (1, 128) stub, which B8 would read past."""
    H, W = height, width
    records, words, aux = walked or walk(pscene, scene, cfg, W, H,
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
    oracle = cfg.raster_backend == "portal_jnp"
    with trace.span("walk"):
        walked = walk(pscene, scene, cfg, width, height, int(cfg.portal_crossings), state,
                      active_segs=0 if oracle else active_segs(pscene, cfg))
    with trace.span("raster"):
        if oracle:
            cargs, sargs, shear, overflow = oracle_inputs(
                pscene, scene, cfg, width, height, state, walked)
            del walked
            ch = classify_alpha(*cargs, shear=shear)
            B = ch.shape[0]
            del cargs  # the records and words: B8 needs neither
            idx_f, cov_f = shade_portal(ch.reshape(B, 11, -1), *sargs, shear=shear)
            idx_f = idx_f.reshape(B, height, width)
            cov_f = cov_f.reshape(B, height, width)
            return idx_f.to(torch.uint8), cov_f > 0.5, overflow
        args, kw, overflow = fused_inputs(pscene, scene, cfg, width, height, state, walked)
        del walked
        return (*render_portal_fused(*args, **kw), overflow)


# Envs one run of a captured tick's fallback renders through the
# triangle path (render_frames_portal).
FALLBACK_ENVS = 32


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
    idx, cov, overflow = render_portal_zero_pitch(
        pscene, scene, cfg, state, width, height)
    if cfg.portal_pitch == "triangle":
        fall = (torch.abs(state.pitch) > PITCH_EPS) | overflow
    else:
        fall = overflow
    trace.count("overflow_envs", fall)
    with trace.span("fallback"):
        return _fallback(scene, cfg, state, width, height, fall, idx, cov)


def _fallback(scene, cfg, state, width, height, fall, idx, cov):
    """`idx`, `cov` with the envs `fall` marks rendered through the
    triangle path: by the WHILE node's blocks on the device, or the fallen
    envs alone after a host read."""
    from ..graphs import decides_on_device, device_while

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
