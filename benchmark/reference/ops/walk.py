"""The column walk's three kernels, W0, W1 and W2, each with its plain
PyTorch version.

None replaces a Pallas kernel: the JAX package's walk,
`tpu_doom/render/portal.py:_walk_env`, runs as XLA ops under `vmap`
inside the jitted render (a few loop fusions and one stable
multi-operand `lax.sort` carrying (t, u, id)). These are the port's own
kernels for that code.

W0 `walk_table` (csrc/walk_table.cu `walk_table_kernel`), per env: the
(B, S+D, 74) attribute table of the walk rows (segs, then sprites) and
their endpoints, and on big levels the visible-seg cull: the first SV
rows of the stable partition visible-first, their level row ids and the
env's overflow. Its plain version is `render/portal.py:walk_table_ref`.

W1 and W2, per env and screen column:

W1 `walk_cross` (csrc/walk.cu `walk_cross_kernel`): crosses the column's
ray with every walk row (segs, then sprite billboards), keeps the K
crossings of smallest (depth, row id), where an invalid crossing's depth
is BIG_T (the stable sort's first K: equal depths keep row order, and
the sentinel slots take the lowest invalid row ids), then runs the
vertical clip window front to back over them (the cummax / cummin
prefix). Outputs (B, K, W): depth t, u, row id, live, top, bot; and per
env the bit mask of crossings live in any column.

W2 `walk_records` (csrc/walk.cu `walk_records_kernel`): the crossing
compaction (the first `kc` crossings live in any column, from W1's
mask), then per kept crossing the five span records (B, kc * 5, 16, W)
and the masked family's alpha words (B, kc, n_words, W), and the env's
overflow. It reads each crossing's attributes from the attribute table
at the crossing's row, or, given kernel B4's selection of them (the
big-level walk without compaction), from that: the same values.

The plain versions are the port's eager walk, factored out unchanged:
`render/portal.py:walk` calls the wrappers on every level, which run the
plain version for CPU tensors and launch the kernel (or raise) for CUDA
tensors. `build_records`, `alpha_words` and `shifted_cb` are W2's plain
version's parts.
"""

from __future__ import annotations

import ctypes

import torch

from .._numerics import f32, to_i32

BIG_T = 1e30  # finite depth sentinel for invalid crossings
SMALL_LEVEL_ROWS = 192  # S+D walk rows of a small level (no cull, AUTO compaction 8)
KMAX = 32  # crossings per column W1 keeps at most (its mask is 32 bits)

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
TABLE_COLS = PIECE0 + 3 * PIECE_C
(P_EXISTS, P_MASKED, P_LOW, P_HIGH, P_A, P_B, P_T1, P_T2, P_LIGHT, P_AB,
 P_EXMASK, P_CB, P_CID) = 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 14, 15
P_CLS = (P_EXISTS, P_MASKED, P_B, P_T1, P_T2, P_AB + 2, P_AB + 3, P_EXMASK, P_CID)
# The columns that depend on no env: the flags, the tile sizes, the
# texture rows, the pieces' u span and the cell ids. A level's
# `walk_static` (render/portal.py:_walk_static) holds them in this order,
# and W0 copies them (csrc/walk_table.cu kStaticCols).
STATIC_COLS = ([C_HB, C_FCS, C_FFS, C_BCS, C_BFS, C_CA + 2, C_CA + 3, C_FA + 2,
                C_FA + 3, C_SOLID, C_SPRITE, C_CCID, C_FCID]
               + [PIECE0 + pi * PIECE_C + j for pi in range(3) for j in P_CLS])
# The clip-window prefix's columns: has_back, the four row heights, solid.
PREFIX_COLS = [C_HB, C_CEILROW, C_FLOORROW, C_BCROW, C_BFROW, C_SOLID]
NEG, POS = -1e9, 1e9


def row_of(h, tt, cyw, shear, p11: float, H: int):
    """Screen row of height h at depth tt (the walk's projection)."""
    ndc_y = p11 * (h - cyw) / tt
    return H - (ndc_y + 1.0) * 0.5 * H + shear


def select_cols(table, cols, ix):
    """Attribute columns `cols` of table (B, S, C) (a slice, or a list
    stacked from views: an index list would be copied to the device on
    every call) at row ids ix (B, K, W) int64 -> (B, K, W, n)."""
    Bk, Kk, Wk = ix.shape
    sub = (table[:, :, cols] if isinstance(cols, slice)
           else torch.stack([table[:, :, c] for c in cols], dim=2))
    flat = ix.reshape(Bk, Kk * Wk, 1).expand(-1, -1, sub.shape[2])
    return torch.gather(sub, 1, flat).reshape(Bk, Kk, Wk, sub.shape[2])


def mask_bits(live):
    """(B, K, W) bool -> (B,) int32, bit k set where crossing k is live in
    any column (K <= 32)."""
    K = live.shape[1]
    bits = torch.arange(K, dtype=torch.int64, device=live.device)
    return (live.any(dim=2).to(torch.int64) << bits).sum(dim=1).to(torch.int32)


def mask_bits_to_bool(mask, K: int):
    """(B,) int32 mask -> (B, K) bool, bit k of each env."""
    bits = torch.arange(K, dtype=torch.int32, device=mask.device)
    return ((mask[:, None] >> bits) & 1) > 0


# ---------------------------------------------------------------------------
# W0: the attribute table and the visible-row cull.
# ---------------------------------------------------------------------------

# The level's row arrays W0 reads, in csrc/walk_table.cu's `Level` order
# after walk_static: (key, dtype); "cbase" keys take the layout's suffix.
LEVEL_ROWS = (
    ("f_ceil", torch.float32), ("f_floor", torch.float32),
    ("b_ceil", torch.float32), ("b_floor", torch.float32),
    ("f_ceil_obj", torch.int32), ("f_floor_obj", torch.int32),
    ("b_ceil_obj", torch.int32), ("b_floor_obj", torch.int32),
    ("flat_light", torch.int32),
    ("ceil_atlas", torch.float32), ("floor_atlas", torch.float32),
    ("piece_low", torch.float32), ("piece_high", torch.float32),
    ("piece_s1", torch.float32), ("piece_scroll", torch.float32),
    ("piece_obj", torch.int32), ("piece_light", torch.int32),
    ("piece_atlas", torch.float32),
    ("ceil_cbase", torch.float32), ("floor_cbase", torch.float32),
    ("piece_cbase", torch.float32),
    ("p1", torch.float32), ("p2", torch.float32),
    ("sprite_center", torch.float32), ("sprite_half", torch.float32),
    ("hmin", torch.float32), ("hmax", torch.float32),
)
NOT_PER_ROW = ("p1", "p2", "sprite_center", "sprite_half", "hmin", "hmax")


def level_arrays(pt, aligned: bool) -> list:
    """The level arrays W0 reads from the portal scene `pt`: walk_static,
    then LEVEL_ROWS' (the texel bases of the aligned layout where
    `aligned`)."""
    sfx = "_al" if aligned else ""
    return [pt["walk_static"]] + [pt[k + sfx if k.endswith("cbase") else k]
                                  for k, _ in LEVEL_ROWS]


def walk_table(pt, lights_f, objoff, time, right, fwd, o, p00: float, near: float,
               far: float, sv: int, flats_w: float, walls_w: float, aligned: bool):
    """The plain version of W0, on any device (arguments
    and outputs as `render.portal.walk_table_ref`: (table, p1, p2, ordv or
    None, overflow)). The kernel copies the columns that depend on no env
    from the level's `walk_static` and computes the others."""
    from ..render.portal import walk_table_ref

    return walk_table_ref(pt, lights_f, objoff, time, right, fwd, o, p00, near,
                          far, sv, flats_w, walls_w, aligned)


walk_table.launches = 0


# ---------------------------------------------------------------------------
# W1: crossings, K-nearest selection, clip window.
# ---------------------------------------------------------------------------


def crossings(p1, p2, o, d, near: float, far: float):
    """Every column's ray against every walk row -> (td, u) (B, W, SD):
    the depth, BIG_T where the crossing is invalid (parallel, back-facing,
    outside (near, far) or off the row), and the row parameter u."""
    e = p2 - p1
    po = p1 - o[:, None, :]
    d0, d1 = d[:, :, None, 0], d[:, :, None, 1]
    e0, e1 = e[:, None, :, 0], e[:, None, :, 1]
    po0, po1 = po[:, None, :, 0], po[:, None, :, 1]
    denom = d0 * e1 - d1 * e0
    safe = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    t = (po0 * e1 - po1 * e0) / safe
    u = (po0 * d1 - po1 * d0) / safe
    valid = ((torch.abs(denom) >= 1e-12) & (denom > 0.0) & (t > near)
             & (t < far) & (u >= 0.0) & (u <= 1.0))
    return torch.where(valid, t, BIG_T), u


def walk_cross_ref(p1, p2, o, d, table, cyw, row_shear, near: float, far: float,
                   p11: float, H: int, K: int):
    """Plain version of W1: p1, p2 (B, SD, 2) row endpoints, o (B, 2) the
    camera's xz, d (B, W, 2) the ray directions, table (B, SD, C) the
    attribute table (its PREFIX_COLS), cyw and row_shear (B,) -> (t, uf,
    idx i32, live bool, top, bot) each (B, K, W) and mask (B,) i32."""
    td, u = crossings(p1, p2, o, d, near, far)
    # Stable sort: equal depths keep seg-id order.
    td_s, order = torch.sort(td, dim=2, stable=True)
    order = order[:, :, :K]
    idx = order.transpose(1, 2)  # (B, K, W)
    t = td_s[:, :, :K].transpose(1, 2)
    uf = torch.gather(u, 2, order).transpose(1, 2)

    valid = t < BIG_T / 10.0
    safe_t = torch.where(valid, t, 1.0)
    cyw3, shear3 = cyw[:, None, None], row_shear[:, None, None]
    sv = select_cols(table, PREFIX_COLS, idx)
    pre = [sv[..., j] for j in range(len(PREFIX_COLS))]
    hb_p = pre[0] > 0.5
    solid_p = pre[5] > 0.5
    r_fc_p, r_ff_p, row_bc, row_bf = (row_of(pre[j], safe_t, cyw3, shear3, p11, H)
                                      for j in (1, 2, 3, 4))

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
    return t, uf, idx.to(torch.int32), live, top, bot, mask_bits(live)


def walk_cross(p1, p2, o, d, table, cyw, row_shear, near: float, far: float,
               p11: float, H: int, K: int):
    """The plain version of W1, on any device (see
    `walk_cross_ref`). K must be at most KMAX on the card."""
    return walk_cross_ref(p1, p2, o, d, table, cyw, row_shear, near, far, p11, H, K)


walk_cross.launches = 0


# ---------------------------------------------------------------------------
# The records and alpha words of crossings (W2's plain version).
# ---------------------------------------------------------------------------


def build_records(col, t, uf, live, top, bot, cyw, row_shear, p11: float, H: int,
                  remap_cb):
    """The five span records of every crossing -> (B, K * 5, 16, W).
    `col(c)` is table column c at each crossing (B, K, W); t, uf, live,
    top, bot (B, K, W) the crossings' depth, u, liveness and clip window;
    `remap_cb(cbase, cell_id)` the texel base in the table B2 reads."""
    B, K, W = t.shape
    valid = t < BIG_T / 10.0
    safe_t = torch.where(valid, t, 1.0)
    cyw3, shear3 = cyw[:, None, None], row_shear[:, None, None]

    def row(h):
        return row_of(h, safe_t, cyw3, shear3, p11, H)

    hb = col(C_HB) > 0.5
    solid = col(C_SOLID) > 0.5
    sprite = col(C_SPRITE) > 0.5
    fc, ff = col(C_FC), col(C_FF)
    fcs, ffs = col(C_FCS) > 0.5, col(C_FFS) > 0.5
    bcs, bfs = col(C_BCS) > 0.5, col(C_BFS) > 0.5
    light_flat = col(C_LFLAT)
    r_fc = row(col(C_CEILROW))
    r_ff = row(col(C_FLOORROW))
    top1 = torch.where(solid, torch.maximum(top, r_fc), top)
    bot1 = torch.where(solid, torch.minimum(bot, r_ff), bot)

    recs = []
    zero = torch.zeros((B, K, W), dtype=torch.float32, device=t.device)

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
        recs.append(torch.stack(ch, dim=2))  # (B, K, NCH, W)

    # Ceiling span, with the sky band at sky -> non-sky boundaries folded in.
    band_c = fcs & (~hb | ~bcs)
    rec(top,
        torch.where(band_c, torch.minimum(bot1, row(fc)), torch.minimum(bot, r_fc)),
        torch.where(fcs, KIND_SKY, KIND_FLAT),
        p0=col(C_CEILROW), ab=tuple(col(C_CA + j) for j in range(4)),
        light=light_flat, cbase=remap_cb(col(C_CCB), col(C_CCID)), ok=live & solid)
    # Floor span, with its sky band.
    band_f = ffs & (~hb | ~bfs)
    rec(torch.where(band_f, torch.maximum(top1, row(ff)), torch.maximum(top, r_ff)),
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
        rec(torch.maximum(top1, row(phigh)), torch.minimum(bot1, row(plow)),
            kind, p0=uu, ab=tuple(col(c0 + P_AB + j) for j in range(4)),
            light=col(c0 + P_LIGHT), w=t, t1=col(c0 + P_T1), t2=col(c0 + P_T2),
            low=plow, high=phigh, masked=masked.to(torch.float32),
            cbase=remap_cb(col(c0 + P_CB), col(c0 + P_CID)), ok=live & pe)
    return torch.stack(recs, dim=2).reshape(B, K * RECORDS_PER_CROSSING, NCH, W)


def alpha_words(col, uf, aw):
    """The masked family's alpha words: one texture column per crossing
    and screen column -> (B, K, n_words, W) i32 from aw (2 * wc, n_words)."""
    c0m = PIECE0 + PIECE_C
    sprite = col(C_SPRITE) > 0.5
    uu_m = col(c0m + P_A) + col(c0m + P_B) * uf
    tsx_m, ax_m = col(c0m + P_AB + 2), col(c0m + P_AB)
    wc = aw.shape[0] // 2
    u1 = torch.remainder(uu_m, torch.where(tsx_m == 0.0, 1.0, tsx_m)) + ax_m
    x_t = torch.remainder(to_i32(torch.floor(u1)), wc)
    col_idx = x_t + torch.where(sprite, wc, 0)
    return aw[col_idx.long()].permute(0, 1, 3, 2).contiguous()


def shifted_cb(shift):
    """remap_cb for `build_records`: the texel base as it is, or, with
    shift (B, n_cells) on the active-set path, moved into the env's
    active table (cell id < 0 -> 0, else cbase + shift[env, cell id])."""
    if shift is None:
        return lambda cb, cid: cb
    B, n_cells = shift.shape

    def remap_cb(cb, cid):
        ci = cid.to(torch.int64).clamp(0, n_cells - 1)
        s = torch.gather(shift, 1, ci.reshape(B, -1)).reshape(ci.shape)
        return torch.where(cid < 0.0, 0.0, cb + s)

    return remap_cb


def compact_order(mask, K: int, kc: int):
    """The crossings compaction keeps -> (B, min(kc, K)) int64: those live
    in any column (bits of mask) in K order, then the rest."""
    live_k = mask_bits_to_bool(mask, K)
    return torch.sort((~live_k).to(torch.int32), dim=1, stable=True).indices[:, :kc]


# ---------------------------------------------------------------------------
# W2: compaction, records, alpha words (every level).
# ---------------------------------------------------------------------------


def walk_records_ref(t, uf, idx, live, top, bot, mask, overflow, table, aw, cyw,
                     row_shear, p11: float, H: int, kc: int, shift=None, sel=None):
    """Plain version of W2: W1's outputs (t, uf, idx, live, top, bot (B,
    K, W), mask (B,)), the incoming overflow (B,) bool, the crossings'
    attributes, the alpha columns aw (2 * wc, n_words) i32, cyw and
    row_shear (B,) -> (records (B, K' * 5, 16, W), words (B, K', n_words,
    W) i32, overflow (B,) bool). The attributes come from the table (B,
    SD, C) at row idx, or, given sel (B, C, K * W), from B4's selection
    of them (crossing (k, w)'s column c at sel[b, c, k * W + w]; table is
    then not read): the same values either way. kc > 0 compacts to the
    first kc crossings live in any column (K' = min(kc, K)), and an env
    with more such crossings overflows; kc = 0 keeps all K. shift (B,
    n_cells), on the active-set path, moves each texel base into the
    env's active table: cid < 0 -> 0, else cbase + shift[cid]."""
    B, K, W = t.shape
    ordk = None
    if kc:
        live_k = mask_bits_to_bool(mask, K)
        overflow = overflow | (live_k.sum(dim=1) > kc)
        ordk = compact_order(mask, K, kc)
        g = ordk[:, :, None].expand(-1, -1, W)
        t, uf, idx, live, top, bot = (torch.gather(x, 1, g)
                                      for x in (t, uf, idx, live, top, bot))
    if sel is None:
        vals = select_cols(table, slice(None), idx.long())  # (B, K', W, C)

        def col(c):
            return vals[..., c]
    else:
        C = sel.shape[1]
        vals = sel.reshape(B, C, K, W)
        if ordk is not None:
            vals = torch.gather(vals, 2, ordk[:, None, :, None].expand(-1, C, -1, W))

        def col(c):
            return vals[:, c]

    records = build_records(col, t, uf, live, top, bot, cyw, row_shear, p11, H,
                            shifted_cb(shift))
    return records, alpha_words(col, uf, aw), overflow


def walk_records(t, uf, idx, live, top, bot, mask, overflow, table, aw, cyw,
                 row_shear, p11: float, H: int, kc: int, shift=None, sel=None):
    """The plain version of W2, on any device (see
    `walk_records_ref`): from the table, or from B4's selection where sel
    is given (table may then be None)."""
    return walk_records_ref(t, uf, idx, live, top, bot, mask, overflow, table, aw,
                            cyw, row_shear, p11, H, kc, shift, sel)


walk_records.launches = 0
