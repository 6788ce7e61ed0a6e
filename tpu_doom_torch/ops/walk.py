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
rows of the stable partition visible-first, their level row ids, the
env's count of visible rows and its overflow. Its plain version is
`render/portal.py:walk_table_ref`.

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

from .._build import check, load
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
    """W0 for CUDA tensors, its plain version for CPU tensors (arguments
    and outputs as `render.portal.walk_table_ref`: (table, p1, p2, ordv or
    None, overflow, n_vis or None)). The kernel copies the columns that
    depend on no env from the level's `walk_static` and computes the
    others."""
    if time.device.type == "cpu":
        from ..render.portal import walk_table_ref

        return walk_table_ref(pt, lights_f, objoff, time, right, fwd, o, p00, near,
                              far, sv, flats_w, walls_w, aligned)
    if time.device.type != "cuda":
        raise ValueError(f"walk_table: unsupported device {time.device}")
    B = time.shape[0]
    SD, S = pt["has_back"].shape[0], pt["p1"].shape[0]
    level = level_arrays(pt, aligned)
    dtypes = [torch.float32] + [dt for _, dt in LEVEL_ROWS]
    if (level[0].shape != (SD, len(STATIC_COLS)) or pt["p2"].shape != (S, 2)
            or pt["sprite_half"].shape != (SD - S,) or not 0 <= sv < SD
            or any(x.shape[0] != SD for (k, _), x in zip(LEVEL_ROWS, level[1:])
                   if k not in NOT_PER_ROW)
            or pt["hmin"].numel() != 1 or pt["hmax"].numel() != 1
            or objoff.dim() != 2 or objoff.shape[0] != B or lights_f.dim() != 2
            or lights_f.shape[0] != B
            or any(x.shape != (B, 2) for x in (right, fwd, o))):
        raise ValueError("walk_table: bad shapes")
    if (any(x.dtype != dt for x, dt in zip(level, dtypes))
            or any(x.dtype != torch.float32 for x in (lights_f, objoff, time, right,
                                                       fwd, o))):
        raise ValueError("walk_table: bad dtypes")
    level = [x.contiguous() for x in level]
    env = [x.contiguous() for x in (objoff, time, lights_f, right, fwd, o)]
    dev = time.device
    SDo = sv or SD
    table = torch.empty((B, SDo, TABLE_COLS), dtype=torch.float32, device=dev)
    p1, p2 = (torch.empty((B, SDo, 2), dtype=torch.float32, device=dev) for _ in range(2))
    ordv = torch.empty((B, sv), dtype=torch.int64, device=dev) if sv else None
    n_vis = torch.empty((B,), dtype=torch.int32, device=dev) if sv else None
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return table, p1, p2, ordv, overflow.fill_(False), n_vis
    ptrs = (ctypes.c_void_p * len(level))(*(x.data_ptr() for x in level))
    check(load().tdt_walk_table(
        ctypes.addressof(ptrs), len(level), *(x.data_ptr() for x in env),
        table.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        *(0 if x is None else x.data_ptr() for x in (ordv, n_vis)), overflow.data_ptr(),
        B, S, SD - S, objoff.shape[1], lights_f.shape[1], sv, f32(1.0 / p00),
        near, far, flats_w, walls_w, torch.cuda.current_stream(dev).cuda_stream,
    ), "walk_table")
    walk_table.launches += 1
    return table, p1, p2, ordv, overflow, n_vis


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
    """W1 for CUDA tensors, its plain version for CPU tensors (see
    `walk_cross_ref`). K must be at most KMAX on the card."""
    if p1.device.type == "cpu":
        return walk_cross_ref(p1, p2, o, d, table, cyw, row_shear, near, far, p11, H, K)
    if p1.device.type != "cuda":
        raise ValueError(f"walk_cross: unsupported device {p1.device}")
    B, SD, _ = p1.shape
    W = d.shape[1]
    C = table.shape[2]
    if not 1 <= K <= min(SD, KMAX):
        raise ValueError(f"walk_cross: K = {K} outside 1..min(SD = {SD}, {KMAX})")
    if (p2.shape != p1.shape or o.shape != (B, 2) or d.shape != (B, W, 2)
            or table.shape[:2] != (B, SD) or C < TABLE_COLS
            or cyw.shape != (B,) or row_shear.shape != (B,)):
        raise ValueError("walk_cross: bad shapes")
    ins = [x.contiguous() for x in (p1, p2, o, d, table, cyw, row_shear)]
    if any(x.dtype != torch.float32 for x in ins):
        raise ValueError("walk_cross: inputs must be float32")
    dev = p1.device
    f32 = dict(dtype=torch.float32, device=dev)
    t, uf, top, bot = (torch.empty((B, K, W), **f32) for _ in range(4))
    idx = torch.empty((B, K, W), dtype=torch.int32, device=dev)
    live = torch.empty((B, K, W), dtype=torch.bool, device=dev)
    mask = torch.zeros((B,), dtype=torch.int32, device=dev)
    if B == 0 or W == 0:
        return t, uf, idx, live, top, bot, mask
    check(load().tdt_walk_cross(
        *(x.data_ptr() for x in ins),
        *(x.data_ptr() for x in (t, uf, idx, live, top, bot, mask)),
        B, SD, C, W, K, near, far, p11, float(H),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "walk_cross")
    walk_cross.launches += 1
    return t, uf, idx, live, top, bot, mask


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
    """W2 for CUDA tensors, its plain version for CPU tensors (see
    `walk_records_ref`): from the table, or from B4's selection where sel
    is given (table may then be None)."""
    if t.device.type == "cpu":
        return walk_records_ref(t, uf, idx, live, top, bot, mask, overflow, table, aw,
                                cyw, row_shear, p11, H, kc, shift, sel)
    if t.device.type != "cuda":
        raise ValueError(f"walk_records: unsupported device {t.device}")
    B, K, W = t.shape
    src = table if sel is None else sel
    SD, C = (table.shape[1], table.shape[2]) if sel is None else (0, sel.shape[1])
    n_words = aw.shape[1]
    if not 1 <= K <= KMAX or kc < 0:
        raise ValueError(f"walk_records: K = {K}, kc = {kc}")
    if (any(x.shape != (B, K, W) for x in (uf, idx, live, top, bot))
            or mask.shape != (B,) or overflow.shape != (B,) or src.dim() != 3
            or src.shape[0] != B or C < TABLE_COLS
            or (sel is not None and sel.shape[2] != K * W)
            or aw.dim() != 2 or aw.shape[0] % 2
            or cyw.shape != (B,) or row_shear.shape != (B,)
            or (shift is not None and shift.shape[0] != B)):
        raise ValueError("walk_records: bad shapes")
    if ((idx.dtype, live.dtype, mask.dtype, overflow.dtype, aw.dtype)
            != (torch.int32, torch.bool, torch.int32, torch.bool, torch.int32)
            or any(x.dtype != torch.float32
                   for x in (t, uf, top, bot, src, cyw, row_shear))
            or (shift is not None and shift.dtype != torch.float32)):
        raise ValueError("walk_records: bad dtypes")
    ins = [x.contiguous() for x in (t, uf, idx, live, top, bot, mask, overflow)]
    src, aw, cyw, row_shear = (x.contiguous() for x in (src, aw, cyw, row_shear))
    if shift is not None:
        shift = shift.contiguous()
    dev = t.device
    ks = min(kc, K) if kc else K
    records = torch.empty((B, ks * RECORDS_PER_CROSSING, NCH, W), dtype=torch.float32,
                          device=dev)
    words = torch.empty((B, ks, n_words, W), dtype=torch.int32, device=dev)
    ovf = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0 or W == 0:
        return records, words, overflow.clone()
    check(load().tdt_walk_records(
        *(x.data_ptr() for x in ins),
        src.data_ptr() if sel is None else 0, 0 if sel is None else src.data_ptr(),
        aw.data_ptr(), cyw.data_ptr(), row_shear.data_ptr(),
        0 if shift is None else shift.data_ptr(),
        records.data_ptr(), words.data_ptr(), ovf.data_ptr(),
        B, SD, C, W, K, kc, n_words, aw.shape[0] // 2,
        0 if shift is None else shift.shape[1], p11, float(H),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "walk_records")
    walk_records.launches += 1
    return records, words, ovf


walk_records.launches = 0
