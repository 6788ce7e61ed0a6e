"""Kernels B2 (fused portal classify + shade) and B3 (depth peel +
resolve), each with its plain PyTorch version.

B2 replaces `tpu_doom/ops/raster_pallas.py:render_portal_fused_pallas`
(kernel `_render_fused_kernel`). Per pixel it takes the first span record
whose rows cover it (masked-family records only where their texel alpha
bit is set), then shades: flat/wall texel coordinates, the compact texel
table `tex[lin] + 128`, the transparency bit from `hole_bytes[lin >> 3]`,
the colormap row from light and distance, and the per-env sky image.
The TPU kernel's one-hot MXU lookups, SMEM gating plans, per-tile hole
gate and 128-lane padding only skip work or serve the TPU's layout; here
they are indexed loads, which changes no output.
CUDA design (csrc/render_portal.cu): one thread per pixel, 32x8 pixel
blocks over (column tile, row tile, env); records are read from global
memory with columns on adjacent threads (coalesced, and the 8 rows of a
block share them through L1); the three tables (68 KB + 8.6 KB + 8 KB on
`:test:`) are read through the read-only cache. Bound: the per-pixel
walk over up to 40 records; a 256-env frame's records are 210 MB of
device memory, which the 8 rows of a block re-read from L1.

B3 replaces `raster_pallas.py:peel_resolve_pallas` (kernel
`_peel_resolve_kernel`). K-layer depth peel over y-sorted triangles with
lexicographic (z, draw-order id) ties, skipping triangle chunks whose
window-y bounds miss the pixel tile, then the winner's interpolated
uv / w and flat attributes. The resolve is a direct load of the winning
row (the TPU kernel's one-hot matmul sums the row with zeros, which
`+ 0.0` reproduces).
CUDA design (csrc/peel_resolve.cu): one block per (pixel tile, env), one
thread per pixel; each overlapping chunk's rows are staged in shared
memory; per-pixel (z, id, position) of the running best stay in
registers. Bound: T x P coverage tests per layer (compute).

B4, B5 and B6 serve the big-level walk (render/portal.py):
B4 `select_rows` replaces `raster_pallas.py:select_rows_pallas`, the exact
row select of the per-seg attribute table at every crossing (the TPU's
3-way bf16 split and in-VMEM one-hot are a direct load here, csrc/
select_rows.cu); B6 `scatter_live` replaces `scatter_live_pallas`, the
per-seg count of live crossings (a shared-memory histogram, csrc/
scatter_live.cu); B5 `gather_cells` replaces `gather_cells_pallas`, the
copy of each env's visible texture cells into its active texel table
(one block per cell and env, 16-byte copies, csrc/gather_cells.cu).
B2 reads those per-env tables in its per-env mode.

Every wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, counting launches in `wrapper.launches`.
"""

from __future__ import annotations

import torch

from .._build import check, load
from .._numerics import div, f32, rdiv, to_i32

INF = float("inf")
BIG_ID = 2**30
ROWS_COLS = 24
ATTR_COLS = 16
OUT_CHANNELS = 16
RECORDS_PER_CROSSING = 5
MASKED_FAMILY = 3
NCH = 16


# ---------------------------------------------------------------------------
# B2: fused portal classify + shade.
# ---------------------------------------------------------------------------


def render_portal_fused_ref(records, words, cam, hc: int, dxz, sky_img,
                            tex, hole_bytes, cmap_i8, height: int,
                            p11: float, n_rows: int, shear=None):
    """Plain version of B2.

    records (B, R, 16, W) f32; words (B, K, n_words, W) i32; cam (B, 3);
    dxz (B, 2, W); sky_img (B, H, W) f32; tex either the global compact
    table (S1, 128) s8 (texel - 128), with hole_bytes (Sh, 128) s8 or
    None for a holeless level, or the per-env active tables (B, S1, 128)
    i16 (texel 0..255, 256 = hole; hole_bytes unused); cmap_i8 (S2, 128)
    s8; shear (B,) or None. Returns (palette index, covered), each
    (B, H, W) f32."""
    B, R, _, W = records.shape
    H = height
    dev = records.device
    p11 = f32(p11)
    n_words = words.shape[2]
    per_env = tex.dim() == 3
    S1 = tex.shape[1] if per_env else tex.shape[0]
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    y = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    cam_x = cam[:, 0, None, None]
    cam_y = cam[:, 1, None, None]
    cam_z = cam[:, 2, None, None]
    ndc_y = 1.0 - div(2.0 * y, float(H)) + shear[:, None, None]  # (B, H, 1)

    done = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    win = torch.full((B, H, W), -1, dtype=torch.int64, device=dev)
    for r in range(R):
        rec = records[:, r, :, None, :]  # (B, 16, 1, W)
        hit = ~done & (y >= rec[:, 0]) & (y < rec[:, 1])
        if r % RECORDS_PER_CROSSING == MASKED_FAMILY:
            w_ch, t1, t2 = rec[:, 8], rec[:, 9], rec[:, 10]
            low, high, tsy, ay = rec[:, 11], rec[:, 12], rec[:, 5], rec[:, 15]
            masked = rec[:, 13] > 0.5
            h_at = cam_y + div(ndc_y * w_ch, p11)
            dh = high - low
            dh = torch.where(dh == 0.0, 1.0, dh)
            v = t1 + (t2 - t1) * (h_at - low) / dh
            vv = torch.remainder(v, torch.where(tsy == 0.0, 1.0, tsy)) + ay
            y_t = torch.remainder(to_i32(torch.floor(vv)), hc)
            wi = y_t >> 5
            bit = y_t & 31
            k = r // RECORDS_PER_CROSSING
            wk = words[:, k, :, None, :].expand(B, n_words, H, W)
            wsel = torch.gather(
                wk, 1, wi.clamp(0, n_words - 1).long()[:, None]
            )[:, 0]
            wsel = torch.where(wi < n_words, wsel, 0)
            alpha = ((wsel >> bit) & 1) == 1
            hit = hit & (~masked | alpha)
        win = torch.where(hit, r, win)
        done = done | hit

    # The first match's channels [2:13): kind p0 tsx tsy cbase light w t1
    # t2 low high; zero where nothing matched.
    src = records[:, :, 2:13, :].permute(0, 2, 1, 3)  # (B, 11, R, W)
    sel = torch.gather(src, 2, win.clamp_min(0)[:, None].expand(B, 11, H, W))
    ch = torch.where((win >= 0)[:, None], sel, 0.0)

    kind = ch[:, 0]
    covered0 = kind != 0.0
    is_sky = kind == 3.0
    is_wall = kind == 2.0
    is_decor = kind == 4.0
    wall_like = is_wall | is_decor
    dx = dxz[:, 0, None, :]
    dz = dxz[:, 1, None, :]

    plane_h = ch[:, 1]
    safe_ndc = torch.where(torch.abs(ndc_y) < 1e-9, 1e-9, ndc_y)
    t_flat = p11 * (plane_h - cam_y) / safe_ndc
    flat_u = -(cam_x + dx * t_flat) * 100.0
    flat_v = -(cam_z + dz * t_flat) * 100.0
    h_at = cam_y + div(ndc_y * ch[:, 6], p11)
    dh = ch[:, 10] - ch[:, 9]
    dh = torch.where(dh == 0.0, 1.0, dh)
    wall_v = ch[:, 7] + (ch[:, 8] - ch[:, 7]) * (h_at - ch[:, 9]) / dh
    uu = torch.where(wall_like, ch[:, 1], flat_u)
    vv = torch.where(wall_like, wall_v, flat_v)
    ts_x = torch.where(ch[:, 2] == 0.0, 1.0, ch[:, 2])
    ts_y = torch.where(ch[:, 3] == 0.0, 1.0, ch[:, 3])
    lx = torch.floor(torch.remainder(uu, ts_x))
    ly = torch.floor(torch.remainder(vv, ts_y))
    lin = to_i32(ch[:, 4] + ly * (ch[:, 2] + 1.0) + lx).clamp(0, S1 * 128 - 1)

    w_pix = torch.where(wall_like | (is_sky & (ch[:, 6] > 0.0)), ch[:, 6], t_flat)
    light = ch[:, 5]
    dist_s = torch.clamp_max(1.0 - rdiv(0.9, w_pix + 0.9), 1.0)
    dist_d = torch.clamp_max(1.0 - rdiv(1.0, w_pix + 1.0), 1.0)
    lval = torch.where(
        is_decor, torch.minimum(light, light * 2.0 - dist_d), light * 2.0 - dist_s
    )
    crow = to_i32(torch.floor((1.0 - lval) * float(n_rows))).clamp(0, n_rows - 1)

    lin_l = lin.long()
    if per_env:
        v = torch.gather(tex.reshape(B, -1).to(torch.int32), 1,
                         lin_l.reshape(B, -1)).reshape(B, H, W)
        hole = v == 256
        v1 = torch.clamp_max(v, 255)
    else:
        v1 = tex.reshape(-1).to(torch.int32)[lin_l] + 128
        if hole_bytes is None:
            hole = torch.zeros_like(covered0)
        else:
            hbyte = hole_bytes.reshape(-1).to(torch.int32)[lin_l >> 3] + 128
            hole = ((hbyte >> (lin & 7)) & 1) == 1
    v2 = (cmap_i8.reshape(-1).to(torch.int32)[(crow * 256 + v1).long()] + 128).float()
    covered = covered0 & (is_sky | ~hole)
    val = torch.where(is_sky, sky_img, v2)
    return torch.where(covered, val, 0.0), covered.float()


def render_portal_fused(records, words, cam, hc: int, dxz, sky_img, tex,
                        hole_bytes, cmap_i8, height: int, p11: float,
                        n_rows: int, shear=None):
    """Kernel B2 for CUDA tensors, its plain version for CPU tensors
    (arguments as `render_portal_fused_ref`). Per-env tables may be a
    row slice of a bigger buffer (`gather_cells` output): the kernel
    takes their env stride."""
    if records.device.type == "cpu":
        return render_portal_fused_ref(
            records, words, cam, hc, dxz, sky_img, tex, hole_bytes,
            cmap_i8, height, p11, n_rows, shear)
    if records.device.type != "cuda":
        raise ValueError(f"render_portal_fused: unsupported device {records.device}")
    B, R, nch, W = records.shape
    H = int(height)
    K, n_words = words.shape[1], words.shape[2]
    per_env = tex.dim() == 3
    if (nch != NCH or R != K * RECORDS_PER_CROSSING or words.shape != (B, K, n_words, W)
            or cam.shape != (B, 3) or dxz.shape != (B, 2, W)
            or sky_img.shape != (B, H, W) or tex.shape[-1] != 128
            or (per_env and tex.shape[0] != B) or cmap_i8.shape[1] != 128):
        raise ValueError("render_portal_fused: bad shapes")
    tex_dtype = torch.int16 if per_env else torch.int8
    if (records.dtype, words.dtype, tex.dtype, cmap_i8.dtype) != (
            torch.float32, torch.int32, tex_dtype, torch.int8):
        raise ValueError("render_portal_fused: bad dtypes")
    dev = records.device
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (records, words, cam.float(), shear.float(),
                                     dxz.float(), sky_img.float())]
    if per_env:
        if tex.stride(2) != 1 or tex.stride(1) != 128:
            tex = tex.contiguous()
        S1, tex_stride = tex.shape[1], tex.stride(0)
    else:
        tex = tex.contiguous()
        S1, tex_stride = tex.shape[0], 0
    holeless = per_env or hole_bytes is None
    hole = (torch.zeros((1, 128), dtype=torch.int8, device=dev) if holeless
            else hole_bytes.contiguous())
    cmap = cmap_i8.contiguous()
    idx = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    cov = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    lib = load()
    check(lib.tdt_render_portal(
        *[t.data_ptr() for t in args], tex.data_ptr(), hole.data_ptr(),
        cmap.data_ptr(), idx.data_ptr(), cov.data_ptr(), B, R, W, H, n_words,
        int(hc), S1, int(holeless), int(per_env), tex_stride, f32(p11),
        int(n_rows), torch.cuda.current_stream(dev).cuda_stream,
    ), "render_portal_fused")
    render_portal_fused.launches += 1
    render_portal_fused.per_env_launches += int(per_env)
    return idx, cov


render_portal_fused.launches = 0
render_portal_fused.per_env_launches = 0  # of those, in the per-env mode


# ---------------------------------------------------------------------------
# B3: depth peel + resolve.
# ---------------------------------------------------------------------------


def _pad_peel_inputs(rows, attrs, grid, ybounds, tile_p, chunk_t):
    """Pad triangles to whole chunks (padded ones never overlap a tile)
    and pixels to whole tiles; returns padded inputs + (B, n_chunks, 2)
    chunk y-bounds, as `peel_resolve_pallas` does."""
    B, T, _ = rows.shape
    P = grid.shape[1]
    pad_t = (-T) % chunk_t
    if pad_t:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad_t))
        attrs = torch.nn.functional.pad(attrs, (0, 0, 0, pad_t))
        pad_b = torch.empty((B, pad_t, 2), dtype=ybounds.dtype, device=ybounds.device)
        pad_b[..., 0] = INF
        pad_b[..., 1] = -INF
        ybounds = torch.cat([ybounds, pad_b], dim=1)
    pad_p = (-P) % tile_p
    if pad_p:
        grid = torch.nn.functional.pad(grid, (0, pad_p))
    n_chunks = (T + pad_t) // chunk_t
    cb = ybounds.reshape(B, n_chunks, chunk_t, 2)
    chunk_bounds = torch.stack(
        [cb[..., 0].amin(dim=2), cb[..., 1].amax(dim=2)], dim=-1)
    return rows, attrs, grid, chunk_bounds


def peel_resolve_ref(rows, attrs, grid, ybounds, n_layers: int,
                     tile_p: int = 512, chunk_t: int = 128):
    """Plain version of B3. rows (B, T, 24), attrs (B, T, 16), grid
    (3, P), ybounds (B, T, 2) -> (B, K, 16, P) f32 channels
    [z, uvx, uvy, w, tsx, tsy, bax, bay, bbx, bby, light, pass,
    transparent, has, 0, 0]."""
    B, T, _ = rows.shape
    P = grid.shape[1]
    rows, attrs, grid, chunk_bounds = _pad_peel_inputs(
        rows, attrs, grid, ybounds, tile_p, chunk_t)
    Tp, Pp = rows.shape[1], grid.shape[1]
    dev = rows.device
    px, py = grid[0][None, :], grid[1][None, :]  # (1, Pp)
    pyt = grid[1].reshape(-1, tile_p)
    py_min = pyt.amin(dim=1) - 1.0
    py_max = pyt.amax(dim=1) + 1.0
    # (B, n_chunks, n_tiles): may this chunk cover a pixel of the tile?
    overlap = ((chunk_bounds[..., 0, None] <= py_max)
               & (chunk_bounds[..., 1, None] >= py_min))
    chunk_of_t = torch.arange(Tp, device=dev) // chunk_t
    tile_of_p = torch.arange(Pp, device=dev) // tile_p
    out = torch.zeros((B, n_layers, OUT_CHANNELS, Pp), dtype=torch.float32, device=dev)
    big = float(BIG_ID)
    for b in range(B):
        sub = rows[b][:, :, None]  # (Tp, 24, 1)
        consider = overlap[b][chunk_of_t][:, tile_of_p]  # (Tp, Pp)
        lam0 = sub[:, 0] * px + sub[:, 1] * py + sub[:, 2]
        lam1 = sub[:, 3] * px + sub[:, 4] * py + sub[:, 5]
        lam2 = sub[:, 6] * px + sub[:, 7] * py + sub[:, 8]
        z = sub[:, 9] * px + sub[:, 10] * py + sub[:, 11]
        slam = sub[:, 12] * px + sub[:, 13] * py + sub[:, 14]
        cover = (
            consider & (sub[:, 15] > 0.0) & (lam0 >= 0.0) & (lam1 >= 0.0)
            & (lam2 >= 0.0) & (slam > 0.0) & (z >= -1.0) & (z <= 1.0)
        )
        del lam0, lam1, lam2, slam, consider
        ids = rows[b][:, 22][:, None]  # (Tp, 1)
        prev_z = torch.full((Pp,), -INF, device=dev)
        prev_id = torch.full((Pp,), -1.0, device=dev)
        packed = torch.cat([rows[b], attrs[b]], dim=1)  # (Tp, 40)
        for layer in range(n_layers):
            after = (z > prev_z) | ((z == prev_z) & (ids > prev_id))
            ok = cover & after
            best_z = torch.where(ok, z, INF).amin(dim=0)
            best_id = torch.where(ok & (z == best_z), ids, big).amin(dim=0)
            has = best_id < big
            # Winner position (ids are unique among real triangles).
            match = ok & (z == best_z) & (ids == best_id)
            pos = torch.argmax(match.to(torch.uint8), dim=0)
            acc = torch.where(has[None, :], packed[pos].T, 0.0) + 0.0  # (40, Pp)
            slam_w = acc[12] * px[0] + acc[13] * py[0] + acc[14]
            safe_slam = torch.where(slam_w == 0.0, 1.0, slam_w)
            o = out[b, layer]
            o[0] = best_z
            o[1] = (acc[16] * px[0] + acc[17] * py[0] + acc[18]) / safe_slam
            o[2] = (acc[19] * px[0] + acc[20] * py[0] + acc[21]) / safe_slam
            o[3] = acc[ROWS_COLS + 9] / safe_slam
            o[4:11] = acc[ROWS_COLS:ROWS_COLS + 7]
            o[11] = acc[ROWS_COLS + 7]
            o[12] = acc[ROWS_COLS + 8]
            o[13] = has.float()
            prev_z, prev_id = best_z, best_id
    return out[..., :P]


def peel_resolve(rows, attrs, grid, ybounds, n_layers: int,
                 tile_p: int = 512, chunk_t: int = 128):
    """Kernel B3 for CUDA tensors, its plain version for CPU tensors."""
    if rows.device.type == "cpu":
        return peel_resolve_ref(rows, attrs, grid, ybounds, n_layers,
                                tile_p, chunk_t)
    if rows.device.type != "cuda":
        raise ValueError(f"peel_resolve: unsupported device {rows.device}")
    B, T, c = rows.shape
    P = grid.shape[1]
    if (c != ROWS_COLS or attrs.shape != (B, T, ATTR_COLS) or grid.shape[0] != 3
            or ybounds.shape != (B, T, 2)):
        raise ValueError("peel_resolve: bad shapes")
    if not (32 <= tile_p <= 1024 and tile_p % 32 == 0) or chunk_t < 1:
        raise ValueError("peel_resolve: tile_p must be a multiple of 32 in [32, 1024]")
    rows, attrs, grid, chunk_bounds = _pad_peel_inputs(
        rows.float(), attrs.float(), grid.float(), ybounds.float(), tile_p, chunk_t)
    rows, attrs, grid, chunk_bounds = (
        t.contiguous() for t in (rows, attrs, grid, chunk_bounds))
    out = torch.empty((B, n_layers, OUT_CHANNELS, P), dtype=torch.float32,
                      device=rows.device)
    lib = load()
    check(lib.tdt_peel_resolve(
        rows.data_ptr(), attrs.data_ptr(), grid.data_ptr(),
        chunk_bounds.data_ptr(), out.data_ptr(), B, rows.shape[1], P,
        grid.shape[1], int(n_layers), int(tile_p), int(chunk_t),
        torch.cuda.current_stream(rows.device).cuda_stream,
    ), "peel_resolve")
    peel_resolve.launches += 1
    return out


peel_resolve.launches = 0


# ---------------------------------------------------------------------------
# B4: exact row select (the big-level walk's attribute select).
# ---------------------------------------------------------------------------

SELECT_TILE_N = 64  # csrc/select_rows.cu kTileN
SMEM_LIMIT = 48 * 1024  # static shared-memory limit of a launch


def select_rows_ref(idx, tab):
    """Plain version of B4: idx (B, N) i32, tab (B, S, C) f32 -> (B, C, N)
    f32 with out[b, :, n] = tab[b, idx[b, n], :] (idx clamped to [0, S),
    as a JAX gather clamps). `+ 0.0` turns -0.0 into +0.0, as the TPU
    kernel's one-hot sum does."""
    B, S, C = tab.shape
    ix = idx.long().clamp(0, S - 1)
    rows = torch.gather(tab, 1, ix[:, :, None].expand(-1, -1, C))  # (B, N, C)
    return (rows + 0.0).transpose(1, 2).contiguous()


def select_rows(idx, tab):
    """Kernel B4 for CUDA tensors, its plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return select_rows_ref(idx, tab)
    if idx.device.type != "cuda":
        raise ValueError(f"select_rows: unsupported device {idx.device}")
    B, N = idx.shape
    if tab.dim() != 3 or tab.shape[0] != B or tab.shape[1] < 1:
        raise ValueError("select_rows: bad shapes")
    S, C = tab.shape[1], tab.shape[2]
    if SELECT_TILE_N * (C + 1) * 4 > SMEM_LIMIT:
        raise ValueError(f"select_rows: {C} columns exceed the kernel's tile")
    if (idx.dtype, tab.dtype) != (torch.int32, torch.float32):
        raise ValueError("select_rows: bad dtypes")
    idx, tab = idx.contiguous(), tab.contiguous()
    out = torch.empty((B, C, N), dtype=torch.float32, device=idx.device)
    if out.numel() == 0:
        return out
    check(load().tdt_select_rows(
        idx.data_ptr(), tab.data_ptr(), out.data_ptr(), B, N, S, C,
        torch.cuda.current_stream(idx.device).cuda_stream,
    ), "select_rows")
    select_rows.launches += 1
    return out


select_rows.launches = 0


# ---------------------------------------------------------------------------
# B6: seg-live counts (the active-set walk's scatter).
# ---------------------------------------------------------------------------


def scatter_live_ref(idx, live, S: int):
    """Plain version of B6: idx (B, N) i32, live (B, N) f32 -> (B, S) f32
    with cnt[b, s] = sum of live[b, n] over idx[b, n] == s; positions
    with idx outside [0, S) add nothing. The walk's live values are 0 or
    1, so the sums are exact integers in any order."""
    B = idx.shape[0]
    ok = (idx >= 0) & (idx < S)
    out = torch.zeros((B, S), dtype=torch.float32, device=idx.device)
    return out.scatter_add_(1, torch.where(ok, idx, 0).long(),
                            torch.where(ok, live, 0.0))


def scatter_live(idx, live, S: int):
    """Kernel B6 for CUDA tensors, its plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return scatter_live_ref(idx, live, S)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_live: unsupported device {idx.device}")
    B, N = idx.shape
    if live.shape != (B, N) or S < 1:
        raise ValueError("scatter_live: bad shapes")
    if (idx.dtype, live.dtype) != (torch.int32, torch.float32):
        raise ValueError("scatter_live: bad dtypes")
    idx, live = idx.contiguous(), live.contiguous()
    out = torch.zeros((B, S), dtype=torch.float32, device=idx.device)
    if B * N == 0:
        return out
    check(load().tdt_scatter_live(
        idx.data_ptr(), live.data_ptr(), out.data_ptr(), B, N, int(S),
        torch.cuda.current_stream(idx.device).cuda_stream,
    ), "scatter_live")
    scatter_live.launches += 1
    return out


scatter_live.launches = 0


# ---------------------------------------------------------------------------
# B5: active-set gather (per-env texel tables).
# ---------------------------------------------------------------------------

CELL_BLOCK_ROWS = 8  # meta counts 8-row blocks (the walk's slot unit)


def gather_cells_ref(meta, tex_full, act: int):
    """Plain version of B5: meta (B, C, 3) i32 [source block, slot block,
    block count] per cell in 8-row units, tex_full (S, 128) i16 ->
    (B, act, 128) i16, a row slice of an (act + 8)-row buffer. Rows no
    cell copies to are 0. A block whose source or destination would fall
    outside its buffer is skipped, as in the kernel."""
    B, C, _ = meta.shape
    dev = tex_full.device
    out_rows = act + CELL_BLOCK_ROWS
    out = torch.zeros((B, out_rows, 128), dtype=tex_full.dtype, device=dev)
    g, s, n = meta.long().unbind(-1)  # (B, C) each
    nmax = int(n.max()) if n.numel() else 0
    if nmax > 0:
        i = torch.arange(nmax, device=dev)
        src = g[..., None] + i  # (B, C, nmax) block ids
        dst = s[..., None] + i
        ok = ((i < n[..., None]) & (src >= 0)
              & (src < tex_full.shape[0] // CELL_BLOCK_ROWS)
              & (dst >= 0) & (dst < out_rows // CELL_BLOCK_ROWS))
        env = torch.arange(B, device=dev)[:, None, None].expand_as(src)[ok]
        r = torch.arange(CELL_BLOCK_ROWS, device=dev)
        src_rows = src[ok][:, None] * CELL_BLOCK_ROWS + r  # (M, 8)
        dst_rows = dst[ok][:, None] * CELL_BLOCK_ROWS + r
        out[env[:, None], dst_rows] = tex_full[src_rows]
    return out[:, :act]


def gather_cells(meta, tex_full, act: int):
    """Kernel B5 for CUDA tensors, its plain version for CPU tensors."""
    if meta.device.type == "cpu":
        return gather_cells_ref(meta, tex_full, act)
    if meta.device.type != "cuda":
        raise ValueError(f"gather_cells: unsupported device {meta.device}")
    B, C, three = meta.shape
    if three != 3 or tex_full.dim() != 2 or tex_full.shape[1] != 128 or act < 0:
        raise ValueError("gather_cells: bad shapes")
    if (meta.dtype, tex_full.dtype) != (torch.int32, torch.int16):
        raise ValueError("gather_cells: bad dtypes")
    meta, tex_full = meta.contiguous(), tex_full.contiguous()
    out_rows = act + CELL_BLOCK_ROWS
    out = torch.zeros((B, out_rows, 128), dtype=torch.int16, device=meta.device)
    if B * C == 0:
        return out[:, :act]
    check(load().tdt_gather_cells(
        meta.data_ptr(), tex_full.data_ptr(), out.data_ptr(), B, C,
        tex_full.shape[0], out_rows,
        torch.cuda.current_stream(meta.device).cuda_stream,
    ), "gather_cells")
    gather_cells.launches += 1
    return out[:, :act]


gather_cells.launches = 0
