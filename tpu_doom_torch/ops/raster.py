"""The renderer's kernels, B2-B9, each with its plain PyTorch version.

B2 replaces `tpu_doom/ops/raster_pallas.py:render_portal_fused_pallas`
(kernel `_render_fused_kernel`). Per pixel it takes the first span record
whose rows cover it (masked-family records only where their texel alpha
bit is set), then shades: flat/wall texel coordinates, the compact texel
table `tex[lin] + 128`, the transparency bit from `hole_bytes[lin >> 3]`,
the colormap row from light and distance, and on the sky the sky
texture at the pixel's texel row and column. The TPU kernel's one-hot MXU
lookups, SMEM gating plans, per-tile hole gate and 128-lane padding only
skip work or serve the TPU's layout; here they are indexed loads, which
changes no output. So is its sky image: the TPU kernel takes a (B, H, W)
f32 image (two row gathers made before it, as it cannot gather cheaply);
B2 takes the separable coordinates (sky_x (B, W), sky_y (B, H) i32) and
the u8 texture and reads one texel per sky pixel. It writes the frames'
own types, u8 indices and bool coverage: the TPU kernel's f32 outputs
after the casts the JAX package makes of them.
CUDA design (csrc/render_portal.cu): a block owns 32 columns of one env
over the whole height; it stages every record's span over those columns
once, as exact integer row ranges in shared memory, with each row's ndc
and sky row. H is split into bands of up to 96 rows (5 at 640x400, 3 at
320x200, one where H <= 96), and the block's warps walk and shade them
band after band on that one staging: each thread walks the records for 12
contiguous rows of one column at once, keeping each row's winner in a
byte, then shades its rows in turn: at each change of winner it loads the
record's 11 channels and computes what no row changes (a wall's texel
column and colormap row, the selects) into one ShadeRec, kept for the
rows that follow, and computes and reads only what each pixel's kind
uses; the three tables (68 KB + 8.6 KB + 8 KB on `:test:`) are read
through the read-only cache. It fits 40 registers (20 bytes spilled):
eight blocks of 192 threads per SM at 320x200, seven of 224 at 640x400;
shared memory 8.4 KB a block at 640x400 and 6.8 KB at 320x200 for R =
40, 16.8 KB at 320x200 for R = 120 (the rows' ndc and sky of up to 1,024
rows are staged at once; a taller image restages them). Bound: the shade
arithmetic and the walk (one test per record until the first that
covers). The kernel is a template over a mask of stages to switch off: B2
is <0>; the stage budget (tpu_doom_torch/tools/kernelbudget.py) launches
the others.

B3 replaces `raster_pallas.py:peel_resolve_pallas` (kernel
`_peel_resolve_kernel`). K-layer depth peel over y-sorted triangles with
lexicographic (z, draw-order id) ties, skipping triangle chunks whose
window-y bounds miss the pixel tile, then the winner's interpolated
uv / w and flat attributes. The resolve is a direct load of the winning
row (the TPU kernel's one-hot matmul sums the row with zeros, which
`+ 0.0` reproduces).
CUDA design (csrc/peel_resolve.cu, csrc/peel.cuh): a first launch
computes the window-y cull's bounds, a second lists the rows that may
cover each 64 x 64 bin; then one block per 32 x 8 pixel tile and env, one
thread per pixel, one sweep over its bin's rows for up to 8 layers: each
pixel keeps its K nearest (z, id, position) sorted in registers, which
are the iterative peel's K layers. Rows are culled per bin and tile
exactly (`_peel_may_cover` mirrors the test) and a tile's survivors
compacted into shared memory; each pixel also applies the plain version's
y-cull as the plain version does. Bound: the output bytes.

B4, B5 and B6 serve the big-level walk (render/portal.py):
B4 `select_rows` replaces `raster_pallas.py:select_rows_pallas`, the exact
row select of the per-seg attribute table at every crossing (the TPU's
3-way bf16 split and in-VMEM one-hot are a direct load here, csrc/
select_rows.cu: each index read once, the tile's rows staged in
swizzled shared memory, each output plane written as 512-byte runs of
16-byte streaming stores); B6 `scatter_live` replaces
`scatter_live_pallas`, the per-seg count of live crossings (a
shared-memory histogram fed one add per seg per warp, csrc/
scatter_live.cu); B5 `gather_cells`
replaces `gather_cells_pallas`, the copy of each env's visible texture
cells into its active texel table (one block per cell and env, 16-byte
copies, csrc/gather_cells.cu).
B2 reads those per-env tables in its per-env mode.

B7, B8 and B9 serve the JAX package's reference configurations, which
made the goldens the port is held to:
B7 `classify_alpha` replaces `raster_pallas.py:classify_alpha_pallas`
(B2's stage 1 alone, csrc/classify_alpha.cu) and B8 `shade_portal`
replaces `shade_portal_pallas` (B2's stage 2 alone over flattened
pixels, csrc/shade_portal.cu): `raster_backend="portal_jnp"` runs B7 then
B8 on every frame. B2, B7 and B8 share their device code
(csrc/portal_shade.cuh) and, here, `_classify` and `_shade_address`.
B9 `depth_peel` replaces `depth_peel_pallas` (B3's peel without the
resolve, ids by row position, csrc/depth_peel.cu on B3's core in
csrc/peel.cuh): the peel of
`raster_backend="jnp"`, which is also `portal_jnp`'s fallback.

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


def _classify(records, words, cam_y, hc: int, ndc_y, y, p11: float,
              done_on_kind: bool, alpha_test: bool = True):
    """First-match span classify (B2's stage 1 and B7): records (B, R,
    16, W), words (B, K, n_words, W), cam_y (B, 1, 1), ndc_y (B, H, 1),
    y (1, H, 1) -> (B, 11, H, W), the covering record's channels [2:13)
    (kind p0 tsx tsy cbase light w t1 t2 low high), zero where none
    covers. Masked-family records cover only where their texel alpha bit
    is set (anywhere in their rows with `alpha_test=False`, the stage budget's
    ablation). A pixel is done after its first covering record, or with
    `done_on_kind` (B7's rule) after the first one of non-zero kind."""
    B, R, _, W = records.shape
    H = y.shape[1]
    n_words = words.shape[2]
    done = torch.zeros((B, H, W), dtype=torch.bool, device=records.device)
    win = torch.full((B, H, W), -1, dtype=torch.int64, device=records.device)
    for r in range(R):
        rec = records[:, r, :, None, :]  # (B, 16, 1, W)
        hit = ~done & (y >= rec[:, 0]) & (y < rec[:, 1])
        if alpha_test and r % RECORDS_PER_CROSSING == MASKED_FAMILY:
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
        done = done | ((hit & (rec[:, 2] != 0.0)) if done_on_kind else hit)
    src = records[:, :, 2:13, :].permute(0, 2, 1, 3)  # (B, 11, R, W)
    sel = torch.gather(src, 2, win.clamp_min(0)[:, None].expand(B, 11, H, W))
    return torch.where((win >= 0)[:, None], sel, 0.0)


def _shade_address(ch, ndc_y, dx, dz, cam_x, cam_y, cam_z, p11: float,
                   n_rows: int, S1: int):
    """The shade's per-pixel terms (B2's stage 2 and B8) from classified
    channels ch (B, 11, ...), with ndc_y, dx, dz and the camera terms
    broadcasting against ch[:, 0]: (texel address lin in the compact
    table, colormap row crow, covered0, is_sky)."""
    kind = ch[:, 0]
    covered0 = kind != 0.0
    is_sky = kind == 3.0
    is_wall = kind == 2.0
    is_decor = kind == 4.0
    wall_like = is_wall | is_decor

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
    return lin, crow, covered0, is_sky


def _global_texel(tex, hole_bytes, lin):
    """Texel (0..255) and hole flag from the global compact table (S1,
    128) s8 (texel - 128) and its packed hole bits (Sh, 128) s8 (byte -
    128), or no holes when hole_bytes is None."""
    v1 = tex.reshape(-1).to(torch.int32)[lin.long()] + 128
    if hole_bytes is None:
        return v1, torch.zeros_like(v1, dtype=torch.bool)
    hbyte = hole_bytes.reshape(-1).to(torch.int32)[(lin >> 3).long()] + 128
    return v1, ((hbyte >> (lin & 7)) & 1) == 1


def _shade_out(v1, hole, crow, covered0, is_sky, sky, cmap_i8):
    """(palette index, covered) f32 from the texel, hole flag and row;
    cmap_i8 None takes the texel itself (the stage budget's ablation)."""
    if cmap_i8 is None:
        v2 = v1.float()
    else:
        v2 = (cmap_i8.reshape(-1).to(torch.int32)[(crow * 256 + v1).long()] + 128).float()
    covered = covered0 & (is_sky | ~hole)
    val = torch.where(is_sky, sky, v2)
    return torch.where(covered, val, 0.0), covered.float()


def _ndc_rows(H: int, device):
    """(1, H, 1) pixel-row centres y = j + 0.5 and their ndc 1 - 2y/H."""
    y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5)[None, :, None]
    return y, 1.0 - div(2.0 * y, float(H))


def sky_gather(sky_x, sky_y, sky_tex):
    """The sky image (B, H, W) f32 from its separable texel coordinates
    sky_x (B, W) and sky_y (B, H) and the colormapped sky texture (hs,
    ws): two row gathers."""
    H = sky_y.shape[1]
    rows = sky_tex.to(torch.float32)[sky_y.long()]  # (B, H, ws)
    return torch.gather(rows, 2, sky_x.long()[:, None, :].expand(-1, H, -1))


def render_portal_fused_ref(records, words, cam, hc: int, dxz, sky_x, sky_y,
                            sky_tex, tex, hole_bytes, cmap_i8, height: int,
                            p11: float, n_rows: int, shear=None):
    """Plain version of B2.

    records (B, R, 16, W) f32; words (B, K, n_words, W) i32; cam (B, 3);
    dxz (B, 2, W); the sky's texel column per image column sky_x (B, W)
    i32 and row per image row sky_y (B, H) i32, and the colormapped sky
    texture sky_tex (hs, ws) u8; tex either the global compact table (S1,
    128) s8 (texel - 128), with hole_bytes (Sh, 128) s8 or None for a
    holeless level, or the per-env active tables (B, S1, 128) i16 (texel
    0..255, 256 = hole; hole_bytes unused); cmap_i8 (S2, 128) s8; shear
    (B,) or None. Returns (palette index (B, H, W) u8, covered (B, H, W)
    bool): the JAX package's f32 outputs after its casts
    (`idx.astype(uint8)`, `cov > 0.5`)."""
    B = records.shape[0]
    dev = records.device
    p11 = f32(p11)
    per_env = tex.dim() == 3
    S1 = tex.shape[1] if per_env else tex.shape[0]
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    y, ndc0 = _ndc_rows(height, dev)
    ndc_y = ndc0 + shear[:, None, None]  # (B, H, 1)
    cam_x, cam_y, cam_z = (cam[:, i, None, None] for i in range(3))
    ch = _classify(records, words, cam_y, hc, ndc_y, y, p11, done_on_kind=False)
    lin, crow, covered0, is_sky = _shade_address(
        ch, ndc_y, dxz[:, 0, None, :], dxz[:, 1, None, :], cam_x, cam_y, cam_z,
        p11, n_rows, S1)
    if per_env:
        v = torch.gather(tex.reshape(B, -1).to(torch.int32), 1,
                         lin.long().reshape(B, -1)).reshape(lin.shape)
        hole = v == 256
        v1 = torch.clamp_max(v, 255)
    else:
        v1, hole = _global_texel(tex, hole_bytes, lin)
    idx, cov = _shade_out(v1, hole, crow, covered0, is_sky,
                          sky_gather(sky_x, sky_y, sky_tex), cmap_i8)
    return idx.to(torch.uint8), cov > 0.5


def check_sky(sky_x, sky_y, sky_tex, B: int, H: int, W: int, name: str):
    """Raise unless the sky operands are B2's: (B, W) and (B, H) i32
    coordinates and a 2-D u8 texture."""
    if (sky_x.shape != (B, W) or sky_y.shape != (B, H) or sky_tex.dim() != 2
            or (sky_x.dtype, sky_y.dtype, sky_tex.dtype)
            != (torch.int32, torch.int32, torch.uint8)):
        raise ValueError(f"{name}: the sky operands must be sky_x (B, W) i32, sky_y"
                         " (B, H) i32 and sky_tex (hs, ws) u8")


def render_portal_fused(records, words, cam, hc: int, dxz, sky_x, sky_y, sky_tex,
                        tex, hole_bytes, cmap_i8, height: int, p11: float,
                        n_rows: int, shear=None):
    """Kernel B2 for CUDA tensors, its plain version for CPU tensors
    (arguments as `render_portal_fused_ref`). Per-env tables may be a
    row slice of a bigger buffer (`gather_cells` output): the kernel
    takes their env stride."""
    if records.device.type == "cpu":
        return render_portal_fused_ref(
            records, words, cam, hc, dxz, sky_x, sky_y, sky_tex, tex, hole_bytes,
            cmap_i8, height, p11, n_rows, shear)
    if records.device.type != "cuda":
        raise ValueError(f"render_portal_fused: unsupported device {records.device}")
    B, R, nch, W = records.shape
    H = int(height)
    K, n_words = words.shape[1], words.shape[2]
    per_env = tex.dim() == 3
    if (nch != NCH or R != K * RECORDS_PER_CROSSING or words.shape != (B, K, n_words, W)
            or cam.shape != (B, 3) or dxz.shape != (B, 2, W)
            or tex.shape[-1] != 128
            or (per_env and tex.shape[0] != B) or cmap_i8.shape[1] != 128):
        raise ValueError("render_portal_fused: bad shapes")
    check_sky(sky_x, sky_y, sky_tex, B, H, W, "render_portal_fused")
    tex_dtype = torch.int16 if per_env else torch.int8
    if (records.dtype, words.dtype, tex.dtype, cmap_i8.dtype) != (
            torch.float32, torch.int32, tex_dtype, torch.int8):
        raise ValueError("render_portal_fused: bad dtypes")
    dev = records.device
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (records, words, cam.float(), shear.float(),
                                     dxz.float(), sky_x, sky_y, sky_tex)]
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
    idx = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    cov = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    lib = load()
    check(lib.tdt_render_portal(
        *[t.data_ptr() for t in args], tex.data_ptr(), hole.data_ptr(),
        cmap.data_ptr(), idx.data_ptr(), cov.data_ptr(), B, R, W, H, n_words,
        int(hc), sky_tex.shape[0], sky_tex.shape[1], S1, int(holeless), int(per_env),
        tex_stride, f32(p11), int(n_rows), torch.cuda.current_stream(dev).cuda_stream,
    ), "render_portal_fused")
    render_portal_fused.launches += 1
    render_portal_fused.per_env_launches += int(per_env)
    return idx, cov


render_portal_fused.launches = 0
render_portal_fused.per_env_launches = 0  # of those, in the per-env mode


# ---------------------------------------------------------------------------
# B7: classify alone; B8: shade alone (the `portal_jnp` configuration).
# ---------------------------------------------------------------------------


def classify_alpha_ref(records, words, cam_y, hc: int, height: int,
                       p11: float, shear=None):
    """Plain version of B7: records (B, R, 16, W) f32, words (B, K,
    n_words, W) i32, cam_y (B,), shear (B,) or None -> (B, 11, H, W) f32,
    the channels [2:13) of the first covering record of non-zero kind
    (a covering record of kind 0 stays until a later one covers), zero
    where no record covers."""
    B = records.shape[0]
    dev = records.device
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    y, ndc0 = _ndc_rows(height, dev)
    return _classify(records, words, cam_y[:, None, None], hc,
                     ndc0 + shear[:, None, None], y, f32(p11), done_on_kind=True)


def classify_alpha(records, words, cam_y, hc: int, height: int, p11: float,
                   shear=None):
    """Kernel B7 for CUDA tensors, its plain version for CPU tensors."""
    if records.device.type == "cpu":
        return classify_alpha_ref(records, words, cam_y, hc, height, p11, shear)
    if records.device.type != "cuda":
        raise ValueError(f"classify_alpha: unsupported device {records.device}")
    B, R, nch, W = records.shape
    H = int(height)
    K, n_words = words.shape[1], words.shape[2]
    if (nch != NCH or R != K * RECORDS_PER_CROSSING
            or words.shape != (B, K, n_words, W) or cam_y.shape != (B,)):
        raise ValueError("classify_alpha: bad shapes")
    if (records.dtype, words.dtype) != (torch.float32, torch.int32):
        raise ValueError("classify_alpha: bad dtypes")
    dev = records.device
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (records, words, cam_y.float(), shear.float())]
    out = torch.empty((B, 11, H, W), dtype=torch.float32, device=dev)
    check(load().tdt_classify_alpha(
        *[t.data_ptr() for t in args], out.data_ptr(), B, R, W, H, n_words,
        int(hc), f32(p11), torch.cuda.current_stream(dev).cuda_stream,
    ), "classify_alpha")
    classify_alpha.launches += 1
    return out


classify_alpha.launches = 0


def _check_hole_table(tex_i8, hole_bytes):
    """B8 reads hole byte lin >> 3 for every texel address lin < S1 * 128:
    the hole table must reach that far (the TPU kernel's lookup returns
    byte 128, a hole, past its end). A holeless level passes a table of
    ceil(S1 / 8) rows of -128."""
    if hole_bytes.shape[0] * 1024 < tex_i8.shape[0] * 128:
        raise ValueError(
            f"shade_portal: hole table of {hole_bytes.shape[0]} rows does not "
            f"cover a texel table of {tex_i8.shape[0]} rows (needs "
            f"{-(-tex_i8.shape[0] // 8)})")


def shade_portal_ref(ch, dxz, ndc_y, sky_img, cam, tex_i8, hole_bytes,
                     cmap_i8, p11: float, n_rows: int, shear=None):
    """Plain version of B8: ch (B, 11, P) classified channels, dxz (B, 2,
    P) per-pixel ray directions, ndc_y (1, P), sky_img (B, P), cam (B, 3),
    tex_i8 (S1, 128) s8, hole_bytes (Sh, 128) s8 with Sh >= S1 / 8,
    cmap_i8 (S2, 128) s8, shear (B,) or None (added to ndc_y) ->
    (palette index, covered), each (B, P) f32."""
    _check_hole_table(tex_i8, hole_bytes)
    B = ch.shape[0]
    p11 = f32(p11)
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=ch.device)
    ndc = ndc_y + shear[:, None]
    cam_x, cam_y, cam_z = (cam[:, i, None] for i in range(3))
    lin, crow, covered0, is_sky = _shade_address(
        ch, ndc, dxz[:, 0], dxz[:, 1], cam_x, cam_y, cam_z, p11, n_rows,
        tex_i8.shape[0])
    v1, hole = _global_texel(tex_i8, hole_bytes, lin)
    return _shade_out(v1, hole, crow, covered0, is_sky, sky_img, cmap_i8)


def shade_portal(ch, dxz, ndc_y, sky_img, cam, tex_i8, hole_bytes, cmap_i8,
                 p11: float, n_rows: int, shear=None):
    """Kernel B8 for CUDA tensors, its plain version for CPU tensors."""
    _check_hole_table(tex_i8, hole_bytes)
    if ch.device.type == "cpu":
        return shade_portal_ref(ch, dxz, ndc_y, sky_img, cam, tex_i8,
                                hole_bytes, cmap_i8, p11, n_rows, shear)
    if ch.device.type != "cuda":
        raise ValueError(f"shade_portal: unsupported device {ch.device}")
    B, c, P = ch.shape
    if (c != 11 or dxz.shape != (B, 2, P) or ndc_y.shape != (1, P)
            or sky_img.shape != (B, P) or cam.shape != (B, 3)
            or tex_i8.shape[1] != 128 or hole_bytes.shape[1] != 128
            or cmap_i8.shape[1] != 128):
        raise ValueError("shade_portal: bad shapes")
    if (tex_i8.dtype, hole_bytes.dtype, cmap_i8.dtype) != (torch.int8,) * 3:
        raise ValueError("shade_portal: bad dtypes")
    dev = ch.device
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (
        ch.float(), dxz.float(), ndc_y.float(), sky_img.float(), cam.float(),
        shear.float(), tex_i8, hole_bytes, cmap_i8)]
    idx = torch.empty((B, P), dtype=torch.float32, device=dev)
    cov = torch.empty((B, P), dtype=torch.float32, device=dev)
    check(load().tdt_shade_portal(
        *[t.data_ptr() for t in args], idx.data_ptr(), cov.data_ptr(), B, P,
        tex_i8.shape[0], f32(p11), int(n_rows),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "shade_portal")
    shade_portal.launches += 1
    return idx, cov


shade_portal.launches = 0


# ---------------------------------------------------------------------------
# B3: depth peel + resolve.
# ---------------------------------------------------------------------------

PEEL_TILE_W, PEEL_TILE_H = 32, 8  # csrc/peel.cuh kTileW, kTileH
PEEL_BIN = 64  # csrc/peel.cuh kBin


def _peel_cover(rows, px, py):
    """Coverage of every pixel by every triangle row (B3 and B9): rows
    (T, 16+) [e00..e22, zr, vs, valid, ...], px / py (1, P) -> (cover
    (T, P) bool, NDC depth z (T, P))."""
    sub = rows[:, :, None]  # (T, C, 1)
    lam0 = sub[:, 0] * px + sub[:, 1] * py + sub[:, 2]
    lam1 = sub[:, 3] * px + sub[:, 4] * py + sub[:, 5]
    lam2 = sub[:, 6] * px + sub[:, 7] * py + sub[:, 8]
    z = sub[:, 9] * px + sub[:, 10] * py + sub[:, 11]
    slam = sub[:, 12] * px + sub[:, 13] * py + sub[:, 14]
    cover = (
        (sub[:, 15] > 0.0) & (lam0 >= 0.0) & (lam1 >= 0.0)
        & (lam2 >= 0.0) & (slam > 0.0) & (z >= -1.0) & (z <= 1.0)
    )
    return cover, z


def _peel_may_cover(rows, boxes):
    """The kernels' tile cull (csrc/peel.cuh:may_cover), for the tests and
    chip_smoke: rows (T, 16+), boxes (N, 4) [x0, x1, y0, y1] bounding each
    tile's pixel centres -> (T, N) bool, False only where `_peel_cover` is
    False at every pixel centre in the box. Each affine term is taken at
    the corner where it is largest (least, for z's lower end); rounding is
    monotone, so no pixel of the box exceeds it."""
    s = rows[:, :, None]
    x0, x1, y0, y1 = (boxes[None, :, i] for i in range(4))

    def most(i):
        a, b = s[:, i], s[:, i + 1]
        return (a * torch.where(a >= 0.0, x1, x0) + b * torch.where(b >= 0.0, y1, y0)
                + s[:, i + 2])

    def least(i):
        a, b = s[:, i], s[:, i + 1]
        return (a * torch.where(a >= 0.0, x0, x1) + b * torch.where(b >= 0.0, y0, y1)
                + s[:, i + 2])

    return ((s[:, 15] > 0.0) & ~(most(0) < 0.0) & ~(most(3) < 0.0) & ~(most(6) < 0.0)
            & ~(most(12) <= 0.0) & ~(least(9) > 1.0) & ~(most(9) < -1.0))


def _peel_tile_boxes(grid, width: int, w: int = PEEL_TILE_W, h: int = PEEL_TILE_H):
    """The kernels' cull boxes: the image `width` pixels wide in row-major
    w x h tiles (csrc/peel.cuh:Image; a block's 32 x 8 tile, or a 64 x 64
    bin of the binning pass) -> (tile of each pixel (P,) int64, boxes
    (N, 4) [x0, x1, y0, y1] of each tile's pixel centres; inf / -inf for a
    tile that holds no pixel)."""
    P = grid.shape[1]
    p = torch.arange(P, device=grid.device)
    tiles_x, img_rows = -(-width // w), -(-P // width)
    n = tiles_x * -(-img_rows // h)
    tile = (p // width // h) * tiles_x + (p % width) // w
    inf = torch.full((n,), INF, dtype=grid.dtype, device=grid.device)
    lo = [inf.scatter_reduce(0, tile, grid[i], "amin") for i in (0, 1)]
    hi = [(-inf).scatter_reduce(0, tile, grid[i], "amax") for i in (0, 1)]
    return tile, torch.stack([lo[0], hi[0], lo[1], hi[1]], dim=1)


def _chunk_ybounds(ybounds, chunk_t: int):
    """(B, T, 2) window-y bounds -> (B, ceil(T / chunk_t), 2) [least ymin,
    largest ymax] of each chunk of chunk_t rows (the last chunk padded
    with rows that overlap no tile), as `peel_resolve_pallas` does."""
    B, T, _ = ybounds.shape
    pad_t = (-T) % chunk_t
    if pad_t:
        pad_b = torch.empty((B, pad_t, 2), dtype=ybounds.dtype, device=ybounds.device)
        pad_b[..., 0] = INF
        pad_b[..., 1] = -INF
        ybounds = torch.cat([ybounds, pad_b], dim=1)
    cb = ybounds.reshape(B, (T + pad_t) // chunk_t, chunk_t, 2)
    return torch.stack([cb[..., 0].amin(dim=2), cb[..., 1].amax(dim=2)], dim=-1)


def _tile_ybounds(grid, tile_p: int):
    """(ceil(P / tile_p), 2) [least py - 1, largest py + 1] of each run of
    tile_p pixels of the grid padded with zeros: the window-y range B3's
    y-cull gives the run's pixels."""
    pyt = torch.nn.functional.pad(grid[1], (0, (-grid.shape[1]) % tile_p))
    pyt = pyt.reshape(-1, tile_p)
    return torch.stack([pyt.amin(dim=1) - 1.0, pyt.amax(dim=1) + 1.0], dim=-1)


def peel_resolve_ref(rows, attrs, grid, ybounds, n_layers: int,
                     tile_p: int = 512, chunk_t: int = 128):
    """Plain version of B3. rows (B, T, 24), attrs (B, T, 16), grid
    (3, P), ybounds (B, T, 2) -> (B, K, 16, P) f32 channels
    [z, uvx, uvy, w, tsx, tsy, bax, bay, bbx, bby, light, pass,
    transparent, has, 0, 0]. A chunk of chunk_t rows is tested against a
    run of tile_p pixels only where their window-y bounds overlap."""
    B, T, _ = rows.shape
    P = grid.shape[1]
    chunk_bounds = _chunk_ybounds(ybounds, chunk_t)
    tile_bounds = _tile_ybounds(grid, tile_p)
    pad_t, pad_p = (-T) % chunk_t, (-P) % tile_p
    rows = torch.nn.functional.pad(rows, (0, 0, 0, pad_t))
    attrs = torch.nn.functional.pad(attrs, (0, 0, 0, pad_t))
    grid = torch.nn.functional.pad(grid, (0, pad_p))
    Tp, Pp = T + pad_t, P + pad_p
    dev = rows.device
    px, py = grid[0][None, :], grid[1][None, :]  # (1, Pp)
    # (B, n_chunks, n_tiles): may this chunk cover a pixel of the tile?
    overlap = ((chunk_bounds[..., 0, None] <= tile_bounds[:, 1])
               & (chunk_bounds[..., 1, None] >= tile_bounds[:, 0]))
    chunk_of_t = torch.arange(Tp, device=dev) // chunk_t
    tile_of_p = torch.arange(Pp, device=dev) // tile_p
    out = torch.zeros((B, n_layers, OUT_CHANNELS, Pp), dtype=torch.float32, device=dev)
    big = float(BIG_ID)
    for b in range(B):
        consider = overlap[b][chunk_of_t][:, tile_of_p]  # (Tp, Pp)
        cover, z = _peel_cover(rows[b], px, py)
        cover &= consider
        del consider
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


def _bin_scratch(B: int, T: int, P: int, width: int, device):
    """The binning pass's int scratch: per env and 64 x 64 bin a count, then
    per env and bin a list of up to T rows (csrc/peel.cuh:bin_kernel)."""
    img_rows = -(-P // width)
    bins = -(-width // PEEL_BIN) * -(-img_rows // PEEL_BIN)
    return torch.empty((B * bins * (T + 1),), dtype=torch.int32, device=device)


def _aligned16(t):
    """t, or a copy of it whose data starts on a 16-byte boundary (the
    kernels read rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def peel_resolve(rows, attrs, grid, ybounds, n_layers: int,
                 tile_p: int = 512, chunk_t: int = 128, *, width: int):
    """Kernel B3 for CUDA tensors, its plain version for CPU tensors.
    `width` is the image width of the grid's index map
    (render/raster.py:pixel_grid): it shapes the kernel's pixel tiles and
    never the result."""
    if rows.device.type == "cpu":
        return peel_resolve_ref(rows, attrs, grid, ybounds, n_layers,
                                tile_p, chunk_t)
    if rows.device.type != "cuda":
        raise ValueError(f"peel_resolve: unsupported device {rows.device}")
    B, T, c = rows.shape
    P = grid.shape[1]
    if (c != ROWS_COLS or attrs.shape != (B, T, ATTR_COLS) or grid.shape[0] != 3
            or ybounds.shape != (B, T, 2) or T < 1):
        raise ValueError("peel_resolve: bad shapes")
    if tile_p < 1 or chunk_t < 1 or n_layers < 1 or width < 1:
        raise ValueError("peel_resolve: tile_p, chunk_t, n_layers and width must be >= 1")
    rows = _aligned16(rows.float().contiguous())
    attrs, grid, ybounds = (t.float().contiguous() for t in (attrs, grid, ybounds))
    dev = rows.device
    # Scratch for the kernel's window-y bounds (`_tile_ybounds`, then
    # `_chunk_ybounds`), which it computes in a first launch, and its bins.
    bounds = torch.empty((-(-P // tile_p) + B * -(-T // chunk_t), 2),
                         dtype=torch.float32, device=dev)
    bins = _bin_scratch(B, T, P, width, dev)
    out = torch.empty((B, n_layers, OUT_CHANNELS, P), dtype=torch.float32, device=dev)
    check(load().tdt_peel_resolve(
        rows.data_ptr(), attrs.data_ptr(), grid.data_ptr(), ybounds.data_ptr(),
        bounds.data_ptr(), bins.data_ptr(), out.data_ptr(), B, T, P, int(width),
        int(n_layers), int(tile_p), int(chunk_t),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "peel_resolve")
    peel_resolve.launches += 1
    return out


peel_resolve.launches = 0


# ---------------------------------------------------------------------------
# B9: depth peel (the `jnp` triangle path).
# ---------------------------------------------------------------------------

PEEL_COLS = 16


def pack_triangle_rows(e, det, vz, vs):
    """(..., T, 3, 3), (..., T), (..., T, 3), (..., T, 3) -> (..., T, 16)
    f32 rows [e00..e22, zr = vz / det, vs, valid] (raster_pallas.py:69)."""
    safe_det = torch.where(det == 0.0, 1.0, det)
    zr = vz / safe_det[..., None]
    valid = (det > 0.0).to(torch.float32)
    flat_e = e.reshape(*e.shape[:-2], 9)
    return torch.cat([flat_e, zr, vs, valid[..., None]], dim=-1)


def depth_peel_ref(rows, grid, n_layers: int):
    """Plain version of B9: rows (B, T, 16), grid (3, P) -> (z (B, K, P)
    f32, id (B, K, P) i32). Layer k holds, per pixel, the least (z, id)
    in lexicographic order among the covering triangles after layer k-1's;
    ids are row positions; an empty pixel has z = inf, id = BIG_ID."""
    B, T, _ = rows.shape
    P = grid.shape[1]
    dev = rows.device
    px, py = grid[0][None, :], grid[1][None, :]
    tid = torch.arange(T, device=dev)[:, None]  # (T, 1)
    z_out = torch.empty((B, n_layers, P), dtype=torch.float32, device=dev)
    id_out = torch.empty((B, n_layers, P), dtype=torch.int32, device=dev)
    for b in range(B):
        cover, z = _peel_cover(rows[b], px, py)
        prev_z = torch.full((P,), -INF, device=dev)
        prev_id = torch.full((P,), -1, dtype=torch.int64, device=dev)
        for layer in range(n_layers):
            after = (z > prev_z) | ((z == prev_z) & (tid > prev_id))
            ok = cover & after
            best_z = torch.where(ok, z, INF).amin(dim=0)
            best_id = torch.where(ok & (z == best_z), tid, BIG_ID).amin(dim=0)
            has = best_id < BIG_ID
            # The winner's own z (amin may return either zero of a +-0 tie).
            wz = torch.gather(z, 0, best_id.clamp_max(T - 1)[None])[0]
            best_z = torch.where(has, wz, INF)
            z_out[b, layer] = best_z
            id_out[b, layer] = best_id.to(torch.int32)
            prev_z, prev_id = best_z, best_id
    return z_out, id_out


def depth_peel(rows, grid, n_layers: int, *, width: int):
    """Kernel B9 for CUDA tensors, its plain version for CPU tensors.
    `width` shapes the kernel's pixel tiles only, as for `peel_resolve`."""
    if rows.device.type == "cpu":
        return depth_peel_ref(rows, grid, n_layers)
    if rows.device.type != "cuda":
        raise ValueError(f"depth_peel: unsupported device {rows.device}")
    B, T, c = rows.shape
    P = grid.shape[1]
    if c != PEEL_COLS or grid.shape[0] != 3 or T < 1:
        raise ValueError("depth_peel: bad shapes")
    if n_layers < 1 or width < 1:
        raise ValueError("depth_peel: n_layers and width must be >= 1")
    rows = _aligned16(rows.float().contiguous())
    grid = grid.float().contiguous()
    dev = rows.device
    z = torch.empty((B, n_layers, P), dtype=torch.float32, device=dev)
    ids = torch.empty((B, n_layers, P), dtype=torch.int32, device=dev)
    bins = _bin_scratch(B, T, P, width, dev)
    check(load().tdt_depth_peel(
        rows.data_ptr(), grid.data_ptr(), bins.data_ptr(), z.data_ptr(), ids.data_ptr(),
        B, T, P, int(width), int(n_layers), torch.cuda.current_stream(dev).cuda_stream,
    ), "depth_peel")
    depth_peel.launches += 1
    return z, ids


depth_peel.launches = 0


# ---------------------------------------------------------------------------
# B4: exact row select (the big-level walk's attribute select).
# ---------------------------------------------------------------------------

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
    """Kernel B4 for CUDA tensors, its plain version for CPU tensors. A C
    whose tile the card's shared memory cannot hold fails the launch,
    which raises."""
    if idx.device.type == "cpu":
        return select_rows_ref(idx, tab)
    if idx.device.type != "cuda":
        raise ValueError(f"select_rows: unsupported device {idx.device}")
    B, N = idx.shape
    if tab.dim() != 3 or tab.shape[0] != B or tab.shape[1] < 1:
        raise ValueError("select_rows: bad shapes")
    S, C = tab.shape[1], tab.shape[2]
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


SCATTER_SMEM_SEGS = 12288  # csrc/scatter_live.cu's shared-memory path: 48 KB of counts


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
    # The shared-memory kernel writes every count; the global one adds
    # into zeros.
    alloc = torch.empty if S <= SCATTER_SMEM_SEGS and N > 0 else torch.zeros
    out = alloc((B, S), dtype=torch.float32, device=idx.device)
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
