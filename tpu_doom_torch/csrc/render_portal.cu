// Kernel B2: fused portal classify + shade.
//
// Replaces tpu_doom/ops/raster_pallas.py:render_portal_fused_pallas
// (kernel _render_fused_kernel). The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:render_portal_fused_ref) operation for
// operation, built with --fmad=false.
//
// Bound on the H100: bytes, on paper (the whole record tensor read once:
// 210 MB of a 256-env :test: frame). The kernel reads much less of it: a
// pixel's walk needs only the span bounds of the records before its own,
// and its shade one record's channels. What costs is the walk, one test
// per record until the first that covers, and the shade's arithmetic.
//
// Design: a block owns a strip of 32 columns of one env over the whole
// height, 32 x G threads (G <= 8 row groups), each thread one column. H is
// split into equal bands of whole 12-row groups, at most 96 rows each; the
// block's G warps walk and shade the strip band after band, a thread 12
// contiguous rows of a column in each.
//  1. The block stages, once, every record's span over the strip as the
//     rows [lo, hi) it covers (portal_shade.cuh span_rows, exact), packed
//     with the record's alpha-test flag in one word of shared memory, and
//     each row's ndc and sky row. So a record's bounds come from device
//     memory once per strip and column, not once per pixel, and not once
//     per band: a record's span does not depend on the band, and the
//     strip's bands (5 at 640x400, 3 at 320x200) share one staging and
//     one barrier. Each thread issues the loads of kStageUnroll items and
//     the strip's sky columns before it uses any. The rows' ndc and sky
//     rows cover up to kStagedRowsMax rows, whole bands; a taller image
//     restages them for its next rows behind a barrier (the spans never).
//     Where H <= 96 there is one band, which a block's warps walk once.
//  2. Each thread walks the records for its 12 rows at once: one shared
//     load and a few integer operations give the mask of its pending rows
//     a record covers; a masked-family record's alpha test (the only
//     per-row float work of the walk) runs on those rows alone. The walk
//     ends when the last of its rows has found its record. A row's winner
//     + 1 is kept in a byte, four rows a register.
//  3. Each row is shaded in turn. At each change of a row's winner the
//     column's 11 channels come from device memory and what no row of the
//     record changes is computed once (ShadeRec: on a wall its texel
//     column and colormap row, the selects of ts_y and dh, t2 - t1; on a
//     flat p11 * (plane_h - cam_y) and the select of ts_x), kept in
//     registers for the rows that follow. A pixel reads and computes only
//     what its kind uses (nothing covers: no channel but the kind; the
//     sky: one texel of the sky texture; walls: the texture row; flats:
//     the flat address and distance; portal_shade.cuh); the texel, hole,
//     colormap and sky reads go through the read-only cache. With the
//     winners a byte a row and the raw channels dropped once the ShadeRec
//     is made, the kernel fits 40 registers (kMinBlocks below) with 20
//     bytes spilled; a loop that kept the raw channels took 51.
//     A winner table in shared memory, every winning (record, column)'s
//     ShadeRec filled once a band and read by each row it wins, ran 2-3 %
//     slower than this loop on the H100: the loads it saves are L1 hits
//     (PERF.md).
//  Then the next band: steps 2 and 3 on the thread's next 12 rows, with
//  no barrier between bands (a warp that finishes a band goes on).
// Shared memory: the strip's sky columns, the staged rows' ndc and sky
// rows, the spans, 4 x (32 + 2 S + 32 R) bytes for S staged rows: 8.4 KB
// at 640x400 (S = 420) and 6.8 KB at 320x200 (S = 216) for R = 40, 16.8
// KB at 320x200 for R = 120.
// The sky comes as coordinates, not as an image: the sky's texel
// coordinates are separable, so the walk gives each column its texel
// column sky_x[b, col] and each image row its texel row sky_y[b, row]
// (render/portal.py:sky_coords; y = row + 0.5, which the pitch's shear
// does not move), and a sky pixel reads sky_tex[sky_y, sky_x] (u8, 32 KB
// at 256 x 128, through the read-only cache). The rows' sky offsets are
// staged beside their ndc, the strip's sky columns before them. (The JAX
// package hands its TPU kernel a (B, H, W) f32 sky image, because a
// Pallas TPU kernel cannot gather cheaply.)
// Outputs: the palette index as u8 and the coverage as bool, the frames'
// own types (the JAX package's f32 outputs after its casts). A warp stores
// one row of its 32 columns at a time: 32 neighbouring bytes, one 32-byte
// sector per store instruction, as many instructions as the f32 stores
// took and a quarter of their bytes.
// Lanes are the strip's 32 columns: a warp shades one row of 32 columns
// at a time, which keeps its stores coalesced and its lanes on rows of
// one kind more often than a warp down a column would (that layout took
// 1.19-1.22x as long on the H100; PERF.md). Twelve rows a thread share
// each record test among more pixels, and six resident blocks of 256
// threads per SM (kMinBlocks, which caps registers at 40; seven of 224
// threads at 640x400, eight of 192 at 320x200) keep enough warps in
// flight to hide the latency of the shade's divisions and loads.
//
// Two texel-table modes, as the TPU kernel's `per_env_tex` flag:
//   global  (per_env = 0): one (S1, 128) int8 table of texel - 128 shared
//           by all envs, transparency from the packed `hole` bits (none
//           read on a holeless level);
//   per-env (per_env = 1): env b reads its own active table, (S1, 128)
//           int16 at tex + b * tex_stride, values 0..255 and 256 for a
//           hole, so the hole rides the value and `hole` is not read.
//
// Stage budget (replaces tools/kernelbudget.py:_ablated_call, the TPU
// kernel's measurement copy): the kernel is a template over a mask of
// stages to switch off. tdt_render_portal launches <0>, the production
// kernel; tdt_render_portal_ablated launches the listed masks in the
// global-table mode, for timing only (tpu_doom_torch/tools/kernelbudget.py,
// whose render_portal_ablated_ref is the plain version of each). Every
// value an ablated stage leaves behind is derived from the runtime
// argument `zero` (always 0), so nvcc cannot fold the stages downstream
// of it away; <0> never reads it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "portal_shade.cuh"

namespace {

using namespace portal;

constexpr int kCols = 32;      // columns per block, one per lane
constexpr int kMaxGroups = 8;  // row groups per block, one warp each
constexpr int kRows = 12;      // contiguous rows per thread
constexpr int kMinBlocks = 6;  // resident blocks per SM: <= 40 registers
constexpr int kBandMax = kMaxGroups * kRows;  // rows of a band at most
constexpr int kStagedRowsMax = 1024;          // rows whose ndc and sky are staged at once
constexpr int kStaticSmem = 48 * 1024;

// A record's span over one column in shared memory: rows [lo, hi) in
// kRowBits bits each, and the alpha-test flag.
constexpr int kRowBits = 15;
constexpr uint32_t kRowMask = (1u << kRowBits) - 1u;
constexpr uint32_t kAlphaFlag = 1u << 31;

// Stages an ablation mask can switch off.
constexpr int kNoClassify = 1;   // every classified channel 0: nothing covered
constexpr int kNoAlpha = 2;      // masked-family records hit without the alpha test
constexpr int kNoTex = 4;        // texel v1 = 128
constexpr int kNoHole = 8;       // no holes
constexpr int kNoCmap = 16;      // v2 = v1
constexpr int kNoShadeMath = 32; // lin = trunc(cbase), crow = trunc(light), clamped
constexpr int kNoLookups = kNoTex | kNoHole | kNoCmap;

constexpr int kStageUnroll = 2;  // span items a thread loads before using any

// What the shade of a textured pixel reads of its record, with the terms
// that no row changes computed once (each the plain version's operation):
// kind, the texel base ch[4], ch[2] + 1 and the select of ts_y; on a wall
// kind (wall_like) a = w, b = t1, c = t2 - t1, the wall's low, the select
// of dh, its texel column lx and colormap row crow (wall_terms); on the
// flats a = p11 * (plane_h - cam_y), b = the select of ts_x, c = light. The
// stage budget's no_shade_math variant takes the flats' layout for every
// kind (it reads cbase and light). B8 (shade_portal.cu) computes the same
// per pixel with portal_shade.cuh's shade_address, which runs faster there
// than through a ShadeRec (7-10 %, chip_smoke).
struct ShadeRec {
  float kind, cbase, tsx1, ts_y, a, b, c, low, dh, lx;
  int crow;
};

template <int kAblate>
__device__ __forceinline__ ShadeRec shade_rec(const float ch[kOutCh], float cam_y,
                                              float p11, int n_rows) {
  ShadeRec s;
  s.kind = ch[0];
  s.cbase = ch[4];
  s.tsx1 = ch[2] + 1.0f;
  s.ts_y = ch[3] == 0.0f ? 1.0f : ch[3];
  s.low = 0.0f;
  s.dh = 0.0f;
  s.lx = 0.0f;
  s.crow = 0;
  if (!(kAblate & kNoShadeMath) && wall_like(ch[0])) {
    const WallTerms t = wall_terms(ch, n_rows);
    const float dh = ch[10] - ch[9];
    s.a = ch[6];
    s.b = ch[7];
    s.c = ch[8] - ch[7];
    s.low = ch[9];
    s.dh = dh == 0.0f ? 1.0f : dh;
    s.lx = t.lx;
    s.crow = t.crow;
  } else {
    s.a = p11 * (ch[1] - cam_y);
    s.b = ch[2] == 0.0f ? 1.0f : ch[2];
    s.c = ch[5];
  }
  return s;
}

// portal_shade.cuh's wall_address and flat_address on a ShadeRec: the
// same operations, those of the row alone left (change each pair
// together).
__device__ __forceinline__ ShadeAddr rec_wall_address(const ShadeRec& s,
                                                      float ndc_y, float cam_y,
                                                      float p11, int S1) {
  const float h_at = cam_y + ndc_y * s.a / p11;
  const float vv = s.b + s.c * (h_at - s.low) / s.dh;
  return ShadeAddr{texel_lin_of(s.cbase, s.tsx1, s.ts_y, s.lx, vv, S1), s.crow};
}

__device__ __forceinline__ ShadeAddr rec_flat_address(
    const ShadeRec& s, float ndc_y, float dx, float dz, float cam_x, float cam_z,
    int S1, int n_rows) {
  const float safe_ndc = fabsf(ndc_y) < 1e-9f ? 1e-9f : ndc_y;
  const float t_flat = s.a / safe_ndc;
  const float uu = -(cam_x + dx * t_flat) * 100.0f;
  const float vv = -(cam_z + dz * t_flat) * 100.0f;
  const float lx = floorf(jmod(uu, s.b));
  return ShadeAddr{texel_lin_of(s.cbase, s.tsx1, s.ts_y, lx, vv, S1),
                   light_row(s.c, t_flat, false, n_rows)};
}

// What a pixel's shade needs beside its record's terms.
struct PixelCtx {
  int b, H, W, col, row0, lane_col;
  float cam_x, cam_y, cam_z, dx, dz, p11;
  int S1, n_rows, holeless, per_env, tex_stride, zero;
};

// Shade the pixel of image row `row` and the context's column, whose
// record's terms are `sr`.
template <int kAblate>
__device__ __forceinline__ void shade_pixel(
    const PixelCtx& px, int row, const ShadeRec& sr,
    const float* s_ndc, const int* s_sky, const int* s_sky_col,
    const uint8_t* __restrict__ sky_tex, const void* __restrict__ tex,
    const int8_t* __restrict__ hole, const int8_t* __restrict__ cmap,
    uint8_t* __restrict__ out_idx, uint8_t* __restrict__ out_cov) {
  const size_t o = ((size_t)px.b * px.H + row) * px.W + px.col;
  if (!(kAblate & kNoClassify) && !reads_texel(sr.kind)) {
    // Nothing covers (kind 0): 0 and not covered; the sky: its texel.
    const bool is_sky = sr.kind != 0.0f;
    out_idx[o] = is_sky ? __ldg(sky_tex + s_sky[row - px.row0] + s_sky_col[px.lane_col]) : 0;
    out_cov[o] = is_sky;
    return;
  }
  const float ndc_y = s_ndc[row - px.row0];
  const int S1 = px.S1, n_rows = px.n_rows, zero = px.zero;
  ShadeAddr a;
  if constexpr (kAblate & kNoShadeMath) {
    a = ShadeAddr{min(max(f2i(sr.cbase), 0), S1 * 128 - 1),
                  min(max(f2i(sr.c), 0), n_rows - 1)};
  } else if (wall_like(sr.kind)) {
    a = rec_wall_address(sr, ndc_y, px.cam_y, px.p11, S1);
  } else {
    a = rec_flat_address(sr, ndc_y, px.dx, px.dz, px.cam_x, px.cam_z, S1, n_rows);
  }
  int v1;
  bool is_hole;
  if (px.per_env) {
    const int16_t* tb = (const int16_t*)tex + (size_t)px.b * px.tex_stride;
    const int v = (int)__ldg(tb + a.lin);
    is_hole = v == 256;
    v1 = min(v, 255);
  } else if constexpr (!(kAblate & (kNoTex | kNoHole))) {
    v1 = global_texel((const int8_t*)tex, hole, px.holeless, a.lin, &is_hole);
  } else {
    is_hole = false;
    if (!(kAblate & kNoHole) && !px.holeless) {
      const int hbyte = (int)__ldg(hole + (a.lin >> 3)) + 128;
      is_hole = ((hbyte >> (a.lin & 7)) & 1) == 1;
    }
    v1 = (kAblate & kNoTex) ? 128 + a.lin * zero
                            : (int)__ldg((const int8_t*)tex + a.lin) + 128;
  }
  const float v2 = (kAblate & kNoCmap) ? (float)(v1 + a.crow * zero)
                                       : colormapped(a, v1, cmap);
  if constexpr (kAblate & kNoClassify) {
    // Kind 0 everywhere: the plain version's (0, 0), which v2 and the
    // hole flag reach through `zero` so that nvcc keeps their work.
    out_idx[o] = (uint8_t)(int)(v2 * (float)zero);
    out_cov[o] = ((int)is_hole * zero) != 0;
  } else {
    // v2 is a palette index, 0..255: the u8 store is exact.
    out_idx[o] = is_hole ? 0 : (uint8_t)(int)v2;
    out_cov[o] = !is_hole;
  }
}

template <int kAblate>
__global__ void __launch_bounds__(kCols * kMaxGroups, kMinBlocks)
render_portal_kernel(
    const float* __restrict__ records, const int32_t* __restrict__ words,
    const float* __restrict__ cam, const float* __restrict__ shear,
    const float* __restrict__ dxz, const int32_t* __restrict__ sky_x,
    const int32_t* __restrict__ sky_y, const uint8_t* __restrict__ sky_tex,
    const void* __restrict__ tex, const int8_t* __restrict__ hole,
    const int8_t* __restrict__ cmap, uint8_t* __restrict__ out_idx,
    uint8_t* __restrict__ out_cov, int R, int W, int H, int n_words, int hc,
    int hs, int ws, int S1, int holeless, int per_env, int tex_stride,
    float p11, int n_rows, int staged, int zero) {
  // Shared memory: the strip's sky columns and the staged rows' ndc first,
  // at offsets fixed at compile time, then the staged rows' sky offsets
  // and the spans, at offsets from the arguments.
  extern __shared__ uint32_t s_mem[];
  int* s_sky_col = reinterpret_cast<int*>(s_mem);  // kCols: the strip's sky columns
  float* s_ndc = reinterpret_cast<float*>(s_sky_col + kCols);  // staged: rows' ndc
  int* s_sky = reinterpret_cast<int*>(s_ndc + staged);         // staged: rows' sky offsets
  uint32_t* s_span = reinterpret_cast<uint32_t*>(s_sky + staged);  // R x kCols
  const int groups = blockDim.y;
  const int band = groups * kRows;
  const int col0 = blockIdx.x * kCols;
  const int b = blockIdx.z;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int n_threads = kCols * groups;
  const float* rec_env = records + (size_t)b * R * kNch * W;

  // --- 1. stage the strip's spans and sky columns, once ----------------
  const int sky_col = tid < kCols && col0 + tid < W ? sky_x[(size_t)b * W + col0 + tid] : 0;
  for (int i0 = tid; i0 < R * kCols; i0 += kStageUnroll * n_threads) {
    float y0[kStageUnroll], y1[kStageUnroll], masked[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * n_threads;
      const int r = i / kCols;
      const int col = col0 + i % kCols;
      y0[u] = y1[u] = masked[u] = 0.0f;
      if (!(kAblate & kNoClassify) && i < R * kCols && col < W) {
        const float* rec = rec_env + (size_t)r * kNch * W + col;
        y0[u] = rec[0];
        y1[u] = rec[W];
        // portal_shade.cuh alpha_tested: the masked flag of a masked-family record.
        if (!(kAblate & kNoAlpha) && r % kRpc == kMasked) masked[u] = rec[13 * W];
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * n_threads;
      if (i >= R * kCols) break;
      uint32_t span = 0;  // rows [0, 0): none
      if (!(kAblate & kNoClassify) && col0 + i % kCols < W) {
        int lo, hi;
        span_rows(y0[u], y1[u], H, &lo, &hi);
        span = (uint32_t)lo | ((uint32_t)hi << kRowBits);
        if (masked[u] > 0.5f) span |= kAlphaFlag;
      }
      s_span[i] = span;
    }
  }
  if (tid < kCols) s_sky_col[tid] = min(max(sky_col, 0), ws - 1);

  const int lane_col = threadIdx.x;
  const int col = col0 + lane_col;
  const float shear_b = shear[b];
  const float cam_x = cam[b * 3 + 0];
  const float cam_y = cam[b * 3 + 1];
  const float cam_z = cam[b * 3 + 2];
  rec_env += col;

  // The strip's bands in turn, each warp its 12 rows of each, with no
  // barrier between bands. The rows' ndc and sky rows are staged `staged`
  // rows (whole bands) at a time: once, unless H > kStagedRowsMax.
  for (int band0 = 0; band0 < H; band0 += band) {
    const int li = band0 % staged;  // the band's first row among the staged
    if (li == 0) {
      // Every warp has shaded the rows staged before, which are replaced.
      if (band0 > 0) __syncthreads();
      for (int t = tid; t < min(staged, H - band0); t += n_threads) {
        const float y = (float)(band0 + t) + 0.5f;
        s_ndc[t] = 1.0f - 2.0f * y / (float)H + shear_b;
        // The sky texture's row offset of each row.
        s_sky[t] = min(max(sky_y[(size_t)b * H + band0 + t], 0), hs - 1) * ws;
      }
      __syncthreads();
    }
    const int row0 = band0 - li;  // the first staged row
    const int rbase = band0 + threadIdx.y * kRows;
    const int n_mine = col < W ? min(max(H - rbase, 0), kRows) : 0;

    // --- 2. classify: the first record covering each of my rows ----------
    // The winners packed a byte a row (record + 1; 0: none), rows 4j..4j+3
    // in win[j].
    uint32_t win[kRows / 4] = {0u, 0u, 0u};
    if constexpr (!(kAblate & kNoClassify)) {
      const int32_t* words_env = words + (size_t)b * (R / kRpc) * n_words * W + col;
      uint32_t pending = (1u << n_mine) - 1u;
      for (int r = 0; r < R && pending; ++r) {
        const uint32_t sp = s_span[r * kCols + lane_col];
        const int a = max((int)(sp & kRowMask) - rbase, 0);
        const int e = min((int)((sp >> kRowBits) & kRowMask) - rbase, kRows);
        if (a >= e) continue;
        uint32_t hit = ((1u << e) - (1u << a)) & pending;
        if (!hit) continue;
        if (sp & kAlphaFlag) {
          const MaskedRec m = load_masked(rec_env + (size_t)r * kNch * W, W);
          const int32_t* wk = words_env + (size_t)(r / kRpc) * n_words * W;
          for (uint32_t t = hit; t; t &= t - 1u) {
            const int i = __ffs(t) - 1;
            if (!alpha_hit(m, s_ndc[rbase - row0 + i], cam_y, p11, hc, wk,
                           n_words, W))
              hit &= ~(1u << i);
          }
        }
        // Byte q of win[j] takes r + 1 where bit 4j + q of hit is set.
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) {
          const uint32_t bytes = (((hit >> (4 * j)) & 0xfu) * 0x00204081u) & 0x01010101u;
          win[j] |= (uint32_t)(r + 1) * bytes;
        }
        pending &= ~hit;
      }
    }
    if (n_mine == 0) continue;

    // --- 3. shade my rows in turn ----------------------------------------
    float dx = 0.0f, dz = 0.0f;
    if constexpr (!(kAblate & kNoShadeMath)) {
      dx = dxz[((size_t)b * 2 + 0) * W + col];
      dz = dxz[((size_t)b * 2 + 1) * W + col];
    }
    const PixelCtx px{b, H, W, col, row0, lane_col, cam_x, cam_y, cam_z, dx, dz, p11,
                      S1, n_rows, holeless, per_env, tex_stride, zero};
    // At each change of winner, its channels from device memory and its
    // ShadeRec computed, kept for the rows that follow.
    ShadeRec sr;
    sr.kind = 0.0f;
    int cur = -2;         // the record whose kind sr.kind holds
    bool loaded = false;  // and the rest of sr too
#pragma unroll 1
    for (int i = 0; i < n_mine; ++i) {
      const int w = (int)(win[0] & 0xffu) - 1;
      win[0] = (win[0] >> 8) | (win[1] << 24);
      win[1] = (win[1] >> 8) | (win[2] << 24);
      win[2] >>= 8;
      const float* rec = rec_env + (size_t)max(w, 0) * kNch * W;
      if (w != cur) {
        cur = w;
        loaded = false;
        sr.kind = w >= 0 ? rec[2 * W] : ((kAblate & kNoClassify) ? (float)zero : 0.0f);
      }
      // With the walk switched off every pixel still takes the textured
      // path, on its zero channels, so that the variant removes the walk
      // and keeps the shade.
      if (!loaded && ((kAblate & kNoClassify) || reads_texel(sr.kind))) {
        float ch[kOutCh];
        ch[0] = sr.kind;
#pragma unroll
        for (int c = 1; c < kOutCh; ++c)
          ch[c] = (kAblate & kNoClassify) ? (float)zero : rec[(2 + c) * W];
        sr = shade_rec<kAblate>(ch, cam_y, p11, n_rows);
        loaded = true;
      }
      shade_pixel<kAblate>(px, rbase + i, sr, s_ndc, s_sky, s_sky_col, sky_tex, tex,
                           hole, cmap, out_idx, out_cov);
    }
  }
}

template <int kAblate>
int launch(const void* records, const void* words, const void* cam,
           const void* shear, const void* dxz, const void* sky_x,
           const void* sky_y, const void* sky_tex, const void* tex,
           const void* hole, const void* cmap, void* out_idx, void* out_cov,
           int B, int R, int W, int H, int n_words, int hc, int hs, int ws,
           int S1, int holeless, int per_env, int tex_stride, float p11,
           int n_rows, int zero, void* stream) {
  // The walk keeps a row's winner + 1 in a byte.
  if (H < 1 || H > (int)kRowMask || hs < 1 || ws < 1 || R < 0 || R > 254)
    return (int)cudaErrorInvalidValue;
  // Equal bands of whole row groups, at most kMaxGroups groups each; one
  // block a strip walks them all. Rows staged at once: whole bands, all of
  // them where they fit in kStagedRowsMax.
  const int n_bands = (H + kBandMax - 1) / kBandMax;
  const int groups = ((H + n_bands - 1) / n_bands + kRows - 1) / kRows;
  const int band = groups * kRows;
  const int per_stage = kStagedRowsMax / band;
  const int staged = (n_bands < per_stage ? n_bands : per_stage) * band;
  const size_t smem = ((size_t)R * kCols + 2 * staged + kCols) * sizeof(uint32_t);
  if (smem > kStaticSmem) {
    // Above 48 KB only with the opt-in; a card that refuses it fails the
    // call here, and nothing is launched. The refusal is also the runtime's
    // last error, which is cleared so that no later launch reports it.
    const cudaError_t err = cudaFuncSetAttribute(
        render_portal_kernel<kAblate>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  dim3 block(kCols, groups);
  dim3 grid((W + kCols - 1) / kCols, 1, B);
  render_portal_kernel<kAblate><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)records, (const int32_t*)words, (const float*)cam,
      (const float*)shear, (const float*)dxz, (const int32_t*)sky_x,
      (const int32_t*)sky_y, (const uint8_t*)sky_tex, tex, (const int8_t*)hole,
      (const int8_t*)cmap, (uint8_t*)out_idx, (uint8_t*)out_cov, R, W, H,
      n_words, hc, hs, ws, S1, holeless, per_env, tex_stride, p11, n_rows, staged,
      zero);
  return (int)cudaGetLastError();
}

// fmod_exact against fmodf, element by element (the card test of
// portal_shade.cuh's remainder).
__global__ void fmod_check_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ fast,
                                  float* __restrict__ ref, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fast[i] = fmod_exact(x[i], y[i]);
  ref[i] = fmodf(x[i], y[i]);
}

}  // namespace

extern "C" int tdt_render_portal(
    const void* records, const void* words, const void* cam, const void* shear,
    const void* dxz, const void* sky_x, const void* sky_y, const void* sky_tex,
    const void* tex, const void* hole, const void* cmap, void* out_idx,
    void* out_cov, int B, int R, int W, int H, int n_words, int hc, int hs,
    int ws, int S1, int holeless, int per_env, int tex_stride, float p11,
    int n_rows, void* stream) {
  return launch<0>(records, words, cam, shear, dxz, sky_x, sky_y, sky_tex, tex,
                   hole, cmap, out_idx, out_cov, B, R, W, H, n_words, hc, hs, ws,
                   S1, holeless, per_env, tex_stride, p11, n_rows, 0, stream);
}

// B2 in the global-table mode with the stages of `ablate` switched off;
// `zero` must be 0. Any mask but the eight the stage budget times returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int tdt_render_portal_ablated(
    const void* records, const void* words, const void* cam, const void* shear,
    const void* dxz, const void* sky_x, const void* sky_y, const void* sky_tex,
    const void* tex, const void* hole, const void* cmap, void* out_idx,
    void* out_cov, int B, int R, int W, int H, int n_words, int hc, int hs,
    int ws, int S1, int holeless, float p11, int n_rows, int ablate, int zero,
    void* stream) {
#define TDT_ABLATED(mask)                                                     \
  case mask:                                                                  \
    return launch<mask>(records, words, cam, shear, dxz, sky_x, sky_y,        \
                        sky_tex, tex, hole, cmap, out_idx, out_cov, B, R, W,  \
                        H, n_words, hc, hs, ws, S1, holeless, 0, 0, p11,      \
                        n_rows, zero, stream);
  switch (ablate) {
    TDT_ABLATED(0)
    TDT_ABLATED(kNoClassify)
    TDT_ABLATED(kNoAlpha)
    TDT_ABLATED(kNoTex)
    TDT_ABLATED(kNoHole)
    TDT_ABLATED(kNoCmap)
    TDT_ABLATED(kNoLookups)
    TDT_ABLATED(kNoShadeMath)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TDT_ABLATED
}

extern "C" int tdt_fmod_check(const void* x, const void* y, void* fast,
                              void* ref, int n, void* stream) {
  if (n <= 0) return 0;
  fmod_check_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)fast, (float*)ref, n);
  return (int)cudaGetLastError();
}
