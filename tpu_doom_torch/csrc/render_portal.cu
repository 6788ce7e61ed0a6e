// Kernel B2: fused portal classify + shade.
//
// Replaces tpu_doom/ops/raster_pallas.py:render_portal_fused_pallas
// (kernel _render_fused_kernel). The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:render_portal_fused_ref) operation for
// operation, built with --fmad=false.
//
// Design: one thread per pixel; a block is 32 columns x 8 rows of one env.
// Each thread walks the env's span records in order and stops at the first
// one covering its row (masked-family records only where their texel
// alpha bit is set), then shades with direct loads from the compact texel,
// hole and colormap tables. Record reads put columns on adjacent threads
// (coalesced); the 8 rows of a block re-read them from L1.
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

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Stages an ablation mask can switch off.
constexpr int kNoClassify = 1;   // every classified channel 0: nothing covered
constexpr int kNoAlpha = 2;      // masked-family records hit without the alpha test
constexpr int kNoTex = 4;        // texel v1 = 128
constexpr int kNoHole = 8;       // no holes
constexpr int kNoCmap = 16;      // v2 = v1
constexpr int kNoShadeMath = 32; // lin = trunc(cbase), crow = trunc(light), clamped
constexpr int kNoLookups = kNoTex | kNoHole | kNoCmap;

template <int kAblate>
__global__ void render_portal_kernel(
    const float* __restrict__ records, const int32_t* __restrict__ words,
    const float* __restrict__ cam, const float* __restrict__ shear,
    const float* __restrict__ dxz, const float* __restrict__ sky,
    const void* __restrict__ tex, const int8_t* __restrict__ hole,
    const int8_t* __restrict__ cmap, float* __restrict__ out_idx,
    float* __restrict__ out_cov, int R, int W, int H, int n_words, int hc,
    int S1, int holeless, int per_env, int tex_stride, float p11,
    int n_rows, int zero) {
  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int row = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (col >= W || row >= H) return;
  const int K = R / kRpc;
  const float y = (float)row + 0.5f;
  const float cam_x = cam[b * 3 + 0];
  const float cam_y = cam[b * 3 + 1];
  const float cam_z = cam[b * 3 + 2];
  const float ndc_y = 1.0f - 2.0f * y / (float)H + shear[b];
  const float* rec_env = records + (size_t)b * R * kNch * W + col;

  // --- classify: first matching record -----------------------------------
  int win = -1;
  if constexpr (!(kAblate & kNoClassify)) {
    for (int r = 0; r < R; ++r) {
      const int32_t* wk = words + ((size_t)b * K + r / kRpc) * n_words * W + col;
      if (record_hits<!(kAblate & kNoAlpha)>(rec_env + (size_t)r * kNch * W, W,
                                             r, y, ndc_y, cam_y, p11, hc, wk,
                                             n_words)) {
        win = r;
        break;
      }
    }
  }

  // --- shade -------------------------------------------------------------
  float ch[kOutCh];
  if (win >= 0) {
    const float* rec = rec_env + (size_t)win * kNch * W;
#pragma unroll
    for (int c = 0; c < kOutCh; ++c) ch[c] = rec[(2 + c) * W];
  } else {
#pragma unroll
    for (int c = 0; c < kOutCh; ++c)
      ch[c] = (kAblate & kNoClassify) ? (float)zero : 0.0f;
  }
  ShadeAddr a;
  if constexpr (kAblate & kNoShadeMath) {
    a = ShadeAddr{min(max(f2i(ch[4]), 0), S1 * 128 - 1),
                  min(max(f2i(ch[5]), 0), n_rows - 1), ch[0] != 0.0f,
                  ch[0] == 3.0f};
  } else {
    const float dx = dxz[((size_t)b * 2 + 0) * W + col];
    const float dz = dxz[((size_t)b * 2 + 1) * W + col];
    a = shade_address(ch, ndc_y, dx, dz, cam_x, cam_y, cam_z, p11, S1,
                      n_rows);
  }
  int v1;
  bool is_hole;
  if (per_env) {
    const int16_t* tb = (const int16_t*)tex + (size_t)b * tex_stride;
    const int v = (int)__ldg(tb + a.lin);
    is_hole = v == 256;
    v1 = min(v, 255);
  } else if constexpr (!(kAblate & (kNoTex | kNoHole))) {
    v1 = global_texel((const int8_t*)tex, hole, holeless, a.lin, &is_hole);
  } else {
    is_hole = false;
    if (!(kAblate & kNoHole) && !holeless) {
      const int hbyte = (int)__ldg(hole + (a.lin >> 3)) + 128;
      is_hole = ((hbyte >> (a.lin & 7)) & 1) == 1;
    }
    v1 = (kAblate & kNoTex) ? 128 + a.lin * zero
                            : (int)__ldg((const int8_t*)tex + a.lin) + 128;
  }
  const size_t o = ((size_t)b * H + row) * W + col;
  const float sky_o = a.is_sky ? sky[o] : 0.0f;
  if constexpr (kAblate & kNoCmap) {
    shade_write(a, (float)(v1 + a.crow * zero), is_hole, sky_o, out_idx + o,
                out_cov + o);
  } else {
    shade_store(a, v1, is_hole, cmap, sky_o, out_idx + o, out_cov + o);
  }
}

template <int kAblate>
int launch(const void* records, const void* words, const void* cam,
           const void* shear, const void* dxz, const void* sky,
           const void* tex, const void* hole, const void* cmap, void* out_idx,
           void* out_cov, int B, int R, int W, int H, int n_words, int hc,
           int S1, int holeless, int per_env, int tex_stride, float p11,
           int n_rows, int zero, void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  render_portal_kernel<kAblate><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)records, (const int32_t*)words, (const float*)cam,
      (const float*)shear, (const float*)dxz, (const float*)sky,
      tex, (const int8_t*)hole, (const int8_t*)cmap, (float*)out_idx,
      (float*)out_cov, R, W, H, n_words, hc, S1, holeless, per_env,
      tex_stride, p11, n_rows, zero);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdt_render_portal(
    const void* records, const void* words, const void* cam, const void* shear,
    const void* dxz, const void* sky, const void* tex, const void* hole,
    const void* cmap, void* out_idx, void* out_cov, int B, int R, int W, int H,
    int n_words, int hc, int S1, int holeless, int per_env, int tex_stride,
    float p11, int n_rows, void* stream) {
  return launch<0>(records, words, cam, shear, dxz, sky, tex, hole, cmap,
                   out_idx, out_cov, B, R, W, H, n_words, hc, S1, holeless,
                   per_env, tex_stride, p11, n_rows, 0, stream);
}

// B2 in the global-table mode with the stages of `ablate` switched off;
// `zero` must be 0. Any mask but the eight the stage budget times returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int tdt_render_portal_ablated(
    const void* records, const void* words, const void* cam, const void* shear,
    const void* dxz, const void* sky, const void* tex, const void* hole,
    const void* cmap, void* out_idx, void* out_cov, int B, int R, int W, int H,
    int n_words, int hc, int S1, int holeless, float p11, int n_rows,
    int ablate, int zero, void* stream) {
#define TDT_ABLATED(mask)                                                     \
  case mask:                                                                  \
    return launch<mask>(records, words, cam, shear, dxz, sky, tex, hole,      \
                        cmap, out_idx, out_cov, B, R, W, H, n_words, hc, S1,  \
                        holeless, 0, 0, p11, n_rows, zero, stream);
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
