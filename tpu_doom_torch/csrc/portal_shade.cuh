// Device code shared by the portal renderer's kernels: B2 (classify +
// shade fused, render_portal.cu), B7 (classify alone, classify_alpha.cu)
// and B8 (shade alone, shade_portal.cu).
//
// Each function is the arithmetic of the plain versions in
// tpu_doom_torch/ops/raster.py operation for operation; the kernels build
// with --fmad=false, so inlining changes no rounding.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace portal {

constexpr int kNch = 16;     // record channels
constexpr int kOutCh = 11;   // classified channels: record channels [2, 13)
constexpr int kRpc = 5;      // records per crossing
constexpr int kMasked = 3;   // the masked (middle / sprite) family

// jnp.mod on floats (== torch.remainder).
__device__ __forceinline__ float jmod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

// jnp.mod on ints (floor mod).
__device__ __forceinline__ int imod(int x, int y) {
  int r = x % y;
  if (r != 0 && ((r < 0) != (y < 0))) r += y;
  return r;
}

// Saturating float -> int32 truncation, NaN -> 0 (XLA's convert).
__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }

// jnp.minimum (NaN propagates).
__device__ __forceinline__ float jmin(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

// Does record r (channels at rec + c * W) cover image row y? Masked-family
// records cover only where their texel's alpha bit is set: the bit of
// texture row y_t in the crossing's packed words wk (word i at wk + i * W).
// kAlpha = false drops that test (the stage budget's `alpha` ablation,
// tools/kernelbudget.py); every production kernel takes the default.
template <bool kAlpha = true>
__device__ __forceinline__ bool record_hits(const float* rec, int W, int r,
                                            float y, float ndc_y, float cam_y,
                                            float p11, int hc,
                                            const int32_t* wk, int n_words) {
  if (!(y >= rec[0] && y < rec[W])) return false;
  if (!kAlpha || r % kRpc != kMasked || !(rec[13 * W] > 0.5f)) return true;
  const float w_ch = rec[8 * W], t1 = rec[9 * W], t2 = rec[10 * W];
  const float low = rec[11 * W], high = rec[12 * W];
  const float tsy = rec[5 * W], ay = rec[15 * W];
  float h_at = cam_y + ndc_y * w_ch / p11;
  float dh = high - low;
  dh = dh == 0.0f ? 1.0f : dh;
  float v = t1 + (t2 - t1) * (h_at - low) / dh;
  float vv = jmod(v, tsy == 0.0f ? 1.0f : tsy) + ay;
  int y_t = imod(f2i(floorf(vv)), hc);
  int wi = y_t >> 5, bit = y_t & 31;
  int wsel = 0;
  if (wi >= 0 && wi < n_words) wsel = wk[(size_t)wi * W];
  return ((wsel >> bit) & 1) == 1;
}

// What the shade needs of one classified pixel: the texel's address in
// the compact table, the colormap row, and the kind flags.
struct ShadeAddr {
  int lin;
  int crow;
  bool covered0;
  bool is_sky;
};

// ch: the classified channels kind p0 tsx tsy cbase light w t1 t2 low high.
__device__ __forceinline__ ShadeAddr shade_address(
    const float ch[kOutCh], float ndc_y, float dx, float dz, float cam_x,
    float cam_y, float cam_z, float p11, int S1, int n_rows) {
  const float kind = ch[0];
  const bool is_sky = kind == 3.0f;
  const bool is_wall = kind == 2.0f;
  const bool is_decor = kind == 4.0f;
  const bool wall_like = is_wall || is_decor;

  const float plane_h = ch[1];
  const float safe_ndc = fabsf(ndc_y) < 1e-9f ? 1e-9f : ndc_y;
  const float t_flat = p11 * (plane_h - cam_y) / safe_ndc;
  const float flat_u = -(cam_x + dx * t_flat) * 100.0f;
  const float flat_v = -(cam_z + dz * t_flat) * 100.0f;
  const float h_at = cam_y + ndc_y * ch[6] / p11;
  float dh = ch[10] - ch[9];
  dh = dh == 0.0f ? 1.0f : dh;
  const float wall_v = ch[7] + (ch[8] - ch[7]) * (h_at - ch[9]) / dh;
  const float uu = wall_like ? ch[1] : flat_u;
  const float vv = wall_like ? wall_v : flat_v;
  const float ts_x = ch[2] == 0.0f ? 1.0f : ch[2];
  const float ts_y = ch[3] == 0.0f ? 1.0f : ch[3];
  const float lx = floorf(jmod(uu, ts_x));
  const float ly = floorf(jmod(vv, ts_y));
  int lin = f2i(ch[4] + ly * (ch[2] + 1.0f) + lx);
  lin = min(max(lin, 0), S1 * 128 - 1);

  const float w_pix = (wall_like || (is_sky && ch[6] > 0.0f)) ? ch[6] : t_flat;
  const float light = ch[5];
  const float dist_s = jmin(1.0f, 1.0f - 0.9f / (w_pix + 0.9f));
  const float dist_d = jmin(1.0f, 1.0f - 1.0f / (w_pix + 1.0f));
  const float lval = is_decor ? jmin(light, light * 2.0f - dist_d)
                              : light * 2.0f - dist_s;
  int crow = f2i(floorf((1.0f - lval) * (float)n_rows));
  crow = min(max(crow, 0), n_rows - 1);
  return ShadeAddr{lin, crow, kind != 0.0f, is_sky};
}

// Texel (0..255) and transparency from the global compact table (texel -
// 128, s8) and its packed hole bits (byte - 128; not read when holeless).
__device__ __forceinline__ int global_texel(const int8_t* tex,
                                            const int8_t* hole, int holeless,
                                            int lin, bool* is_hole) {
  *is_hole = false;
  if (!holeless) {
    const int hbyte = (int)__ldg(hole + (lin >> 3)) + 128;
    *is_hole = ((hbyte >> (lin & 7)) & 1) == 1;
  }
  return (int)__ldg(tex + lin) + 128;
}

// Palette index and coverage of one pixel from its colormapped texel v2.
__device__ __forceinline__ void shade_write(const ShadeAddr& a, float v2,
                                            bool is_hole, float sky,
                                            float* out_idx, float* out_cov) {
  const bool covered = a.covered0 && (a.is_sky || !is_hole);
  const float val = a.is_sky ? sky : v2;
  *out_idx = covered ? val : 0.0f;
  *out_cov = covered ? 1.0f : 0.0f;
}

// Colormapped palette index and coverage of one pixel.
__device__ __forceinline__ void shade_store(const ShadeAddr& a, int v1,
                                            bool is_hole,
                                            const int8_t* cmap, float sky,
                                            float* out_idx, float* out_cov) {
  const float v2 = (float)((int)__ldg(cmap + a.crow * 256 + v1) + 128);
  shade_write(a, v2, is_hole, sky, out_idx, out_cov);
}

}  // namespace portal
