// Device code shared by the portal renderer's kernels: B2 (classify +
// shade fused, render_portal.cu), B7 (classify alone, classify_alpha.cu)
// and B8 (shade alone, shade_portal.cu).
//
// Each function is the arithmetic of the plain versions in
// tpu_doom_torch/ops/raster.py operation for operation; the kernels build
// with --fmad=false, so inlining changes no rounding. The one explicit
// fused multiply-add (fmod_exact) rounds a value that is exact.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace portal {

constexpr int kNch = 16;     // record channels
constexpr int kOutCh = 11;   // classified channels: record channels [2, 13)
constexpr int kRpc = 5;      // records per crossing
constexpr int kMasked = 3;   // the masked (middle / sprite) family

// fmodf(x, y), bit for bit, at a fraction of its cost where the quotient
// |x / y| is below 2^20 and |y| is a normal number of at most 2^126 (every
// texel coordinate and texture size of the walk). There the approximate
// quotient is within 0.25 of |x / y|, so its integer part q is off by at
// most one; x - q * y in one fused multiply-add is exact when q is right
// (fmod's result is representable), and its sign or size shows when q is
// one too large or too small. Elsewhere, and for inf / NaN, fmodf itself.
__device__ __forceinline__ float fmod_exact(float x, float y) {
  const float ax = fabsf(x), ay = fabsf(y);
  if (!(ay >= 1.17549435e-38f && ay <= 8.50705917e37f && ax < 1048576.0f * ay))
    return fmodf(x, y);
  const float q = truncf(__fdividef(ax, ay));
  float r = __fmaf_rn(-q, ay, ax);
  if (r < 0.0f) {
    r = __fmaf_rn(-(q - 1.0f), ay, ax);
  } else if (r >= ay) {
    r = __fmaf_rn(-(q + 1.0f), ay, ax);
  }
  return copysignf(r, x);
}

// jnp.mod on floats (== torch.remainder).
__device__ __forceinline__ float jmod(float x, float y) {
  float r = fmod_exact(x, y);
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

// The channels of a masked-family record that its alpha test reads.
struct MaskedRec {
  float w, t1, t2, low, high, tsy, ay;
};

__device__ __forceinline__ MaskedRec load_masked(const float* rec, int W) {
  return MaskedRec{rec[8 * W],  rec[9 * W],  rec[10 * W], rec[11 * W],
                   rec[12 * W], rec[5 * W], rec[15 * W]};
}

// Is the texel of masked record m opaque at the row of ndc_y? The bit of
// texture row y_t in the crossing's packed words wk (word i at wk + i * W).
__device__ __forceinline__ bool alpha_hit(const MaskedRec& m, float ndc_y,
                                          float cam_y, float p11, int hc,
                                          const int32_t* wk, int n_words,
                                          int W) {
  float h_at = cam_y + ndc_y * m.w / p11;
  float dh = m.high - m.low;
  dh = dh == 0.0f ? 1.0f : dh;
  float v = m.t1 + (m.t2 - m.t1) * (h_at - m.low) / dh;
  float vv = jmod(v, m.tsy == 0.0f ? 1.0f : m.tsy) + m.ay;
  int y_t = imod(f2i(floorf(vv)), hc);
  int wi = y_t >> 5, bit = y_t & 31;
  int wsel = 0;
  if (wi >= 0 && wi < n_words) wsel = wk[(size_t)wi * W];
  return ((wsel >> bit) & 1) == 1;
}

// Is record r (channels at rec + c * W) one whose cover the alpha test
// decides? Masked-family records whose masked flag is set.
__device__ __forceinline__ bool alpha_tested(const float* rec, int W, int r) {
  return r % kRpc == kMasked && rec[13 * W] > 0.5f;
}

// Does record r (channels at rec + c * W) cover image row y? Masked-family
// records cover only where their texel's alpha bit is set (B7's walk; B2
// walks the same test over several rows at once).
__device__ __forceinline__ bool record_hits(const float* rec, int W, int r,
                                            float y, float ndc_y, float cam_y,
                                            float p11, int hc,
                                            const int32_t* wk, int n_words) {
  if (!(y >= rec[0] && y < rec[W])) return false;
  if (!alpha_tested(rec, W, r)) return true;
  return alpha_hit(load_masked(rec, W), ndc_y, cam_y, p11, hc, wk, n_words, W);
}

// Image rows [lo, hi) whose centre y = row + 0.5 satisfies y0 <= y < y1,
// clipped to [0, H]: the record test of a whole column at once. Exact for
// H < 2^22: y0 - 0.5 and y1 - 0.5 round only where they are beyond every
// row; NaN bounds cover no row, as the comparisons do.
__device__ __forceinline__ int first_row_at(float t, int H) {
  return (int)fminf(fmaxf(ceilf(t - 0.5f), 0.0f), (float)H);
}

__device__ __forceinline__ void span_rows(float y0, float y1, int H, int* lo,
                                          int* hi) {
  *lo = y0 == y0 ? first_row_at(y0, H) : H;
  *hi = y1 == y1 ? first_row_at(y1, H) : 0;
}

// What the shade needs of one textured pixel: the texel's address in the
// compact table and the colormap row.
struct ShadeAddr {
  int lin;
  int crow;
};

// Does a pixel of this kind read the texel tables? Not when nothing
// covers it (kind 0: index and coverage 0) and not on the sky (its index
// is the sky image's, its coverage 1, whatever the texel).
__device__ __forceinline__ bool reads_texel(float kind) {
  return kind != 0.0f && kind != 3.0f;
}

// The shade's terms, from the classified channels ch: kind p0 tsx tsy
// cbase light w t1 t2 low high of a pixel that reads the texel tables
// (reads_texel(ch[0])). Each pixel computes only the terms of its own
// kind: the wall's texture coordinates and the flat's are the plain
// version's two `torch.where` arms, and the distance term is the decor's
// or the others', so skipping the arm it does not take changes no bit.
// A wall's texel column and colormap row do not depend on the image row,
// so B2 computes them once per record and column (WallTerms, in its
// ShadeRec, render_portal.cu).

__device__ __forceinline__ bool wall_like(float kind) {
  return kind == 2.0f || kind == 4.0f;
}

// The colormap row from the light level and the pixel's distance w_pix.
__device__ __forceinline__ int light_row(float light, float w_pix,
                                         bool is_decor, int n_rows) {
  float lval;
  if (is_decor) {
    const float dist_d = jmin(1.0f, 1.0f - 1.0f / (w_pix + 1.0f));
    lval = jmin(light, light * 2.0f - dist_d);
  } else {
    const float dist_s = jmin(1.0f, 1.0f - 0.9f / (w_pix + 0.9f));
    lval = light * 2.0f - dist_s;
  }
  const int crow = f2i(floorf((1.0f - lval) * (float)n_rows));
  return min(max(crow, 0), n_rows - 1);
}

// The texel's address from its texel column lx and texture coordinate vv,
// given the record's texel base cbase, its texture width + 1 tsx1 and its
// texture height ts_y (1 where the channel is 0).
__device__ __forceinline__ int texel_lin_of(float cbase, float tsx1, float ts_y,
                                            float lx, float vv, int S1) {
  const float ly = floorf(jmod(vv, ts_y));
  const int lin = f2i(cbase + ly * tsx1 + lx);
  return min(max(lin, 0), S1 * 128 - 1);
}

__device__ __forceinline__ int texel_lin(const float ch[kOutCh], float lx,
                                         float vv, int S1) {
  return texel_lin_of(ch[4], ch[2] + 1.0f, ch[3] == 0.0f ? 1.0f : ch[3], lx, vv,
                      S1);
}

// What of a wall-kind pixel (wall_like(ch[0])) its row does not change.
struct WallTerms {
  float lx;
  int crow;
};

__device__ __forceinline__ WallTerms wall_terms(const float ch[kOutCh],
                                                int n_rows) {
  const float ts_x = ch[2] == 0.0f ? 1.0f : ch[2];
  return WallTerms{floorf(jmod(ch[1], ts_x)),
                   light_row(ch[5], ch[6], ch[0] == 4.0f, n_rows)};
}

// A wall-kind pixel's address at the row of ndc_y. This and flat_address
// have twins on B2's ShadeRec (render_portal.cu rec_wall_address and
// rec_flat_address), the same operations with the row-free terms computed
// once a record: change each pair together, or B2 and B8 part.
__device__ __forceinline__ ShadeAddr wall_address(const float ch[kOutCh],
                                                  const WallTerms& t,
                                                  float ndc_y, float cam_y,
                                                  float p11, int S1) {
  const float h_at = cam_y + ndc_y * ch[6] / p11;
  float dh = ch[10] - ch[9];
  dh = dh == 0.0f ? 1.0f : dh;
  const float vv = ch[7] + (ch[8] - ch[7]) * (h_at - ch[9]) / dh;
  return ShadeAddr{texel_lin(ch, t.lx, vv, S1), t.crow};
}

// Any other textured pixel's (the flats'): ch[6..10] are not read.
__device__ __forceinline__ ShadeAddr flat_address(
    const float ch[kOutCh], float ndc_y, float dx, float dz, float cam_x,
    float cam_y, float cam_z, float p11, int S1, int n_rows) {
  const float safe_ndc = fabsf(ndc_y) < 1e-9f ? 1e-9f : ndc_y;
  const float t_flat = p11 * (ch[1] - cam_y) / safe_ndc;
  const float uu = -(cam_x + dx * t_flat) * 100.0f;
  const float vv = -(cam_z + dz * t_flat) * 100.0f;
  const float ts_x = ch[2] == 0.0f ? 1.0f : ch[2];
  const float lx = floorf(jmod(uu, ts_x));
  return ShadeAddr{texel_lin(ch, lx, vv, S1),
                   light_row(ch[5], t_flat, false, n_rows)};
}

// One textured pixel's address and colormap row (B8).
__device__ __forceinline__ ShadeAddr shade_address(
    const float ch[kOutCh], float ndc_y, float dx, float dz, float cam_x,
    float cam_y, float cam_z, float p11, int S1, int n_rows) {
  if (wall_like(ch[0]))
    return wall_address(ch, wall_terms(ch, n_rows), ndc_y, cam_y, p11, S1);
  return flat_address(ch, ndc_y, dx, dz, cam_x, cam_y, cam_z, p11, S1, n_rows);
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

// Palette index and coverage of a pixel that reads no texel
// (!reads_texel(kind)): the sky image's index and 1 on the sky, 0 and 0
// where nothing covers it. The sky image is read on the sky only.
__device__ __forceinline__ void shade_untextured(float kind, const float* sky,
                                                 float* out_idx,
                                                 float* out_cov) {
  const bool is_sky = kind != 0.0f;
  *out_idx = is_sky ? *sky : 0.0f;
  *out_cov = is_sky ? 1.0f : 0.0f;
}

// Palette index and coverage of a textured pixel from its colormapped
// texel v2: nothing where the texel is a hole.
__device__ __forceinline__ void shade_write(float v2, bool is_hole,
                                            float* out_idx, float* out_cov) {
  *out_idx = is_hole ? 0.0f : v2;
  *out_cov = is_hole ? 0.0f : 1.0f;
}

// The colormapped palette index v2 of texel v1 (0..255) at row a.crow.
__device__ __forceinline__ float colormapped(const ShadeAddr& a, int v1,
                                             const int8_t* cmap) {
  return (float)((int)__ldg(cmap + a.crow * 256 + v1) + 128);
}

// Colormapped palette index and coverage of a textured pixel.
__device__ __forceinline__ void shade_store(const ShadeAddr& a, int v1,
                                            bool is_hole,
                                            const int8_t* cmap,
                                            float* out_idx, float* out_cov) {
  shade_write(colormapped(a, v1, cmap), is_hole, out_idx, out_cov);
}

}  // namespace portal
