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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNch = 16;
constexpr int kRpc = 5;      // records per crossing
constexpr int kMasked = 3;   // the masked (middle / sprite) family
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

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

__device__ __forceinline__ float jmin(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

__global__ void render_portal_kernel(
    const float* __restrict__ records, const int32_t* __restrict__ words,
    const float* __restrict__ cam, const float* __restrict__ shear,
    const float* __restrict__ dxz, const float* __restrict__ sky,
    const void* __restrict__ tex, const int8_t* __restrict__ hole,
    const int8_t* __restrict__ cmap, float* __restrict__ out_idx,
    float* __restrict__ out_cov, int R, int W, int H, int n_words, int hc,
    int S1, int holeless, int per_env, int tex_stride, float p11,
    int n_rows) {
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
  for (int r = 0; r < R; ++r) {
    const float* rec = rec_env + (size_t)r * kNch * W;
    if (!(y >= rec[0] && y < rec[W])) continue;
    if (r % kRpc == kMasked && rec[13 * W] > 0.5f) {
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
      if (wi >= 0 && wi < n_words)
        wsel = words[(((size_t)b * K + r / kRpc) * n_words + wi) * W + col];
      if (((wsel >> bit) & 1) != 1) continue;
    }
    win = r;
    break;
  }

  // --- shade -------------------------------------------------------------
  float ch[11];
  if (win >= 0) {
    const float* rec = rec_env + (size_t)win * kNch * W;
#pragma unroll
    for (int c = 0; c < 11; ++c) ch[c] = rec[(2 + c) * W];
  } else {
#pragma unroll
    for (int c = 0; c < 11; ++c) ch[c] = 0.0f;
  }
  const float kind = ch[0];
  const bool covered0 = kind != 0.0f;
  const bool is_sky = kind == 3.0f;
  const bool is_wall = kind == 2.0f;
  const bool is_decor = kind == 4.0f;
  const bool wall_like = is_wall || is_decor;
  const float dx = dxz[((size_t)b * 2 + 0) * W + col];
  const float dz = dxz[((size_t)b * 2 + 1) * W + col];

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

  int v1;
  bool is_hole = false;
  if (per_env) {
    const int16_t* tb = (const int16_t*)tex + (size_t)b * tex_stride;
    const int v = (int)__ldg(tb + lin);
    is_hole = v == 256;
    v1 = min(v, 255);
  } else {
    v1 = (int)__ldg((const int8_t*)tex + lin) + 128;
    if (!holeless) {
      const int hbyte = (int)__ldg(hole + (lin >> 3)) + 128;
      is_hole = ((hbyte >> (lin & 7)) & 1) == 1;
    }
  }
  const float v2 = (float)((int)__ldg(cmap + crow * 256 + v1) + 128);
  const bool covered = covered0 && (is_sky || !is_hole);
  const size_t o = ((size_t)b * H + row) * W + col;
  const float val = is_sky ? sky[o] : v2;
  out_idx[o] = covered ? val : 0.0f;
  out_cov[o] = covered ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int tdt_render_portal(
    const void* records, const void* words, const void* cam, const void* shear,
    const void* dxz, const void* sky, const void* tex, const void* hole,
    const void* cmap, void* out_idx, void* out_cov, int B, int R, int W, int H,
    int n_words, int hc, int S1, int holeless, int per_env, int tex_stride,
    float p11, int n_rows, void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  render_portal_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)records, (const int32_t*)words, (const float*)cam,
      (const float*)shear, (const float*)dxz, (const float*)sky,
      tex, (const int8_t*)hole, (const int8_t*)cmap, (float*)out_idx,
      (float*)out_cov, R, W, H, n_words, hc, S1, holeless, per_env,
      tex_stride, p11, n_rows);
  return (int)cudaGetLastError();
}
