// Kernel B3: K-layer depth peel + attribute resolve.
//
// Replaces tpu_doom/ops/raster_pallas.py:peel_resolve_pallas (kernel
// _peel_resolve_kernel). The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:peel_resolve_ref), built with --fmad=false.
//
// Design: one block per (pixel tile, env), one thread per pixel. For each
// layer the block walks the y-sorted triangle chunks, skips those whose
// window-y bounds miss the tile, stages each remaining chunk's rows in
// shared memory, and every thread keeps its lexicographic (z, id) best and
// the winner's row position in registers. The resolve loads the winner's
// row and attributes directly.

#include <cuda_runtime.h>
#include <math.h>

#include "peel.cuh"

namespace {

using peel::kMaxChunk;

constexpr int kRowCols = 24;
constexpr int kAttrCols = 16;
constexpr int kOutCh = 16;
constexpr float kBigId = 1073741824.0f;  // 2**30

__global__ void peel_resolve_kernel(const float* __restrict__ rows,
                                    const float* __restrict__ attrs,
                                    const float* __restrict__ grid,
                                    const float* __restrict__ chunk_bounds,
                                    float* __restrict__ out, int T_pad, int P,
                                    int P_pad, int n_layers, int tile_p,
                                    int chunk_t) {
  __shared__ float sh_rows[kMaxChunk * kRowCols];
  __shared__ float sh_red[2][32];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int p = tile * tile_p + tid;
  const float inf = __int_as_float(0x7f800000);
  const float px = grid[p];
  const float py = grid[P_pad + p];

  // This tile's window-y extent (min / max of py over the tile, +-1).
  float lo = py, hi = py;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) {
    sh_red[0][tid >> 5] = lo;
    sh_red[1][tid >> 5] = hi;
  }
  __syncthreads();
  float py_min = sh_red[0][0], py_max = sh_red[1][0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    py_min = fminf(py_min, sh_red[0][w]);
    py_max = fmaxf(py_max, sh_red[1][w]);
  }
  py_min = py_min - 1.0f;
  py_max = py_max + 1.0f;

  const float* env_rows = rows + (size_t)b * T_pad * kRowCols;
  const float* env_attrs = attrs + (size_t)b * T_pad * kAttrCols;
  const float* env_cb = chunk_bounds + (size_t)b * (T_pad / chunk_t) * 2;
  const int n_chunks = T_pad / chunk_t;

  float prev_z = -inf, prev_id = -1.0f;
  for (int layer = 0; layer < n_layers; ++layer) {
    float best_z = inf, best_id = kBigId;
    int best_pos = -1;
    for (int c = 0; c < n_chunks; ++c) {
      if (!(env_cb[2 * c] <= py_max && env_cb[2 * c + 1] >= py_min)) continue;
      __syncthreads();  // previous chunk's rows no longer in use
      for (int i = tid; i < chunk_t * kRowCols; i += blockDim.x)
        sh_rows[i] = env_rows[(size_t)c * chunk_t * kRowCols + i];
      __syncthreads();
      for (int t = 0; t < chunk_t; ++t) {
        const float* s = sh_rows + t * kRowCols;
        float z;
        const bool cover = peel::cover(s, px, py, &z);
        float id = s[22];
        bool after = (z > prev_z) || ((z == prev_z) && (id > prev_id));
        if (cover && after &&
            (z < best_z || (z == best_z && id < best_id))) {
          best_z = z;
          best_id = id;
          best_pos = c * chunk_t + t;
        }
      }
    }

    // Resolve: the winner's row and attributes (+ 0.0f as the one-hot
    // matmul's sum with zeros), zeros when nothing covers the pixel.
    float a12 = 0.0f, a13 = 0.0f, a14 = 0.0f, a16 = 0.0f, a17 = 0.0f,
          a18 = 0.0f, a19 = 0.0f, a20 = 0.0f, a21 = 0.0f;
    float at[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) at[k] = 0.0f;
    const bool has = best_id < kBigId;
    if (has) {
      const float* r = env_rows + (size_t)best_pos * kRowCols;
      const float* a = env_attrs + (size_t)best_pos * kAttrCols;
      a12 = r[12] + 0.0f;
      a13 = r[13] + 0.0f;
      a14 = r[14] + 0.0f;
      a16 = r[16] + 0.0f;
      a17 = r[17] + 0.0f;
      a18 = r[18] + 0.0f;
      a19 = r[19] + 0.0f;
      a20 = r[20] + 0.0f;
      a21 = r[21] + 0.0f;
#pragma unroll
      for (int k = 0; k < 10; ++k) at[k] = a[k] + 0.0f;
    }
    float slam = a12 * px + a13 * py + a14;
    float safe_slam = slam == 0.0f ? 1.0f : slam;
    if (p < P) {
      float* o = out + (((size_t)b * n_layers + layer) * kOutCh) * P + p;
      o[0 * P] = best_z;
      o[1 * P] = (a16 * px + a17 * py + a18) / safe_slam;
      o[2 * P] = (a19 * px + a20 * py + a21) / safe_slam;
      o[3 * P] = at[9] / safe_slam;
#pragma unroll
      for (int k = 0; k < 7; ++k) o[(4 + k) * P] = at[k];
      o[11 * P] = at[7];
      o[12 * P] = at[8];
      o[13 * P] = has ? 1.0f : 0.0f;
      o[14 * P] = 0.0f;
      o[15 * P] = 0.0f;
    }
    prev_z = best_z;
    prev_id = best_id;
  }
}

}  // namespace

extern "C" int tdt_peel_resolve(const void* rows, const void* attrs,
                                const void* grid, const void* chunk_bounds,
                                void* out, int B, int T_pad, int P, int P_pad,
                                int n_layers, int tile_p, int chunk_t,
                                void* stream) {
  if (chunk_t > kMaxChunk || tile_p > 1024 || tile_p % 32 != 0 ||
      P_pad % tile_p != 0 || T_pad % chunk_t != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid_dim(P_pad / tile_p, B);
  peel_resolve_kernel<<<grid_dim, tile_p, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)attrs, (const float*)grid,
      (const float*)chunk_bounds, (float*)out, T_pad, P, P_pad, n_layers,
      tile_p, chunk_t);
  return (int)cudaGetLastError();
}
