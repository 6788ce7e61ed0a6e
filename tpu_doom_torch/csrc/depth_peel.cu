// Kernel B9: K-layer (z, id) depth peel.
//
// Replaces tpu_doom/ops/raster_pallas.py:depth_peel_pallas (kernel
// _peel_kernel): the peel of the `jnp` triangle path (and of the
// `portal_jnp` configuration's fallback), B3's peel without the resolve.
// Ids are positions in the row order; each layer keeps, per pixel, the
// lexicographically least (z, id) among the covering triangles that come
// after the previous layer's. The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:depth_peel_ref), built with --fmad=false;
// the coverage test is B3's (peel.cuh).
//
// Bound on the H100: operations. Every (pixel, triangle, layer) is one
// coverage test of five 3-term dot products; at 8 envs x 64000 px x 224
// triangles x 3 layers that is ~344 M tests, against ~6 MB of rows, grid
// and output. Design: one block per (pixel tile, env), one thread per
// pixel; each chunk of rows is staged in shared memory and read by every
// thread as a broadcast; the running best (z, id) stays in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "peel.cuh"

namespace {

using peel::kMaxChunk;

constexpr int kRowCols = 16;
constexpr int kBigId = 1 << 30;

__global__ void depth_peel_kernel(const float* __restrict__ rows,
                                  const float* __restrict__ grid,
                                  float* __restrict__ out_z,
                                  int32_t* __restrict__ out_id, int T_pad,
                                  int P, int P_pad, int n_layers,
                                  int chunk_t) {
  __shared__ float sh_rows[kMaxChunk * kRowCols];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  const float inf = __int_as_float(0x7f800000);
  const float px = grid[p];
  const float py = grid[P_pad + p];
  const float* env_rows = rows + (size_t)b * T_pad * kRowCols;

  float prev_z = -inf;
  int prev_id = -1;
  for (int layer = 0; layer < n_layers; ++layer) {
    float best_z = inf;
    int best_id = kBigId;
    for (int c0 = 0; c0 < T_pad; c0 += chunk_t) {
      __syncthreads();  // previous chunk's rows no longer in use
      for (int i = tid; i < chunk_t * kRowCols; i += blockDim.x)
        sh_rows[i] = env_rows[(size_t)c0 * kRowCols + i];
      __syncthreads();
      for (int t = 0; t < chunk_t; ++t) {
        float z;
        if (!peel::cover(sh_rows + t * kRowCols, px, py, &z)) continue;
        const int id = c0 + t;
        const bool after = (z > prev_z) || ((z == prev_z) && (id > prev_id));
        if (after && (z < best_z || (z == best_z && id < best_id))) {
          best_z = z;
          best_id = id;
        }
      }
    }
    if (p < P) {
      const size_t o = ((size_t)b * n_layers + layer) * P + p;
      out_z[o] = best_z;
      out_id[o] = best_id;
    }
    prev_z = best_z;
    prev_id = best_id;
  }
}

}  // namespace

extern "C" int tdt_depth_peel(const void* rows, const void* grid, void* out_z,
                              void* out_id, int B, int T_pad, int P, int P_pad,
                              int n_layers, int tile_p, int chunk_t,
                              void* stream) {
  if (chunk_t < 1 || chunk_t > kMaxChunk || tile_p < 32 || tile_p > 1024 ||
      tile_p % 32 != 0 ||
      P_pad % tile_p != 0 || T_pad % chunk_t != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid_dim(P_pad / tile_p, B);
  depth_peel_kernel<<<grid_dim, tile_p, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)grid, (float*)out_z, (int32_t*)out_id,
      T_pad, P, P_pad, n_layers, chunk_t);
  return (int)cudaGetLastError();
}
