// Kernel B9: K-layer (z, id) depth peel.
//
// Replaces tpu_doom/ops/raster_pallas.py:depth_peel_pallas (kernel
// _peel_kernel): the peel of the `jnp` triangle path (and of the
// `portal_jnp` configuration's fallback), B3's peel without the resolve.
// Ids are positions in the row order; layer k holds, per pixel, the
// (k+1)-th least (z, id) among the covering triangles, each with its own
// z. The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:depth_peel_ref), built with --fmad=false.
//
// Bound on the H100: bytes (the z and id planes written), unless a pixel
// is covered by very many triangles: the function needs one coverage test
// per covering (pixel, triangle) pair, five 3-term dot products each.
//
// Design (peel.cuh), two launches: the binning pass lists each 64 x 64
// bin's rows that may cover it; then one block per 32 x 8 pixel tile and
// env, one thread per pixel, one sweep over its bin's rows for up to 8
// layers. Each group of 256 listed rows is loaded one row per thread,
// culled exactly against the tile's box, and the survivors compacted into
// shared memory; every thread then tests only those, and keeps its K
// nearest (z, id) sorted in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "peel.cuh"

namespace {

using peel::kEntry;
using peel::kThreads;

constexpr int kRowCols = 16;
constexpr int kBigId = 1 << 30;

template <int D>
__global__ void __launch_bounds__(kThreads)
    depth_peel_kernel(const float* __restrict__ rows,
                      const float* __restrict__ grid,
                      const int* __restrict__ list,
                      const int* __restrict__ count, float* __restrict__ out_z,
                      int32_t* __restrict__ out_id, int T, int P, int width,
                      int n_layers) {
  __shared__ float4 stage[kThreads * kEntry];
  __shared__ int counts[peel::kWarps];
  __shared__ float red[peel::kWarps * 4];
  const peel::Image im(width, P);
  const int b = blockIdx.y;
  const float inf = __int_as_float(0x7f800000);
  int bin;
  const int p = peel::tile_pixel(im, &bin);
  const bool valid = p >= 0;
  const float px = valid ? grid[p] : 0.0f, py = valid ? grid[P + p] : 0.0f;
  if (!__syncthreads_or(valid)) return;  // no pixel of the image in this tile
  float v[4] = {inf, inf, inf, inf};
  peel::box_min(v, px, py, valid);
  peel::block_min(v, red);
  const peel::Box tile{v[0], -v[1], v[2], -v[3]};

  const size_t cell = (size_t)b * im.bins + bin;
  const int listed = count[cell];
  const int* bin_rows = list + cell * T;
  const float* env_rows = rows + (size_t)b * T * kRowCols;
  float prev_z = -inf;
  int prev_id = -1;
  for (int k0 = 0; k0 < n_layers; k0 += D) {
    peel::Layers<D, int> lay;
    lay.clear(kBigId);
    for (int g0 = 0; g0 < listed; g0 += kThreads) {
      float4 e[kEntry];
      bool keep = false;
      if (g0 + (int)threadIdx.x < listed) {
        const int r = bin_rows[g0 + threadIdx.x];
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = peel::row_quad(env_rows, kRowCols, r, k);
        e[4] = make_float4(__int_as_float(r), 0.0f, 0.0f, 0.0f);
        float s[16];
        peel::unpack(e, s);
        keep = peel::may_cover(s, tile);
      }
      const int n = peel::compact(keep, e, stage, counts);
      for (int t = 0; t < n; ++t) {
        const float4* q = stage + t * kEntry;
        float s[16], z;
        peel::unpack(q, s);
        if (!peel::cover(s, px, py, &z)) continue;
        const int id = __float_as_int(q[4].x);
        if (peel::before(prev_z, prev_id, z, id)) lay.insert(z, id, id, kBigId);
      }
    }
    if (valid) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (k0 + j >= n_layers) break;
        const size_t o = ((size_t)b * n_layers + k0 + j) * P + p;
        out_z[o] = lay.z[j];
        out_id[o] = lay.id[j];
      }
    }
    prev_z = lay.z[D - 1];
    prev_id = lay.id[D - 1];
  }
}

}  // namespace

// bins: int scratch of B * bins * (T + 1) (counts, then lists), bins from
// peel::Image.
extern "C" int tdt_depth_peel(const void* rows, const void* grid, void* bins,
                              void* out_z, void* out_id, int B, int T, int P,
                              int width, int n_layers, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || P < 1 || width < 1 || n_layers < 1 ||
      (uintptr_t)rows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const peel::Image im(width, P);
  int* count = (int*)bins;
  int* list = count + (size_t)B * im.bins;
  peel::bin_kernel<kRowCols><<<dim3(im.bins, B), kThreads, 0, s>>>(
      (const float*)rows, (const float*)grid, list, count, T, P, width);
  const dim3 grid_dim(im.tiles(), B);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_dim, kThreads, 0, s>>>(
        (const float*)rows, (const float*)grid, list, count, (float*)out_z,
        (int32_t*)out_id, T, P, width, n_layers);
  };
  switch (peel::sweep_depth(n_layers)) {
    case 1: launch(depth_peel_kernel<1>); break;
    case 2: launch(depth_peel_kernel<2>); break;
    case 3: launch(depth_peel_kernel<3>); break;
    case 4: launch(depth_peel_kernel<4>); break;
    default: launch(depth_peel_kernel<peel::kMaxDepth>); break;
  }
  return (int)cudaGetLastError();
}
