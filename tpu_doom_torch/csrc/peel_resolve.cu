// Kernel B3: K-layer depth peel + attribute resolve.
//
// Replaces tpu_doom/ops/raster_pallas.py:peel_resolve_pallas (kernel
// _peel_resolve_kernel). The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:peel_resolve_ref), built with --fmad=false.
//
// Bound on the H100: bytes, the (B, K, 16, P) channels written; the
// coverage tests the function needs (one per covering (pixel, triangle)
// pair) come far below.
//
// Design (peel.cuh), three launches on the caller's stream:
//   * peel_bounds_kernel computes the plain version's window-y cull
//     bounds, one warp per run of tile_p pixels and per chunk of chunk_t
//     rows, as `_tile_ybounds` / `_chunk_ybounds` do (a wrapper doing it
//     with a dozen small torch operations spent more host time than the
//     peel takes);
//   * the binning pass lists each 64 x 64 bin's rows that may cover it;
//   * peel_resolve_kernel: one block per 32 x 8 pixel tile and env, one
//     thread per pixel, one sweep over its bin's rows for up to 8 layers.
//     A listed row is loaded only if its chunk's bounds meet the window-y
//     range some pixel of the tile admits; it is then culled exactly
//     against the tile's box, and the survivors are compacted into shared
//     memory with their id, position and chunk bounds. Each thread tests
//     the survivors its own pixel's run admits (the plain version's cull,
//     pixel by pixel, so the kernel's tiling changes no result), keeps its
//     K nearest (z, id, position) sorted in registers, and after the sweep
//     resolves each layer from the winner's row and attributes, loaded
//     directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "peel.cuh"

namespace {

using peel::kEntry;
using peel::kThreads;

constexpr int kRowCols = 24;
constexpr int kAttrCols = 16;
constexpr int kOutCh = 16;
constexpr float kBigId = 1073741824.0f;  // 2**30

// torch.amin / amax: NaN if either is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// out[w] for warp w: w < n_runs, [least py - 1, largest py + 1] over run w
// of tile_p pixels of the grid padded with zeros; then, for env b and
// chunk c of chunk_t rows, [least ymin, largest ymax] at n_runs + b *
// n_chunks + c (the last chunk's padding rows, (inf, -inf), change nothing).
__global__ void peel_bounds_kernel(const float* __restrict__ grid_y,
                                   const float2* __restrict__ ybounds,
                                   float2* __restrict__ out, int B, int T,
                                   int P, int tile_p, int chunk_t, int n_runs,
                                   int n_chunks) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_runs + (long long)B * n_chunks) return;  // the whole warp
  float lo = __int_as_float(0x7f800000), hi = -lo;
  if (w < n_runs) {
    for (long long j = w * tile_p + lane; j < (w + 1) * tile_p; j += 32) {
      const float y = j < P ? grid_y[j] : 0.0f;
      lo = nan_min(lo, y);
      hi = nan_max(hi, y);
    }
  } else {
    const long long b = (w - n_runs) / n_chunks, c = (w - n_runs) % n_chunks;
    const long long end = (c + 1) * chunk_t < T ? (c + 1) * chunk_t : T;
    for (long long j = c * chunk_t + lane; j < end; j += 32) {
      const float2 v = ybounds[b * T + j];
      lo = nan_min(lo, v.x);
      hi = nan_max(hi, v.y);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0)
    out[w] = w < n_runs ? make_float2(lo - 1.0f, hi + 1.0f) : make_float2(lo, hi);
}

template <int D>
__global__ void __launch_bounds__(kThreads) peel_resolve_kernel(
    const float* __restrict__ rows, const float* __restrict__ attrs,
    const float* __restrict__ grid, const int* __restrict__ list,
    const int* __restrict__ count, const float2* __restrict__ run_bounds,
    const float2* __restrict__ chunk_bounds, float* __restrict__ out, int T,
    int P, int width, int n_layers, int tile_p, int chunk_t) {
  __shared__ float4 stage[kThreads * kEntry];
  __shared__ int counts[peel::kWarps];
  __shared__ float red[peel::kWarps * 6];
  const peel::Image im(width, P);
  const int b = blockIdx.y;
  const float inf = __int_as_float(0x7f800000);
  int bin;
  const int p = peel::tile_pixel(im, &bin);
  const bool valid = p >= 0;
  const float px = valid ? grid[p] : 0.0f, py = valid ? grid[P + p] : 0.0f;
  // The plain version's y-cull for this pixel: [py_min, py_max] of its run.
  const float2 yr = run_bounds[valid ? p / tile_p : 0];
  if (!__syncthreads_or(valid)) return;  // no pixel of the image in this tile
  float v[6] = {inf, inf, inf, inf, valid ? yr.x : inf, valid ? -yr.y : inf};
  peel::box_min(v, px, py, valid);
  peel::block_min(v, red);
  const peel::Box tile{v[0], -v[1], v[2], -v[3]};
  const float y_lo = v[4], y_hi = -v[5];

  const size_t cell = (size_t)b * im.bins + bin;
  const int listed = count[cell];
  const int* bin_rows = list + cell * T;
  const float* env_rows = rows + (size_t)b * T * kRowCols;
  const float* env_attrs = attrs + (size_t)b * T * kAttrCols;
  const float2* env_cb = chunk_bounds + (size_t)b * peel::ceil_div(T, chunk_t);
  float prev_z = -inf, prev_id = -1.0f;
  for (int k0 = 0; k0 < n_layers; k0 += D) {
    peel::Layers<D, float> lay;
    lay.clear(kBigId);
    for (int g0 = 0; g0 < listed; g0 += kThreads) {
      float4 e[kEntry];
      bool keep = false;
      if (g0 + (int)threadIdx.x < listed) {
        const int r = bin_rows[g0 + threadIdx.x];
        const float2 cb = env_cb[r / chunk_t];
        if (cb.x <= y_hi && cb.y >= y_lo) {
#pragma unroll
          for (int k = 0; k < 4; ++k) e[k] = peel::row_quad(env_rows, kRowCols, r, k);
          // [id (column 22), position, chunk y-bounds]
          e[4] = make_float4(__ldg(env_rows + (size_t)r * kRowCols + 22),
                             __int_as_float(r), cb.x, cb.y);
          float s[16];
          peel::unpack(e, s);
          keep = peel::may_cover(s, tile);
        }
      }
      const int n = peel::compact(keep, e, stage, counts);
      for (int t = 0; t < n; ++t) {
        const float4* q = stage + t * kEntry;
        const float4 meta = q[4];
        if (!(meta.z <= yr.y && meta.w >= yr.x)) continue;
        float s[16], z;
        peel::unpack(q, s);
        if (!peel::cover(s, px, py, &z)) continue;
        if (peel::before(prev_z, prev_id, z, meta.x))
          lay.insert(z, meta.x, __float_as_int(meta.y), kBigId);
      }
    }

#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (!valid || k0 + j >= n_layers) break;
      // Resolve: the winner's row and attributes (+ 0.0f as the one-hot
      // matmul's sum with zeros), zeros when nothing covers the pixel.
      float a12 = 0.0f, a13 = 0.0f, a14 = 0.0f, a16 = 0.0f, a17 = 0.0f,
            a18 = 0.0f, a19 = 0.0f, a20 = 0.0f, a21 = 0.0f;
      float at[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) at[k] = 0.0f;
      const bool has = lay.id[j] < kBigId;
      if (has) {
        const float* r = env_rows + (size_t)lay.pos[j] * kRowCols;
        const float* a = env_attrs + (size_t)lay.pos[j] * kAttrCols;
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
      const float slam = a12 * px + a13 * py + a14;
      const float safe_slam = slam == 0.0f ? 1.0f : slam;
      float* o = out + (((size_t)b * n_layers + k0 + j) * kOutCh) * P + p;
      o[0 * P] = lay.z[j];
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
    prev_z = lay.z[D - 1];
    prev_id = lay.id[D - 1];
  }
}

}  // namespace

// bounds: float2 scratch of ceil(P / tile_p) + B * ceil(T / chunk_t); bins:
// int scratch of B * bins * (T + 1) (counts, then lists), bins from
// peel::Image.
extern "C" int tdt_peel_resolve(const void* rows, const void* attrs,
                                const void* grid, const void* ybounds,
                                void* bounds, void* bins, void* out, int B,
                                int T, int P, int width, int n_layers,
                                int tile_p, int chunk_t, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || P < 1 || width < 1 || n_layers < 1 ||
      tile_p < 1 || chunk_t < 1 || (uintptr_t)rows % 16 != 0 ||
      (uintptr_t)ybounds % 8 != 0 || (uintptr_t)bounds % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_runs = peel::ceil_div(P, tile_p);
  const int n_chunks = peel::ceil_div(T, chunk_t);
  const long long warps = n_runs + (long long)B * n_chunks;
  float2* run_bounds = (float2*)bounds;
  peel_bounds_kernel<<<(unsigned)peel::ceil_div(warps * 32, 256), 256, 0, s>>>(
      (const float*)grid + P, (const float2*)ybounds, run_bounds, B, T, P,
      tile_p, chunk_t, n_runs, n_chunks);
  const peel::Image im(width, P);
  int* count = (int*)bins;
  int* list = count + (size_t)B * im.bins;
  peel::bin_kernel<kRowCols><<<dim3(im.bins, B), kThreads, 0, s>>>(
      (const float*)rows, (const float*)grid, list, count, T, P, width);
  const dim3 grid_dim(im.tiles(), B);
  const auto launch = [&](auto kernel) {
    kernel<<<grid_dim, kThreads, 0, s>>>(
        (const float*)rows, (const float*)attrs, (const float*)grid, list,
        count, run_bounds, run_bounds + n_runs, (float*)out, T, P, width,
        n_layers, tile_p, chunk_t);
  };
  switch (peel::sweep_depth(n_layers)) {
    case 1: launch(peel_resolve_kernel<1>); break;
    case 2: launch(peel_resolve_kernel<2>); break;
    case 3: launch(peel_resolve_kernel<3>); break;
    case 4: launch(peel_resolve_kernel<4>); break;
    default: launch(peel_resolve_kernel<peel::kMaxDepth>); break;
  }
  return (int)cudaGetLastError();
}
