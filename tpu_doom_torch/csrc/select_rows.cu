// Kernel B4: exact f32 row select, out[b, c, n] = tab[b, idx[b, n], c].
//
// Replaces tpu_doom/ops/raster_pallas.py:select_rows_pallas (kernel
// _select_rows_kernel), which the big-level walk vmaps over envs. The TPU
// kernel builds an in-VMEM one-hot per 128-row block and multiplies it
// with a 3-way bf16 split of the table on the MXU; the split exists only
// because the MXU takes bf16. Here the select is a direct load. The
// one-hot sum adds the selected row to zeros, which turns a -0.0 entry
// into +0.0; `+ 0.0f` reproduces that (nvcc keeps it: no fast math).
// The plain version is tpu_doom_torch/ops/raster.py:select_rows_ref.
//
// Bound: bytes written. On :texstress: x 256 envs at 320x200 the walk
// selects 74 columns at N = 24 x 320 crossings per env: 256 x 74 x 7680
// x 4 B = 582 MB of output per frame. Each env's compacted table (448 x
// 74 f32 = 132 KB) is read through L2.
//
// Design: one block per (tile of kTileN positions, env). Stage 1 reads
// the tile's kTileN selected rows into shared memory with the lanes
// along a row (a row is C contiguous floats, so the read coalesces);
// stage 2 writes them transposed, lanes along n, so each output plane
// out[b, c, :] is written contiguously. The row pitch C + 1 keeps both
// stages free of shared-memory bank conflicts for C = 74.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 64;
constexpr int kThreads = 256;

__global__ void select_rows_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ tab,
                                   float* __restrict__ out, int N, int S,
                                   int C) {
  extern __shared__ float rows[];  // kTileN x (C + 1)
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int ld = C + 1;
  const int32_t* ib = idx + (size_t)b * N;
  const float* tb = tab + (size_t)b * S * C;
  for (int i = threadIdx.x; i < kTileN * C; i += blockDim.x) {
    const int r = i / C;
    const int c = i - r * C;
    const int n = n0 + r;
    if (n < N) {
      const int s = min(max((int)ib[n], 0), S - 1);  // a clamped gather
      rows[r * ld + c] = tb[(size_t)s * C + c];
    }
  }
  __syncthreads();
  float* ob = out + (size_t)b * C * N;
  for (int i = threadIdx.x; i < C * kTileN; i += blockDim.x) {
    const int c = i / kTileN;
    const int r = i - c * kTileN;
    const int n = n0 + r;
    if (n < N) ob[(size_t)c * N + n] = rows[r * ld + c] + 0.0f;
  }
}

}  // namespace

extern "C" int tdt_select_rows(const void* idx, const void* tab, void* out,
                               int B, int N, int S, int C, void* stream) {
  const size_t smem = (size_t)kTileN * (C + 1) * sizeof(float);
  dim3 grid((N + kTileN - 1) / kTileN, B);
  select_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)tab, (float*)out, N, S, C);
  return (int)cudaGetLastError();
}
