// Kernel B6: seg-live counts, cnt[b, s] = sum of live[b, n] over the
// positions n with idx[b, n] == s.
//
// Replaces tpu_doom/ops/raster_pallas.py:scatter_live_pallas (kernel
// _scatter_live_kernel), which the active-set walk vmaps over envs. The
// TPU kernel multiplies an in-VMEM one-hot block by the live row and sums
// along lanes; here it is a histogram. Positions whose idx lies outside
// [0, S) add nothing, as they match no one-hot row there. The plain
// version is tpu_doom_torch/ops/raster.py:scatter_live_ref.
//
// Exactness: the walk's live values are 0 or 1, so every partial sum is
// an integer below 2^24 and exact in f32 in any order. That is why the
// atomics here, whose order changes from run to run, still equal the
// plain version bit for bit. (For general float weights the order would
// matter; the walk never passes them.)
//
// Bound: N = 24 x 320 reads per env, S = 448 (:texstress:) or 704
// (:stress:) counters: launch-bound at 256 envs.
//
// Design: one block per env with a shared-memory histogram of S floats
// and shared atomics, then one coalesced write of the S counts. Where S
// outgrows 48 KB of shared memory, a second kernel adds straight into
// the (zeroed) output with global atomics, one block per (tile of n,
// env). Zero terms are skipped in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemMax = 48 * 1024;

__global__ void scatter_live_kernel(const int32_t* __restrict__ idx,
                                    const float* __restrict__ live,
                                    float* __restrict__ out, int N, int S) {
  extern __shared__ float hist[];
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) hist[s] = 0.0f;
  __syncthreads();
  const int32_t* ib = idx + (size_t)b * N;
  const float* lb = live + (size_t)b * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float v = lb[n];
    const int s = ib[n];
    if (v != 0.0f && s >= 0 && s < S) atomicAdd(&hist[s], v);
  }
  __syncthreads();
  float* ob = out + (size_t)b * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) ob[s] = hist[s];
}

__global__ void scatter_live_global_kernel(const int32_t* __restrict__ idx,
                                           const float* __restrict__ live,
                                           float* __restrict__ out, int N,
                                           int S) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float v = live[(size_t)b * N + n];
  const int s = idx[(size_t)b * N + n];
  if (v != 0.0f && s >= 0 && s < S) atomicAdd(&out[(size_t)b * S + s], v);
}

}  // namespace

// `out` must hold zeros on entry (the global-atomics variant adds into it).
extern "C" int tdt_scatter_live(const void* idx, const void* live, void* out,
                                int B, int N, int S, void* stream) {
  const size_t smem = (size_t)S * sizeof(float);
  if (smem <= kSmemMax) {
    scatter_live_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)live, (float*)out, N, S);
  } else {
    dim3 grid((N + kThreads - 1) / kThreads, B);
    scatter_live_global_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)live, (float*)out, N, S);
  }
  return (int)cudaGetLastError();
}
