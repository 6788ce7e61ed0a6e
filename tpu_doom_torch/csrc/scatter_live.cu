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
// atomics here, whose order changes from run to run, and the warp's
// counts added as one term, still equal the plain version bit for bit.
// (For general float weights the order would matter; the walk never
// passes them.)
//
// Bound: the bytes, N = 24 x 320 idx and live values per env read once
// and S = 448 (:texstress:) counts written once: 16.2 MB at 256 envs,
// about 5 us at 3.35 TB/s, so one launch's latency is most of it.
//
// Design: one block of 1,024 threads per env with a shared-memory
// histogram of S floats; two blocks fit an SM, so the walk's 256 envs
// run in one wave and each thread adds 8 elements (two quads).
// The walk's idx row is its (K, W) crossings with W innermost, so
// neighbouring columns mostly hit the same seg and a warp's 32 lanes
// often one or two counters, which shared atomics serialise. So each
// warp first groups its lanes by seg (`__match_any_sync`) and, where
// every live value in the warp is 0 or 1, one lane of each group adds
// the group's count (a popcount) in one atomic; other values fall back
// to one atomic per lane. Loads are 16 bytes of idx and of live per
// thread, two quads in flight, with scalar head and tail elements where
// a row does not start on 16 bytes (N % 4 != 0) or the two rows are
// misaligned. Every count is written, so the output needs no zeroing.
// Where S outgrows 48 KB of shared memory, a second kernel adds straight
// into the (zeroed) output with the same warp groups and global atomics,
// one block per (tile of n, env). Zero terms are skipped in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;  // quads of idx and of live in flight per thread
constexpr int kGlobalThreads = 256;
constexpr size_t kSmemMax = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Adds live value v at seg s into counts[0, S). Every lane of the warp
// calls it together (warp-uniform control flow); a lane with nothing to
// add passes v = 0.
__device__ __forceinline__ void add_live(float* counts, int s, float v, int S) {
  const bool valid = v != 0.0f && s >= 0 && s < S;
  const unsigned peers = __match_any_sync(kFull, valid ? s : -1);
  if (__all_sync(kFull, !valid || v == 1.0f)) {
    // Each group's lanes all hold 1: one add of the group's size.
    if (valid && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&counts[s], (float)__popc(peers));
  } else if (valid) {
    atomicAdd(&counts[s], v);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_live_kernel(const int32_t* __restrict__ idx,
                    const float* __restrict__ live,
                    float* __restrict__ out, int N, int S) {
  extern __shared__ float hist[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x; s < S; s += blockDim.x) hist[s] = 0.0f;
  __syncthreads();
  const int32_t* ib = idx + (size_t)b * N;
  const float* lb = live + (size_t)b * N;

  // Quads from `head`, where both rows reach 16 bytes, to `tail`.
  int head = N, n4 = 0;
  if ((((uintptr_t)ib ^ (uintptr_t)lb) & 15) == 0) {
    head = min(N, (int)(((16 - ((uintptr_t)ib & 15)) & 15) >> 2));
    n4 = (N - head) >> 2;
  }
  const int tail = head + 4 * n4;
  const int4* iq = reinterpret_cast<const int4*>(ib + head);
  const float4* lq = reinterpret_cast<const float4*>(lb + head);
  const int step = blockDim.x;
  // The loop bound is tested on the warp's first lane, so that every
  // lane of a warp runs the same iterations (the warp intrinsics). Each
  // thread loads its kUnroll quads of idx and live first, so one memory
  // latency covers them all (the walk's 1,920 quads per env are one
  // iteration of 1,024 threads).
  for (int q0 = threadIdx.x; q0 - lane < n4; q0 += kUnroll * step) {
    int4 iv[kUnroll];
    float4 lv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * step;
      iv[u] = make_int4(-1, -1, -1, -1);
      lv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < n4) {
        iv[u] = __ldg(iq + q);
        lv[u] = __ldg(lq + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!__any_sync(kFull, q0 + u * step < n4)) break;
      add_live(hist, iv[u].x, lv[u].x, S);
      add_live(hist, iv[u].y, lv[u].y, S);
      add_live(hist, iv[u].z, lv[u].z, S);
      add_live(hist, iv[u].w, lv[u].w, S);
    }
  }
  // The scalar head [0, head) and tail [tail, N).
  const int rest = head + (N - tail);
  for (int i = threadIdx.x; i - lane < rest; i += step) {
    int s = -1;
    float v = 0.0f;
    if (i < rest) {
      const int n = i < head ? i : tail + (i - head);
      s = ib[n];
      v = lb[n];
    }
    add_live(hist, s, v, S);
  }
  __syncthreads();
  float* ob = out + (size_t)b * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) ob[s] = hist[s];
}

__global__ void __launch_bounds__(kGlobalThreads)
scatter_live_global_kernel(const int32_t* __restrict__ idx,
                           const float* __restrict__ live,
                           float* __restrict__ out, int N, int S) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  int s = -1;
  float v = 0.0f;
  if (n < N) {
    s = idx[(size_t)b * N + n];
    v = live[(size_t)b * N + n];
  }
  add_live(out + (size_t)b * S, s, v, S);
}

}  // namespace

// On the shared-memory path (S * 4 bytes <= 48 KB) every count is
// written; on the global path `out` must hold zeros on entry.
extern "C" int tdt_scatter_live(const void* idx, const void* live, void* out,
                                int B, int N, int S, void* stream) {
  const size_t smem = (size_t)S * sizeof(float);
  if (smem <= kSmemMax) {
    scatter_live_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)live, (float*)out, N, S);
  } else {
    dim3 grid((N + kGlobalThreads - 1) / kGlobalThreads, B);
    scatter_live_global_kernel<<<grid, kGlobalThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)live, (float*)out, N, S);
  }
  return (int)cudaGetLastError();
}
