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
// x 4 B = 582 MB of output per frame, which passes the 50 MB L2 once.
// Each env's compacted table (448 x 74 f32 = 132 KB) is read through L2.
//
// Design: one block per (tile of kTileN positions, env), in three stages.
//  1. Each position's index is read once, clamped, and kept in shared
//     memory.
//  2. Warp w copies the tile's rows w, w + 8, ... into shared memory with
//     the lanes along C (one coalesced read of the row's C floats per
//     chunk of 32 columns), as asynchronous copies (cp.async): a thread
//     issues all of its copies before it waits for any, so the table's
//     L2 latency is paid about once per block, not once per row.
//  3. Warp w writes output planes w, w + 8, ...: lane l writes positions
//     4l .. 4l + 3 of the plane (and 4l + 128 .. on a wider tile) as one
//     16-byte streaming store, so a warp writes 512 contiguous bytes of
//     the plane's run at once, `+ 0.0f`
//     applied on the way out. A ragged tail, or N not a multiple of 4,
//     takes 4-byte stores.
// Shared layout: row r of the tile at rows[r * Cp + (c ^ (r >> 2 & 31))],
// Cp = C rounded up to 32. The XOR keeps stage 2's copies (lanes along c,
// one r) and stage 3's loads (lanes along r >> 2, one c) each on 32
// distinct banks. At C = 74 the tile takes 49.7 KB, above the 48 KB a
// launch gets without the opt-in, which tdt_select_rows asks for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;  // positions per block: 512-byte plane runs
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r >> 2) & 31); }

// A 4-byte asynchronous copy from global to shared memory (a copy, so
// bitwise), and the wait for all of this thread's copies.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) select_rows_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ tab,
    float* __restrict__ out, int N, int S, int C, int Cp) {
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // kTileN
  float* rows = smem + kTileN;                // kTileN x Cp, swizzled
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int nt = min(kTileN, N - n0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < nt; i += kThreads)
    s_idx[i] = min(max(idx[(size_t)b * N + n0 + i], 0), S - 1);  // a clamped gather
  __syncthreads();

  const float* tb = tab + (size_t)b * S * C;
  for (int r = warp; r < nt; r += kWarps) {
    const float* src = tb + (size_t)s_idx[r] * C;
    for (int c = lane; c < C; c += 32) copy_async4(rows + r * Cp + swz(r, c), src + c);
  }
  wait_copies();
  __syncthreads();

  float* ob = out + (size_t)b * C * N + n0;
  for (int c = warp; c < C; c += kWarps) {
    for (int q = lane; 4 * q < nt; q += 32) {
      const int n = 4 * q;
      float* dst = ob + (size_t)c * N + n;
      if ((N & 3) == 0 && n + 4 <= nt) {
        // Rows n .. n + 3 share r >> 2 == q, so one swizzled column.
        const int sc = c ^ (q & 31);
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(rows[n * Cp + sc] + 0.0f, rows[(n + 1) * Cp + sc] + 0.0f,
                           rows[(n + 2) * Cp + sc] + 0.0f,
                           rows[(n + 3) * Cp + sc] + 0.0f));
      } else {
        for (int j = 0; j < 4 && n + j < nt; ++j)
          __stcs(dst + j, rows[(n + j) * Cp + swz(n + j, c)] + 0.0f);
      }
    }
  }
}

}  // namespace

// Shared memory of one block for C columns.
static size_t select_smem(int C) {
  const int Cp = (C + 31) / 32 * 32;
  return (size_t)kTileN * sizeof(int) + (size_t)kTileN * Cp * sizeof(float);
}

extern "C" int tdt_select_rows(const void* idx, const void* tab, void* out,
                               int B, int N, int S, int C, void* stream) {
  const size_t smem = select_smem(C);
  if (smem > kStaticSmem) {
    // Above 48 KB only with the opt-in; a card that refuses it fails the
    // call here, and nothing is launched. The refusal is also the runtime's
    // last error, which is cleared so that no later launch reports it.
    const cudaError_t err = cudaFuncSetAttribute(
        select_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  dim3 grid((N + kTileN - 1) / kTileN, B);
  select_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)tab, (float*)out, N, S, C,
      (C + 31) / 32 * 32);
  return (int)cudaGetLastError();
}
