// Kernel B10: the texel-table lookup on its own, as a measuring instrument.
//
// Replaces tools/onehotbench.py:run (kernel _kernel), which timed the TPU's
// one-hot MXU lookup of the compact texel table. Function: for every grid
// step g and position j, with i = idx[j],
//   out[g, j] = sum over it < iters of tab[(i >> 7) + it, i & 127],
// a row outside [0, S) adding 0 (no one-hot row matches it there). The
// plain version is tpu_doom_torch/tools/onehotbench.py:lookup_ref.
//
// Hopper has indexed loads, so the variants are ways to read the table,
// not ways to build a one-hot:
//   ldg  (0): each thread reads its texels through the read-only path
//             (L1 / L2), as B2, B7 and B8 do (csrc/portal_shade.cuh);
//   smem (1): each block first stages the whole (S, 128) s8 table in
//             dynamic shared memory (16-byte copies) and reads it there;
//             above 48 KB that needs the opt-in attribute, and a table over
//             the card's opt-in maximum is refused by the wrapper;
//   copy (2): the floor: the same launch reads idx and writes
//             out = iters * (i & 127), with no table read.
//
// Bound: bytes. Per call the function reads idx (4 n bytes) and the table
// (S x 128 bytes) once and writes grid x n int32; one add per lookup.
//
// Design: one access in flight per thread (a 4-byte index, then its texel,
// then a 4-byte store, a modulo per element) kept the first version near
// 1.39 TB/s. Here a thread owns quads of 4 consecutive positions of an
// output row, its quads a block apart so that each warp instruction covers
// 512 contiguous bytes: it reads a quad's indices with one 16-byte
// streaming load, issues the quads' table reads together, and writes each
// quad's sums with one 16-byte streaming store. Rows g are a loop
// (blockIdx.y and up), so no position needs a modulo. ldg and copy give a
// thread one quad and launch a block per 1024 positions and row (rows
// past 65535 loop); smem launches only the blocks that fit on the card at
// once, each staging the table once and looping over the rest, so its
// threads own two quads each to keep 32 bytes each way in flight. The
// vector path needs idx 16-byte aligned and every output row too
// (n % 4 == 0, or one row); otherwise, and for the ragged last quad of a
// row, the same thread takes each position with scalar accesses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLdg = 0;
constexpr int kSmem = 1;
constexpr int kCopy = 2;

// Quads of 4 positions per thread, and positions per block and row.
__host__ __device__ constexpr int quads(int variant) {
  return variant == kSmem ? 2 : 1;
}
__host__ __device__ constexpr int block_positions(int variant) {
  return kThreads * 4 * quads(variant);
}

template <int kVariant>
__device__ __forceinline__ int texel(const int8_t* t, int r, int lo) {
  if constexpr (kVariant == kSmem)
    return t[r * 128 + lo];
  else
    return __ldg(t + r * 128 + lo);
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
    onehot_lookup_kernel(const int32_t* __restrict__ idx,
                         const int8_t* __restrict__ tab,
                         int32_t* __restrict__ out, int n, int S, int iters,
                         int grid, int vec) {
  extern __shared__ int4 smem_tab[];
  if constexpr (kVariant == kSmem) {
    const int4* src = reinterpret_cast<const int4*>(tab);
    for (int i = threadIdx.x; i < S * 8; i += blockDim.x)
      smem_tab[i] = __ldg(src + i);
    __syncthreads();
  }
  constexpr int kQuads = quads(kVariant), kPer = 4 * kQuads;
  constexpr int kBlockPos = block_positions(kVariant);
  const int8_t* t =
      kVariant == kSmem ? reinterpret_cast<const int8_t*>(smem_tab) : tab;
  const int nblk = (n + kBlockPos - 1) / kBlockPos;
  const int nq = vec ? n >> 2 : 0;  // whole quads of a row, vector path
  for (int g = blockIdx.y; g < grid; g += gridDim.y) {
    int32_t* row = out + (size_t)g * n;
    for (int b = blockIdx.x; b < nblk; b += gridDim.x) {
      int q[kQuads], i[kPer], acc[kPer];
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        q[k] = (b * kQuads + k) * kThreads + threadIdx.x;
        if (q[k] < nq) {
          const int4 v = __ldcs(reinterpret_cast<const int4*>(idx) + q[k]);
          i[4 * k] = v.x;
          i[4 * k + 1] = v.y;
          i[4 * k + 2] = v.z;
          i[4 * k + 3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = 4 * q[k] + c;
            i[4 * k + c] = p < n ? __ldcs(idx + p) : 0;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] = 0;
      if constexpr (kVariant == kCopy) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          acc[e] = (int)((unsigned)(i[e] & 127) * (unsigned)iters);
      } else {
        for (int it = 0; it < iters; ++it) {
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const int r = (i[e] >> 7) + it;
            acc[e] += (unsigned)r < (unsigned)S
                          ? texel<kVariant>(t, r, i[e] & 127)
                          : 0;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        if (q[k] < nq) {
          __stcs(reinterpret_cast<int4*>(row) + q[k],
                 make_int4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                           acc[4 * k + 3]));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = 4 * q[k] + c;
            if (p < n) __stcs(row + p, acc[4 * k + c]);
          }
        }
      }
    }
  }
}

template <int kVariant>
int launch(const void* idx, const void* tab, void* out, int n, int S,
           int iters, int grid, cudaStream_t stream) {
  auto kernel = onehot_lookup_kernel<kVariant>;
  const size_t smem = kVariant == kSmem ? (size_t)S * 128 : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  constexpr int kBlockPos = block_positions(kVariant);
  const int nblk = (n + kBlockPos - 1) / kBlockPos;
  int gx = nblk, gy = grid < 65535 ? grid : 65535;
  if (kVariant == kSmem) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int fit = per_sm * sms;
    gx = nblk < fit ? nblk : fit;
    const int rows = fit / gx;
    gy = grid < rows ? grid : rows;
  }
  const int vec =
      (uintptr_t)idx % 16 == 0 && (uintptr_t)out % 16 == 0 &&
      (n % 4 == 0 || grid == 1);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      (const int32_t*)idx, (const int8_t*)tab, (int32_t*)out, n, S, iters,
      grid, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest dynamic shared memory a block of the current device can opt
// in to, in bytes, written to *bytes.
extern "C" int tdt_smem_optin(void* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute((int*)bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// idx (n,) i32 (any 4-byte alignment), tab (S, 128) s8 (16-byte aligned),
// out (grid, n) i32 with 1 <= n and grid * n <= 2^30.
extern "C" int tdt_onehot_lookup(const void* idx, const void* tab, void* out,
                                 int n, int S, int iters, int grid,
                                 int variant, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kLdg:
      return launch<kLdg>(idx, tab, out, n, S, iters, grid, s);
    case kSmem:
      return launch<kSmem>(idx, tab, out, n, S, iters, grid, s);
    case kCopy:
      return launch<kCopy>(idx, tab, out, n, S, iters, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
