// Kernel B10: the texel-table lookup on its own, as a measuring instrument.
//
// Replaces tools/onehotbench.py:run (kernel _kernel), which timed the TPU's
// one-hot MXU lookup of the compact texel table. Function: for every grid
// step g and position j, with i = idx[j],
//   out[g, j] = sum over it < iters of tab[(i >> 7) + it, i & 127],
// a row at or past S adding 0 (no one-hot row matches it there). The plain
// version is tpu_doom_torch/tools/onehotbench.py:lookup_ref.
//
// Hopper has indexed loads, so the variants are ways to read the table,
// not ways to build a one-hot:
//   ldg  (0): each thread reads its texel through the read-only path
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
// Design: one thread per output element, a grid-stride loop over the
// flattened (grid, n) output with as many 256-thread blocks as fit on the
// card at once (for smem, as many as the table's shared memory allows), so
// that smem stages the table once per resident block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLdg = 0;
constexpr int kSmem = 1;
constexpr int kCopy = 2;

template <int kVariant>
__global__ void onehot_lookup_kernel(const int32_t* __restrict__ idx,
                                     const int8_t* __restrict__ tab,
                                     int32_t* __restrict__ out, int n, int S,
                                     int iters, int total) {
  extern __shared__ int4 smem_tab[];
  if constexpr (kVariant == kSmem) {
    const int4* src = reinterpret_cast<const int4*>(tab);
    for (int i = threadIdx.x; i < S * 8; i += blockDim.x)
      smem_tab[i] = __ldg(src + i);
    __syncthreads();
  }
  const int8_t* stab = reinterpret_cast<const int8_t*>(smem_tab);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int i = __ldg(idx + e % n);
    const int hi = i >> 7, lo = i & 127;
    int acc = 0;
    for (int it = 0; it < iters; ++it) {
      if constexpr (kVariant == kCopy) {
        acc += lo;
      } else {
        const int r = hi + it;
        if (r >= 0 && r < S) {
          if constexpr (kVariant == kSmem)
            acc += (int)stab[r * 128 + lo];
          else
            acc += (int)__ldg(tab + r * 128 + lo);
        }
      }
    }
    out[e] = acc;
  }
}

template <int kVariant>
int launch(const void* idx, const void* tab, void* out, int n, int S,
           int iters, int total, cudaStream_t stream) {
  auto kernel = onehot_lookup_kernel<kVariant>;
  const size_t smem = kVariant == kSmem ? (size_t)S * 128 : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = ((long long)total + kThreads - 1) / kThreads;
  const long long fit = (long long)per_sm * sms;
  const int blocks = (int)(want < fit ? want : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(
      (const int32_t*)idx, (const int8_t*)tab, (int32_t*)out, n, S, iters,
      total);
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

// idx (n,) i32, tab (S, 128) s8 (16-byte aligned), out (grid, n) i32 with
// grid * n < 2^31.
extern "C" int tdt_onehot_lookup(const void* idx, const void* tab, void* out,
                                 int n, int S, int iters, int grid,
                                 int variant, void* stream) {
  const int total = n * grid;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kLdg:
      return launch<kLdg>(idx, tab, out, n, S, iters, total, s);
    case kSmem:
      return launch<kSmem>(idx, tab, out, n, S, iters, total, s);
    case kCopy:
      return launch<kCopy>(idx, tab, out, n, S, iters, total, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
