// Kernel B8: the portal renderer's per-pixel shade on classified channels.
//
// Replaces tpu_doom/ops/raster_pallas.py:shade_portal_pallas (kernel
// _shade_kernel): stage 2 of B2 on its own, over flattened pixels, run by
// the `portal_jnp` configuration after B7. The arithmetic is the plain
// version's (tpu_doom_torch/ops/raster.py:shade_portal_ref), built with
// --fmad=false; the address, light-row and output code is B2's
// (portal_shade.cuh). The TPU's two one-hot MXU lookup stages over the
// compact tables are direct indexed loads here.
//
// Bound on the H100: bytes. At 256 envs x 64000 px the kernel reads 721 MB
// of channels, 131 MB of ray directions and 66 MB of sky, and writes
// 131 MB (~0.31 ms at 3.35 TB/s). Design: one thread per pixel, 256 pixels
// of one env per block, every plane read and written along pixels
// (coalesced); the three tables (85 KB on :test:) are read through the
// read-only cache, where they stay. A pixel reads the channels and tables
// its kind uses (portal_shade.cuh): the kind alone where nothing covers
// it, the kind and the sky image on the sky.

#include <cuda_runtime.h>
#include <stdint.h>

#include "portal_shade.cuh"

namespace {

using namespace portal;

constexpr int kBlock = 256;

__global__ void shade_portal_kernel(
    const float* __restrict__ ch, const float* __restrict__ dxz,
    const float* __restrict__ ndc_y, const float* __restrict__ sky,
    const float* __restrict__ cam, const float* __restrict__ shear,
    const int8_t* __restrict__ tex, const int8_t* __restrict__ hole,
    const int8_t* __restrict__ cmap, float* __restrict__ out_idx,
    float* __restrict__ out_cov, int P, int S1, float p11, int n_rows) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const float* chb = ch + (size_t)b * kOutCh * P + p;
  const size_t o = (size_t)b * P + p;
  const float kind = chb[0];
  if (!reads_texel(kind)) {
    shade_untextured(kind, sky + o, out_idx + o, out_cov + o);
    return;
  }
  float c[kOutCh];
  c[0] = kind;
#pragma unroll
  for (int k = 1; k < kOutCh; ++k) c[k] = chb[(size_t)k * P];
  const float ndc = ndc_y[p] + shear[b];
  const float dx = dxz[(size_t)b * 2 * P + p];
  const float dz = dxz[((size_t)b * 2 + 1) * P + p];
  const ShadeAddr a = shade_address(c, ndc, dx, dz, cam[b * 3 + 0],
                                    cam[b * 3 + 1], cam[b * 3 + 2], p11, S1,
                                    n_rows);
  bool is_hole;
  const int v1 = global_texel(tex, hole, 0, a.lin, &is_hole);
  shade_store(a, v1, is_hole, cmap, out_idx + o, out_cov + o);
}

}  // namespace

extern "C" int tdt_shade_portal(const void* ch, const void* dxz,
                                const void* ndc_y, const void* sky,
                                const void* cam, const void* shear,
                                const void* tex, const void* hole,
                                const void* cmap, void* out_idx, void* out_cov,
                                int B, int P, int S1, float p11, int n_rows,
                                void* stream) {
  dim3 grid((P + kBlock - 1) / kBlock, B);
  shade_portal_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)ch, (const float*)dxz, (const float*)ndc_y,
      (const float*)sky, (const float*)cam, (const float*)shear,
      (const int8_t*)tex, (const int8_t*)hole, (const int8_t*)cmap,
      (float*)out_idx, (float*)out_cov, P, S1, p11, n_rows);
  return (int)cudaGetLastError();
}
