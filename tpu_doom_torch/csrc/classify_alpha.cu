// Kernel B7: first-match span classify with the masked-family alpha test.
//
// Replaces tpu_doom/ops/raster_pallas.py:classify_alpha_pallas (kernel
// _classify_alpha_kernel): stage 1 of B2 on its own, run by the
// `portal_jnp` configuration. The arithmetic is the plain version's
// (tpu_doom_torch/ops/raster.py:classify_alpha_ref), built with
// --fmad=false; the record test is B2's (portal_shade.cuh).
//
// Semantics of the TPU kernel kept: a pixel is done once the kind channel
// of its output is non-zero, so a covering record of kind 0 is written but
// a later covering record still replaces it. The TPU kernel's per-tile
// record bounds and its all-done early exit only skip work and are not
// carried over.
//
// Bound on the H100: bytes. At 256 envs x 320x200 the kernel reads 210 MB
// of records and writes 721 MB of channels (~0.28 ms at 3.35 TB/s).
// Design: one thread per pixel, a block 32 columns x 8 rows of one env as
// in B2; record reads put columns on adjacent threads (coalesced, and the
// 8 rows of a block share them through L1); the 11 output planes are
// written along columns, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "portal_shade.cuh"

namespace {

using namespace portal;

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void classify_alpha_kernel(const float* __restrict__ records,
                                      const int32_t* __restrict__ words,
                                      const float* __restrict__ cam_y,
                                      const float* __restrict__ shear,
                                      float* __restrict__ out, int R, int W,
                                      int H, int n_words, int hc, float p11) {
  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int row = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (col >= W || row >= H) return;
  const int K = R / kRpc;
  const float y = (float)row + 0.5f;
  const float cy = cam_y[b];
  const float ndc_y = 1.0f - 2.0f * y / (float)H + shear[b];
  const float* rec_env = records + (size_t)b * R * kNch * W + col;

  int win = -1;
  for (int r = 0; r < R; ++r) {
    const float* rec = rec_env + (size_t)r * kNch * W;
    const int32_t* wk = words + ((size_t)b * K + r / kRpc) * n_words * W + col;
    if (!record_hits(rec, W, r, y, ndc_y, cy, p11, hc, wk, n_words)) continue;
    win = r;
    if (rec[2 * W] != 0.0f) break;
  }
  const float* rec = rec_env + (size_t)(win < 0 ? 0 : win) * kNch * W;
  float* o = out + (size_t)b * kOutCh * H * W + (size_t)row * W + col;
#pragma unroll
  for (int c = 0; c < kOutCh; ++c)
    o[(size_t)c * H * W] = win >= 0 ? rec[(2 + c) * W] : 0.0f;
}

}  // namespace

extern "C" int tdt_classify_alpha(const void* records, const void* words,
                                  const void* cam_y, const void* shear,
                                  void* out, int B, int R, int W, int H,
                                  int n_words, int hc, float p11,
                                  void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  classify_alpha_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)records, (const int32_t*)words, (const float*)cam_y,
      (const float*)shear, (float*)out, R, W, H, n_words, hc, p11);
  return (int)cudaGetLastError();
}
