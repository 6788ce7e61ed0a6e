// Device code shared by the depth-peel kernels B3 (peel_resolve.cu) and B9
// (depth_peel.cu): the coverage test of one packed triangle row, the
// arithmetic of `_peel_cover` in tpu_doom_torch/ops/raster.py.

#pragma once

#include <cuda_runtime.h>

namespace peel {

constexpr int kMaxChunk = 128;  // triangle rows staged in shared memory

// Does the triangle of row s (columns [e00..e22, zr, vs, valid]) cover the
// pixel (px, py)? Its NDC depth is written to *z either way.
__device__ __forceinline__ bool cover(const float* s, float px, float py,
                                      float* z) {
  const float lam0 = s[0] * px + s[1] * py + s[2];
  const float lam1 = s[3] * px + s[4] * py + s[5];
  const float lam2 = s[6] * px + s[7] * py + s[8];
  *z = s[9] * px + s[10] * py + s[11];
  const float slam = s[12] * px + s[13] * py + s[14];
  return (s[15] > 0.0f) && (lam0 >= 0.0f) && (lam1 >= 0.0f) &&
         (lam2 >= 0.0f) && (slam > 0.0f) && (*z >= -1.0f) && (*z <= 1.0f);
}

}  // namespace peel
