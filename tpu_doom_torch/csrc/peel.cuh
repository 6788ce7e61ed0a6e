// Device code shared by the depth-peel kernels B3 (peel_resolve.cu) and B9
// (depth_peel.cu): the coverage test of one packed triangle row (the
// arithmetic of `_peel_cover` in tpu_doom_torch/ops/raster.py), the exact
// box cull in front of it, the binning pass, the compaction of the rows
// that survive a tile's cull, and the sorted list of the K nearest (z, id)
// a thread keeps.
//
// Why one sweep gives the iterative peel's layers. Under "z less, or z
// equal (-0 == +0) and id less", the (z, id) of the rows covering a pixel
// are totally ordered (no covering z is NaN, and ids are unique), and
// layer k of the peel is the (k+1)-th least of them, or (inf, big) past
// the end. So a thread that keeps the D least it has seen, sorted, with
// each row's own z, ends the sweep holding layers 0..D-1. K > D layers
// take ceil(K / D) sweeps, each keeping only rows after the last entry of
// the sweep before it.
//
// Why the cull is exact. [x0, x1] x [y0, y1] bound the pixel centres of a
// box of the image (a kBin x kBin bin, or a block's kTileW x kTileH tile).
// Each affine term of the coverage test is (a * x + b * y) + c rounded
// step by step (built with --fmad=false). Rounding is monotone, so at the
// corner x = (a >= 0 ? x1 : x0), y = (b >= 0 ? y1 : y0) the value is at
// least the value at every pixel of the box (or NaN, which rejects
// nothing), and at the opposite corner at most. A row whose largest lam or
// slam already fails its test, or whose z range misses [-1, 1], or which
// is not valid, covers no pixel of the box, and nothing else is culled.
//
// Two passes: `bin_kernel` lists, per bin and env, the rows that may cover
// the bin, in row order; then one block per tile reads only its bin's
// list, culls it against the tile, and peels. On a maze most of a level's
// rows miss a given bin, so a tile no longer reads them all.

#pragma once

#include <cuda_runtime.h>

namespace peel {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;  // a block's pixel tile, a warp per image row
constexpr int kTileH = kWarps;
constexpr int kBin = 64;      // bins of kBin x kBin pixels, 8 x 2 tiles each
constexpr int kMaxDepth = 8;  // layers one sweep keeps
constexpr int kEntry = 5;     // float4s per staged row: 16 coefficients, meta

// Layers kept per sweep for K layers: K itself up to 4, else kMaxDepth
// (one template instantiation each for 1, 2, 3, 4 and 8).
inline int sweep_depth(int n_layers) {
  return n_layers <= 4 ? n_layers : kMaxDepth;
}

__host__ __device__ inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

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

// Bounds of a box's pixel centres.
struct Box {
  float x0, x1, y0, y1;
};

// a * x + b * y + c at the corner of t where it is largest / least.
__device__ __forceinline__ float most(float a, float b, float c, Box t) {
  return a * (a >= 0.0f ? t.x1 : t.x0) + b * (b >= 0.0f ? t.y1 : t.y0) + c;
}
__device__ __forceinline__ float least(float a, float b, float c, Box t) {
  return a * (a >= 0.0f ? t.x0 : t.x1) + b * (b >= 0.0f ? t.y0 : t.y1) + c;
}

// False only if `cover` is false for row s at every pixel centre in t.
__device__ __forceinline__ bool may_cover(const float* s, Box t) {
  return (s[15] > 0.0f) && !(most(s[0], s[1], s[2], t) < 0.0f) &&
         !(most(s[3], s[4], s[5], t) < 0.0f) &&
         !(most(s[6], s[7], s[8], t) < 0.0f) &&
         !(most(s[12], s[13], s[14], t) <= 0.0f) &&
         !(least(s[9], s[10], s[11], t) > 1.0f) &&
         !(most(s[9], s[10], s[11], t) < -1.0f);
}

// The image's geometry: `width` pixels wide, P long (the grid's index map,
// render/raster.py:pixel_grid). The kernels read each pixel's centre from
// the grid, so any width gives the same result; it only shapes the tiles.
struct Image {
  int width, P, tiles_x, bins_x, bins;

  __host__ __device__ Image(int width_, int P_) : width(width_), P(P_) {
    const int rows = ceil_div(P, width);
    tiles_x = ceil_div(width, kTileW);
    bins_x = ceil_div(width, kBin);
    bins = bins_x * ceil_div(rows, kBin);
  }
  __host__ __device__ int tiles() const {
    return tiles_x * ceil_div(ceil_div(P, width), kTileH);
  }
  // Pixel (row, col), or -1 outside the image.
  __device__ __forceinline__ int pixel(long long row, int col) const {
    const long long p = row * width + col;
    return col < width && p < P ? (int)p : -1;
  }
};

// This thread's pixel in the block's tile (blockIdx.x of the image's
// row-major tiles), -1 outside the image; *bin gets the tile's bin.
__device__ __forceinline__ int tile_pixel(const Image& im, int* bin) {
  const int tx = blockIdx.x % im.tiles_x, ty = blockIdx.x / im.tiles_x;
  *bin = (ty * kTileH / kBin) * im.bins_x + tx * kTileW / kBin;
  return im.pixel((long long)ty * kTileH + threadIdx.x / kTileW,
                  tx * kTileW + threadIdx.x % kTileW);
}

inline __device__ float4 row_quad(const float* rows, int row_cols, int r, int k) {
  return __ldg(reinterpret_cast<const float4*>(rows + (size_t)r * row_cols) + k);
}

__device__ __forceinline__ void unpack(const float4* q, float (&s)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = q[k];
    s[4 * k] = v.x;
    s[4 * k + 1] = v.y;
    s[4 * k + 2] = v.z;
    s[4 * k + 3] = v.w;
  }
}

// v[i] <- the least v[i] over the block's threads (every thread calls it;
// sh holds kWarps * N floats).
template <int N>
__device__ __forceinline__ void block_min(float (&v)[N], float* sh) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] = fminf(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sh[(threadIdx.x >> 5) * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = sh[i];
    for (int w = 1; w < kWarps; ++w) v[i] = fminf(v[i], sh[w * N + i]);
  }
}

// Folds a pixel's centre into v, the least x, -x, y, -y seen (block_min
// then takes them over the block; inf for a box with no pixel).
__device__ __forceinline__ void box_min(float* v, float px, float py,
                                        bool valid) {
  const float inf = __int_as_float(0x7f800000);
  v[0] = fminf(v[0], valid ? px : inf);
  v[1] = fminf(v[1], valid ? -px : inf);
  v[2] = fminf(v[2], valid ? py : inf);
  v[3] = fminf(v[3], valid ? -py : inf);
}

// Each thread's flag's place among the block's set flags, in thread order;
// *n gets their count. counts holds kWarps ints; the first barrier also
// ends the block's use of what the previous call's places indexed.
__device__ __forceinline__ int place(bool keep, int* counts, int* n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) counts[warp] = __popc(m);
  __syncthreads();
  int base = 0;
  *n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? counts[w] : 0;
    *n += counts[w];
  }
  return base + __popc(m & ((1u << lane) - 1u));
}

// Pass 1, one block per (bin, env): list[(b * bins + bin) * T + k], k <
// count[b * bins + bin], the rows in row order that may cover a pixel of
// the bin.
template <int kRowCols>
__global__ void __launch_bounds__(kThreads)
    bin_kernel(const float* __restrict__ rows, const float* __restrict__ grid,
               int* __restrict__ list, int* __restrict__ count, int T, int P,
               int width) {
  __shared__ int counts[kWarps];
  __shared__ float red[kWarps * 4];
  const Image im(width, P);
  const int bin = blockIdx.x, b = blockIdx.y;
  const int bx = bin % im.bins_x, by = bin / im.bins_x;
  const float inf = __int_as_float(0x7f800000);
  float v[4] = {inf, inf, inf, inf};
  for (int k = threadIdx.x; k < kBin * kBin; k += kThreads) {
    const int p = im.pixel((long long)by * kBin + k / kBin, bx * kBin + k % kBin);
    box_min(v, p >= 0 ? grid[p] : 0.0f, p >= 0 ? grid[P + p] : 0.0f, p >= 0);
  }
  block_min(v, red);
  const size_t cell = (size_t)b * im.bins + bin;
  if (v[0] == inf) {  // no pixel of the image in this bin
    if (threadIdx.x == 0) count[cell] = 0;
    return;
  }
  const Box box{v[0], -v[1], v[2], -v[3]};
  const float* env_rows = rows + (size_t)b * T * kRowCols;
  int* out = list + cell * T;
  int total = 0;
  for (int g0 = 0; g0 < T; g0 += kThreads) {
    const int r = g0 + threadIdx.x;
    bool keep = false;
    if (r < T) {
      float4 q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = row_quad(env_rows, kRowCols, r, k);
      float s[16];
      unpack(q, s);
      keep = may_cover(s, box);
    }
    int n;
    const int at = place(keep, counts, &n);
    if (keep) out[total + at] = r;
    total += n;
    __syncthreads();  // counts is read again by the next group's place
  }
  if (threadIdx.x == 0) count[cell] = total;
}

// Appends each thread's entry e (if keep) to `list` in thread order and
// returns the block's count; the rows in `list` are for every thread to
// read after it returns, until the next call.
__device__ __forceinline__ int compact(bool keep, const float4 (&e)[kEntry],
                                       float4* list, int* counts) {
  int n;
  const int at = place(keep, counts, &n);
  if (keep) {
#pragma unroll
    for (int k = 0; k < kEntry; ++k) list[at * kEntry + k] = e[k];
  }
  __syncthreads();
  return n;
}

// The peel's order: (za, ia) before (zb, ib)?
template <typename Id>
__device__ __forceinline__ bool before(float za, Id ia, float zb, Id ib) {
  return za < zb || (za == zb && ia < ib);
}

// The D least (z, id) a thread has seen, sorted, with each one's row
// position; (inf, big) past the end.
template <int D, typename Id>
struct Layers {
  float z[D];
  Id id[D];
  int pos[D];

  __device__ __forceinline__ void clear(Id big) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      z[j] = __int_as_float(0x7f800000);
      id[j] = big;
      pos[j] = -1;
    }
  }

  // Insertion by one pass of compare-and-swap down the list. A second row
  // with an equal (z, id) is dropped: the iterative peel takes only the
  // first of them in row order, and rows arrive in row order.
  __device__ __forceinline__ void insert(float zc, Id ic, int pc, Id big) {
    if (!before(zc, ic, z[D - 1], id[D - 1])) return;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (zc == z[j] && ic == id[j]) {
        zc = __int_as_float(0x7f800000);
        ic = big;
      }
      if (before(zc, ic, z[j], id[j])) {
        const float tz = z[j];
        const Id ti = id[j];
        const int tp = pos[j];
        z[j] = zc;
        id[j] = ic;
        pos[j] = pc;
        zc = tz;
        ic = ti;
        pc = tp;
      }
    }
  }
};

}  // namespace peel
