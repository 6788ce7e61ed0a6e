// Kernel W0 (walk_table): the walk's attribute table and visible-row cull.
//
// No Pallas kernel stands behind this one either. It is the port's
// counterpart of XLA-compiled code in tpu_doom/render/portal.py:_walk_env:
// the per-(env, row) attribute table (:652-720: about 74 column
// expressions of the level's rows, the movable objects' offsets, the light
// levels and the animation frame, packed into one (S+D, 74) matrix so that
// the TPU's MXU could gather it with one one-hot matmul), and on big levels
// the visible-seg cull (:730-790: a conservative per-row visibility test,
// a stable argsort that puts the visible rows first, and a one-hot select
// of the first SV rows). The plain version is
// tpu_doom_torch/render/portal.py:walk_table_ref, the port's eager table
// build factored out; W0 is held bitwise to it on the card. W1 and W2 read
// its output unchanged.
//
// Per env: table (SD', 74) f32, the rows' endpoints p1, p2 (SD', 2)
// (sprites as billboards facing the camera), and on big levels (0 < SV <
// SD) ordv (SV,) i64, the level rows kept in order, the count of visible
// rows n_visible i32 and the overflow flag (more than SV rows visible);
// SD' = SV there, else SD. The table's 40 columns that depend on no env
// come from the level's `walk_static` array, computed once per level
// (render/portal.py:_walk_static); the 34 others (heights with the objects' offsets, the sky substitutions, light
// levels, animated atlas bases and texel bases, the scrolled u) are
// computed here from the level's row arrays and the env's offsets, time
// and lights.
//
// Bound on the H100: bytes. The table is written once (296 bytes per row
// and env: 42.7 MB for one config-5 member, 13 us at 3.35 TB/s); the level
// arrays (about 500 bytes a row) are read by every env, from L2.
//
// Design: one block of 128 threads per env.
//  1. Where the cull is on, each thread tests rows (the plain version's
//     `_visible_rows`, operation for operation), a warp ballot packs the
//     flags into one word per 32 rows in shared memory, one thread turns
//     the words into prefix counts, and every row finds its place in the
//     stable partition (visible rows first, each group in row order):
//     below SV it writes its row id to ordv and to the block's row map.
//  2. The output rows go in tiles of 128: the static columns are copied
//     row-major (neighbouring threads on neighbouring words), then each
//     thread computes one row's 34 per-env columns, both into a tile in
//     shared memory (pitch 75, odd: no bank conflicts), which the block
//     then writes out as one contiguous run of 128 x 74 words.
// Every operation rounds where the plain version's does: built with
// --fmad=false; a true division where it divides (by ANIM_FPS, by the
// atlas width); torch.remainder as fmod plus the sign fix
// (portal_shade.cuh jmod); the cull's `+ 0.0` (the JAX one-hot select's
// signed-zero rule) as `+ zadd`, where zadd is +0.0f under the cull and
// -0.0f, which changes no value, without it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "portal_shade.cuh"

namespace {

using portal::jmod;

constexpr int kThreads = 128;  // threads per block = rows per tile
constexpr int kCols = 74;      // ops/walk.py TABLE_COLS
constexpr int kPitch = 75;     // the tile's row pitch in shared memory
constexpr int kStatic = 40;    // ops/walk.py len(STATIC_COLS)
constexpr int kStaticSmem = 48 * 1024;
constexpr float kAnimFps = (float)(8.0 / 35.0);  // render/raster.py ANIM_FPS

// Attribute table columns (tpu_doom_torch/ops/walk.py).
constexpr int C_FC = 1, C_FF = 2, C_CEILROW = 7, C_FLOORROW = 8, C_BCROW = 9;
constexpr int C_BFROW = 10, C_LFLAT = 11, C_CA = 12, C_FA = 16, C_CCB = 22, C_FCB = 23;
constexpr int PIECE0 = 26, PIECE_C = 16;
constexpr int P_LOW = 2, P_HIGH = 3, P_A = 4, P_LIGHT = 8, P_AB = 9, P_CB = 14;
// Where the sky flags sit in walk_static (STATIC_COLS[1..4]).
constexpr int S_FCS = 1, S_FFS = 2, S_BCS = 3, S_BFS = 4;

// ops/walk.py STATIC_COLS: walk_static's column k is the table's column
// kStaticCols[k] (tests/test_torch_walk.py holds the two lists equal).
__device__ const int kStaticCols[kStatic] = {
    0, 3, 4, 5, 6, 14, 15, 18, 19, 20, 21, 24, 25,
    26, 27, 31, 32, 33, 37, 38, 39, 41,
    42, 43, 47, 48, 49, 53, 54, 55, 57,
    58, 59, 63, 64, 65, 69, 70, 71, 73};

// The level's row arrays, in the order of ops/walk.py:walk_table's
// `level` list.
struct Level {
  const float* stat;  // (SD, kStatic)
  const float *f_ceil, *f_floor, *b_ceil, *b_floor;  // (SD,)
  const int32_t *f_ceil_obj, *f_floor_obj, *b_ceil_obj, *b_floor_obj, *flat_light;
  const float *ceil_atlas, *floor_atlas;  // (SD, 6)
  const float *piece_low, *piece_high, *piece_s1, *piece_scroll;  // (SD, 3)
  const int32_t *piece_obj, *piece_light;  // (SD, 3)
  const float* piece_atlas;  // (SD, 3, 6)
  const float *ceil_cb, *floor_cb, *piece_cb;  // (SD,), (SD,), (SD, 3)
  const float *p1, *p2;  // (S, 2)
  const float *spr_center, *spr_half;  // (D, 2), (D,)
  const float *hmin, *hmax;  // one value each
};
constexpr int kLevelPtrs = sizeof(Level) / sizeof(void*);

// torch.maximum / torch.minimum (NaN propagates).
__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}
__device__ __forceinline__ float tmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// render/portal.py:_anim_frame: floor(remainder(time / ANIM_FPS,
// clamp_min(nf, 1))).
__device__ __forceinline__ float anim_frame(float nf, float time) {
  return floorf(jmod(time / kAnimFps, nf < 1.0f ? 1.0f : nf));
}

// render/raster.py:anim_atlas_uv of one 6-vector (ax, ay, tsx, tsy,
// row_h, frames): the animation frame's atlas base, wrapped to the atlas
// rows; the base itself for a single-frame texture.
__device__ __forceinline__ float2 anim_uv(const float* a6, float atlas_w, float time) {
  const float ax = a6[0], ay = a6[1], tsx = a6[2], row_h = a6[4];
  const int nf_i = __float2int_rz(a6[5]);  // .to(torch.int32)
  if (nf_i == 1) return make_float2(ax, ay);
  const float frame = anim_frame((float)nf_i, time);
  float u = ax + frame * tsx;
  const float n_rows = ceilf((u + tsx) / atlas_w) - 1.0f;
  const float safe_ts = tsx == 0.0f ? 1.0f : tsx;
  u = u + jmod(atlas_w - ax, safe_ts) * n_rows;
  return make_float2(u, ay + n_rows * row_h);
}

// render/portal.py walk_table_ref's cbase_t: the frame's texel base,
// cb0 + frame * (tsx + 1) * (tsy + 1).
__device__ __forceinline__ float cbase_t(float cb0, const float* a6, float time) {
  const float fr = anim_frame(a6[5], time);
  return cb0 + fr * (a6[2] + 1.0f) * (a6[3] + 1.0f);
}

// light_of: the light level at a clamped index.
__device__ __forceinline__ float light_of(const float* lights, int idx, int L) {
  return lights[min(max(idx, 0), L - 1)];
}

// Row s's endpoints: a seg's, or a sprite's billboard center -+ right *
// half.
__device__ __forceinline__ void row_ends(const Level& lv, int s, int S, float rx,
                                         float rz, float2* p1, float2* p2) {
  if (s < S) {
    *p1 = make_float2(lv.p1[2 * s], lv.p1[2 * s + 1]);
    *p2 = make_float2(lv.p2[2 * s], lv.p2[2 * s + 1]);
    return;
  }
  const int d = s - S;
  const float h = lv.spr_half[d];
  const float offx = rx * h, offz = rz * h;
  const float cx = lv.spr_center[2 * d], cz = lv.spr_center[2 * d + 1];
  *p1 = make_float2(cx - offx, cz - offz);
  *p2 = make_float2(cx + offx, cz + offz);
}

// render/portal.py:_visible_rows for one row.
__device__ __forceinline__ bool row_visible(float2 p1, float2 p2, float ox, float oz,
                                            float fx, float fz, float dlx, float dlz,
                                            float drx, float drz, float near_,
                                            float far_) {
  const float ex = p2.x - p1.x, ez = p2.y - p1.y;
  const float pox = p1.x - ox, poz = p1.y - oz;
  const float q1 = (p1.x - ox) * fx + (p1.y - oz) * fz;
  const float q2 = (p2.x - ox) * fx + (p2.y - oz) * fz;
  const bool front = pox * ez - poz * ex > 0.0f;
  const float cl1 = dlx * (p1.y - oz) - dlz * (p1.x - ox);
  const float cl2 = dlx * (p2.y - oz) - dlz * (p2.x - ox);
  const float cr1 = drx * (p1.y - oz) - drz * (p1.x - ox);
  const float cr2 = drx * (p2.y - oz) - drz * (p2.x - ox);
  return front && tmax(q1, q2) > near_ && tmin(q1, q2) < far_ &&
         !(cl1 < 0.0f && cl2 < 0.0f) && !(cr1 > 0.0f && cr2 > 0.0f);
}

// One output row's 34 per-env columns, into its tile row.
__device__ __forceinline__ void env_columns(const Level& lv, int s, const float* offb,
                                            const float* lb, int L, float t,
                                            float flats_w, float walls_w, float zadd,
                                            float* row) {
  const float* st = lv.stat + (size_t)s * kStatic;
  const float hmin = *lv.hmin, hmax = *lv.hmax;
  const float fc = lv.f_ceil[s] + offb[lv.f_ceil_obj[s]];
  const float ff = lv.f_floor[s] + offb[lv.f_floor_obj[s]];
  row[C_FC] = fc + zadd;
  row[C_FF] = ff + zadd;
  row[C_CEILROW] = (st[S_FCS] != 0.0f ? hmax : fc) + zadd;
  row[C_FLOORROW] = (st[S_FFS] != 0.0f ? hmin : ff) + zadd;
  row[C_BCROW] =
      (st[S_BCS] != 0.0f ? hmax : lv.b_ceil[s] + offb[lv.b_ceil_obj[s]]) + zadd;
  row[C_BFROW] =
      (st[S_BFS] != 0.0f ? hmin : lv.b_floor[s] + offb[lv.b_floor_obj[s]]) + zadd;
  row[C_LFLAT] = light_of(lb, lv.flat_light[s], L) + zadd;
  const float* ca6 = lv.ceil_atlas + (size_t)s * 6;
  const float* fa6 = lv.floor_atlas + (size_t)s * 6;
  const float2 ca = anim_uv(ca6, flats_w, t);
  const float2 fa = anim_uv(fa6, flats_w, t);
  row[C_CA] = ca.x + zadd;
  row[C_CA + 1] = ca.y + zadd;
  row[C_FA] = fa.x + zadd;
  row[C_FA + 1] = fa.y + zadd;
  row[C_CCB] = cbase_t(lv.ceil_cb[s], ca6, t) + zadd;
  row[C_FCB] = cbase_t(lv.floor_cb[s], fa6, t) + zadd;
#pragma unroll
  for (int pi = 0; pi < 3; ++pi) {
    float* pr = row + PIECE0 + pi * PIECE_C;
    const int q = s * 3 + pi;
    const float off = offb[lv.piece_obj[q]];
    pr[P_LOW] = lv.piece_low[q] + off + zadd;
    pr[P_HIGH] = lv.piece_high[q] + off + zadd;
    pr[P_A] = lv.piece_s1[q] + lv.piece_scroll[q] * t + zadd;
    pr[P_LIGHT] = light_of(lb, lv.piece_light[q], L) + zadd;
    const float* a6 = lv.piece_atlas + (size_t)q * 6;
    const float2 uv = anim_uv(a6, walls_w, t);
    pr[P_AB] = uv.x + zadd;
    pr[P_AB + 1] = uv.y + zadd;
    pr[P_CB] = cbase_t(lv.piece_cb[q], a6, t) + zadd;
  }
}

__global__ void __launch_bounds__(kThreads) walk_table_kernel(
    Level lv, const float* __restrict__ objoff, const float* __restrict__ time,
    const float* __restrict__ lights, const float* __restrict__ right,
    const float* __restrict__ fwd, const float* __restrict__ o,
    float* __restrict__ table, float* __restrict__ p1o, float* __restrict__ p2o,
    int64_t* __restrict__ ordv, int* __restrict__ n_visible, bool* __restrict__ overflow,
    int S, int D, int O, int L, int SV, float xvmax, float near_, float far_, float flats_w,
    float walls_w) {
  extern __shared__ float s_tile[];  // kThreads x kPitch
  int* s_map = reinterpret_cast<int*>(s_tile + kThreads * kPitch);  // kStatic
  int* s_src = s_map + kStatic;                                      // SV
  const int SD = S + D;
  const int n_words = (SD + 31) / 32;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_src + SV);  // n_words
  int* s_wpre = reinterpret_cast<int*>(s_bits + n_words);      // n_words + 1
  const int b = blockIdx.x, tid = threadIdx.x;
  const bool cull = SV > 0;
  const int SDo = cull ? SV : SD;
  const float zadd = cull ? 0.0f : -0.0f;
  const float t = time[b];
  const float rx = right[2 * b], rz = right[2 * b + 1];
  for (int i = tid; i < kStatic; i += kThreads) s_map[i] = kStaticCols[i];

  // --- 1. the cull: the stable partition of the rows by visibility ------
  if (cull) {
    const float fx = fwd[2 * b], fz = fwd[2 * b + 1];
    const float ox = o[2 * b], oz = o[2 * b + 1];
    const float dlx = fx + rx * -xvmax, dlz = fz + rz * -xvmax;
    const float drx = fx + rx * xvmax, drz = fz + rz * xvmax;
    for (int base = 0; base < SD; base += kThreads) {
      const int r = base + tid;
      bool v = false;
      if (r < SD) {
        float2 p1, p2;
        row_ends(lv, r, S, rx, rz, &p1, &p2);
        v = row_visible(p1, p2, ox, oz, fx, fz, dlx, dlz, drx, drz, near_, far_);
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, v);
      const int first = base + (tid & ~31);
      if ((tid & 31) == 0 && first < SD) s_bits[first >> 5] = bits;
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int w = 0; w < n_words; ++w) {
        s_wpre[w] = acc;
        acc += __popc(s_bits[w]);
      }
      s_wpre[n_words] = acc;
      n_visible[b] = acc;
      overflow[b] = acc > SV;
    }
    __syncthreads();
    const int n_vis = s_wpre[n_words];
    for (int r = tid; r < SD; r += kThreads) {
      const uint32_t word = s_bits[r >> 5];
      const int below = s_wpre[r >> 5] + __popc(word & ((1u << (r & 31)) - 1u));
      const int dest = (word >> (r & 31)) & 1u ? below : n_vis + (r - below);
      if (dest < SV) {
        s_src[dest] = r;
        ordv[(size_t)b * SV + dest] = r;
      }
    }
  } else if (tid == 0) {
    overflow[b] = false;
  }
  __syncthreads();

  // --- 2. the table and endpoints, a tile of kThreads rows at a time ----
  const float* offb = objoff + (size_t)b * O;
  const float* lb = lights + (size_t)b * L;
  for (int j0 = 0; j0 < SDo; j0 += kThreads) {
    const int n = min(kThreads, SDo - j0);
    for (int e = tid; e < n * kStatic; e += kThreads) {
      const int rl = e / kStatic, k = e - rl * kStatic;
      const int s = cull ? s_src[j0 + rl] : j0 + rl;
      s_tile[rl * kPitch + s_map[k]] = __ldg(lv.stat + (size_t)s * kStatic + k) + zadd;
    }
    if (tid < n) {
      const int j = j0 + tid;
      const int s = cull ? s_src[j] : j;
      env_columns(lv, s, offb, lb, L, t, flats_w, walls_w, zadd, s_tile + tid * kPitch);
      float2 p1, p2;
      row_ends(lv, s, S, rx, rz, &p1, &p2);
      const size_t q = ((size_t)b * SDo + j) * 2;
      reinterpret_cast<float2*>(p1o)[q / 2] = make_float2(p1.x + zadd, p1.y + zadd);
      reinterpret_cast<float2*>(p2o)[q / 2] = make_float2(p2.x + zadd, p2.y + zadd);
    }
    __syncthreads();
    float* out = table + ((size_t)b * SDo + j0) * kCols;
    for (int e = tid; e < n * kCols; e += kThreads) {
      const int rl = e / kCols;
      out[e] = s_tile[rl * kPitch + (e - rl * kCols)];
    }
    __syncthreads();
  }
}

}  // namespace

// level: a host array of kLevelPtrs device pointers (struct Level's
// order); B envs; S segs, D sprites; O objects; L light levels; SV the
// cull's budget (0: no cull). ordv and n_visible may be null where SV is 0.
extern "C" int tdt_walk_table(const void* const* level, int n_level, const void* objoff,
                              const void* time, const void* lights, const void* right,
                              const void* fwd, const void* o, void* table, void* p1o,
                              void* p2o, void* ordv, void* n_visible, void* overflow,
                              int B, int S, int D, int O, int L, int SV, float xvmax,
                              float near_, float far_, float flats_w, float walls_w,
                              void* stream) {
  const int SD = S + D;
  if (n_level != kLevelPtrs || SD < 1 || O < 1 || L < 1 || SV < 0 || SV >= SD ||
      (SV > 0 && (!ordv || !n_visible)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Level lv;
  memcpy(&lv, level, sizeof(Level));
  const int n_words = (SD + 31) / 32;
  const size_t smem = (size_t)kThreads * kPitch * sizeof(float) +
                      (kStatic + SV + 2 * n_words + 1) * sizeof(int);
  if (smem > kStaticSmem) {
    // Above 48 KB only with the opt-in; a refusal fails the call and is
    // cleared, so that no later launch reports it.
    const cudaError_t err = cudaFuncSetAttribute(
        walk_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  walk_table_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      lv, (const float*)objoff, (const float*)time, (const float*)lights,
      (const float*)right, (const float*)fwd, (const float*)o, (float*)table,
      (float*)p1o, (float*)p2o, (int64_t*)ordv, (int*)n_visible, (bool*)overflow, S, D, O,
      L, SV, xvmax, near_, far_, flats_w, walls_w);
  return (int)cudaGetLastError();
}
