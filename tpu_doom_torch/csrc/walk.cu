// Kernels W1 (walk_cross) and W2 (walk_records): the column walk.
//
// No Pallas kernel stands behind these. They are the port's counterparts
// of XLA-compiled code: tpu_doom/render/portal.py:_walk_env, vmapped over
// envs inside the jitted render, which XLA turns into a few loop fusions
// and one stable multi-operand sort (lax.sort carrying (t, u, id) over
// all S+D walk rows of every column, of which the walk keeps K). The
// plain versions are tpu_doom_torch/ops/walk.py:walk_cross_ref and
// walk_records_ref, the port's eager walk factored out; both kernels are
// held bitwise to them on the card.
//
// W1, per (env, column): the ray's crossing with every walk row (t, u,
// valid as the plain version rounds them), the K crossings of smallest
// (depth, row id) with BIG_T the depth of an invalid one, and the clip
// window front to back over them (top, bot, live). Also each env's mask
// of the crossings live in any column (bit k), OR'd over the columns.
// W2, per (env, column): the first kc crossings live in any column (all K
// without compaction), then per kept crossing its five span records (16
// channels, gated as the plain version gates them) and the masked
// family's alpha words; one thread per env also writes its overflow.
//
// Bound. W1 reads the rows (B x SD x 16 bytes) and the prefix columns it
// selects and writes 6 x (B, K, W) words; its work is SD crossing tests
// per column, ~30 operations each, plus an insertion into the K-list for
// each crossing that enters it. W2 writes the records, 5 x 16 words per
// kept crossing and column (1.68 GB for one config-5 member at 640x400,
// 0.50 ms at 3.35 TB/s), and reads a table row per crossing: it is bound
// by the records' bytes.
//
// Design. One thread per column, 128 columns of one env per block.
//  W1: the block stages the env's rows as (e, p1 - o) in shared memory,
//  256 rows at a time; each thread keeps its K nearest (t, u, id) sorted
//  in registers, inserted at compile-time indices (a list indexed at run
//  time would go to local memory): scanning rows in id order and
//  shifting only past a strictly larger depth keeps equal depths in id
//  order, which is the stable sort's first K, sentinel slots included
//  (their u feeds the alpha words). Rows whose depth is not below the
//  list's last skip the insert: after the first K rows, most do. The
//  clip window then runs over the list in the thread: the cummax / cummin
//  prefix is a running max / min. The mask is OR'd over a warp, then
//  into the env's word with one atomicOr per warp. Templated on KMAX, the
//  list's length (8, 16, 24 or 32); any K <= KMAX gives the same first K.
//  W2: each block works out the kept crossings' order from the mask once
//  (in shared memory); each thread then reads its column's crossings and
//  their table rows (through the read-only cache: a small level's table
//  is 42-57 KB per env) and writes the records and words, neighbouring
//  threads on neighbouring addresses.
// Every operation rounds where the plain version's does: built with
// --fmad=false; a true division where the plain version divides by a
// tensor; torch.remainder as fmod plus the sign fix (portal_shade.cuh);
// XLA's saturating f32 -> i32; `+ 0.0f` turns -0.0 into +0.0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "portal_shade.cuh"

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kChunk = 256;    // rows W1 stages at a time
constexpr float kBigT = 1e30f;
constexpr float kValidT = 1e29f;  // BIG_T / 10: below it a depth is valid
constexpr float kNeg = -1e9f, kPos = 1e9f;
constexpr int kKmaxLimit = 32;

// Attribute table columns (tpu_doom_torch/ops/walk.py).
constexpr int C_HB = 0, C_FC = 1, C_FF = 2, C_FCS = 3, C_FFS = 4, C_BCS = 5, C_BFS = 6;
constexpr int C_CEILROW = 7, C_FLOORROW = 8, C_BCROW = 9, C_BFROW = 10, C_LFLAT = 11;
constexpr int C_CA = 12, C_FA = 16, C_SOLID = 20, C_SPRITE = 21, C_CCB = 22, C_FCB = 23;
constexpr int C_CCID = 24, C_FCID = 25, PIECE0 = 26, PIECE_C = 16;
constexpr int P_EXISTS = 0, P_LOW = 2, P_HIGH = 3, P_A = 4, P_B = 5, P_T1 = 6, P_T2 = 7;
constexpr int P_LIGHT = 8, P_AB = 9, P_EXMASK = 13, P_CB = 14, P_CID = 15;
// Record channels.
constexpr int R_Y0 = 0, R_Y1 = 1, R_KIND = 2, R_P0 = 3, R_TSX = 4, R_TSY = 5, R_CBASE = 6;
constexpr int R_LIGHT = 7, R_W = 8, R_T1 = 9, R_T2 = 10, R_LOW = 11, R_HIGH = 12;
constexpr int R_MASKED = 13, R_AX = 14, R_AY = 15;
constexpr int kRecords = 5;

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

// _numerics.to_i32: NaN -> 0, then clamp to [-2^31, the largest f32
// below 2^31], then truncate.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  x = x < -2147483648.0f ? -2147483648.0f : x;
  x = x > 2147483520.0f ? 2147483520.0f : x;
  return __float2int_rz(x);
}

// ops/walk.py:row_of, one rounding per operation.
__device__ __forceinline__ float row_of(float h, float tt, float cyw, float shear,
                                        float p11, float Hf) {
  const float ndc = __fdiv_rn(__fmul_rn(p11, __fsub_rn(h, cyw)), tt);
  return __fadd_rn(__fsub_rn(Hf, __fmul_rn(__fmul_rn(__fadd_rn(ndc, 1.0f), 0.5f), Hf)),
                   shear);
}

template <int KMAX>
__device__ __forceinline__ void insert(float (&kt)[KMAX], float (&ku)[KMAX],
                                       int (&kid)[KMAX], float td, float u, int id) {
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j) {
    const bool shift = td < kt[j - 1];
    const bool here = !shift && td < kt[j];
    kt[j] = shift ? kt[j - 1] : (here ? td : kt[j]);
    ku[j] = shift ? ku[j - 1] : (here ? u : ku[j]);
    kid[j] = shift ? kid[j - 1] : (here ? id : kid[j]);
  }
  if (td < kt[0]) {
    kt[0] = td;
    ku[0] = u;
    kid[0] = id;
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads) walk_cross_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ table, const float* __restrict__ cyw,
    const float* __restrict__ shear, float* __restrict__ t_out,
    float* __restrict__ u_out, int32_t* __restrict__ idx_out,
    bool* __restrict__ live_out, float* __restrict__ top_out,
    float* __restrict__ bot_out, int32_t* __restrict__ mask_out, int SD, int C,
    int W, int K, float near_, float far_, float p11, float Hf) {
  __shared__ float4 rows[kChunk];  // (e0, e1, po0, po1)
  const int b = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const bool act = w < W;
  const float ox = o[2 * b], oz = o[2 * b + 1];
  const float d0 = act ? d[((size_t)b * W + w) * 2] : 0.0f;
  const float d1 = act ? d[((size_t)b * W + w) * 2 + 1] : 0.0f;

  float kt[KMAX], ku[KMAX];
  int kid[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    kt[j] = INFINITY;
    ku[j] = 0.0f;
    kid[j] = 0;
  }

  const float* p1b = p1 + (size_t)b * SD * 2;
  const float* p2b = p2 + (size_t)b * SD * 2;
  for (int s0 = 0; s0 < SD; s0 += kChunk) {
    const int n = min(kChunk, SD - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = s0 + i;
      const float ax = p1b[2 * r], az = p1b[2 * r + 1];
      rows[i] = make_float4(__fsub_rn(p2b[2 * r], ax), __fsub_rn(p2b[2 * r + 1], az),
                            __fsub_rn(ax, ox), __fsub_rn(az, oz));
    }
    __syncthreads();
    if (!act) continue;
    for (int i = 0; i < n; ++i) {
      const float4 r = rows[i];
      const float denom = __fsub_rn(__fmul_rn(d0, r.y), __fmul_rn(d1, r.x));
      const bool tiny = fabsf(denom) < 1e-12f;
      const float safe = tiny ? 1.0f : denom;
      const float t = __fdiv_rn(__fsub_rn(__fmul_rn(r.z, r.y), __fmul_rn(r.w, r.x)), safe);
      const float u = __fdiv_rn(__fsub_rn(__fmul_rn(r.z, d1), __fmul_rn(r.w, d0)), safe);
      const bool valid = fabsf(denom) >= 1e-12f && denom > 0.0f && t > near_ &&
                         t < far_ && u >= 0.0f && u <= 1.0f;
      const float td = valid ? t : kBigT;
      if (td < kt[KMAX - 1]) insert<KMAX>(kt, ku, kid, td, u, s0 + i);
    }
  }

  // The clip window over the K nearest, front to back.
  const float cy = cyw[b], sh = shear[b];
  const float* tb = table + (size_t)b * SD * C;
  float ct = kNeg, cb = kPos;
  bool blk = false;
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K && act) {
      const float t = kt[k];
      const bool valid = t < kValidT;
      const float st = valid ? t : 1.0f;
      const float* row = tb + (size_t)kid[k] * C;
      const bool hb = __ldg(row + C_HB) > 0.5f;
      const bool solid = __ldg(row + C_SOLID) > 0.5f;
      const float r_fc = row_of(__ldg(row + C_CEILROW), st, cy, sh, p11, Hf);
      const float r_ff = row_of(__ldg(row + C_FLOORROW), st, cy, sh, p11, Hf);
      const float r_bc = row_of(__ldg(row + C_BCROW), st, cy, sh, p11, Hf);
      const float r_bf = row_of(__ldg(row + C_BFROW), st, cy, sh, p11, Hf);
      const bool vs = valid && solid;
      const float step_top = vs ? (hb ? tmax(r_fc, r_bc) : r_fc) : kNeg;
      const float step_bot = vs ? (hb ? tmin(r_ff, r_bf) : r_ff) : kPos;
      const float top = tmax(ct, 0.0f);
      const float bot = tmin(cb, Hf);
      const float top1 = solid ? tmax(top, r_fc) : top;
      const float bot1 = solid ? tmin(bot, r_ff) : bot;
      const float new_top = hb ? tmax(top1, r_bc) : top1;
      const float new_bot = hb ? tmin(bot1, r_bf) : bot1;
      const bool blocker = (vs && (!hb || new_top >= new_bot)) || !valid;
      const bool live = valid && !blk;
      const size_t at = ((size_t)b * K + k) * W + w;
      t_out[at] = t;
      u_out[at] = ku[k];
      idx_out[at] = kid[k];
      live_out[at] = live;
      top_out[at] = top;
      bot_out[at] = bot;
      ct = tmax(ct, step_top);
      cb = tmin(cb, step_bot);
      blk = blk || blocker;
      bits |= (unsigned)live << k;
    }
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(reinterpret_cast<unsigned*>(mask_out) + b, bits);
}

// One record's 16 channels at out (channel c at out[c * W]), gated by ok.
struct Rec {
  float y0, y1, kind, p0, ax, ay, tsx, tsy, masked, cbase, light, w, t1, t2, low, high;
};

__device__ __forceinline__ void put(float* out, int W, bool ok, const Rec& r) {
  out[R_Y0 * W] = __fadd_rn(ok ? r.y0 : 1e9f, 0.0f);
  out[R_Y1 * W] = __fadd_rn(ok ? r.y1 : -1e9f, 0.0f);
  out[R_KIND * W] = __fadd_rn(ok ? r.kind : 0.0f, 0.0f);
  out[R_P0 * W] = __fadd_rn(ok ? r.p0 : 0.0f, 0.0f);
  out[R_TSX * W] = __fadd_rn(ok ? r.tsx : 0.0f, 0.0f);
  out[R_TSY * W] = __fadd_rn(ok ? r.tsy : 0.0f, 0.0f);
  out[R_CBASE * W] = __fadd_rn(ok ? r.cbase : 0.0f, 0.0f);
  out[R_LIGHT * W] = __fadd_rn(ok ? r.light : 0.0f, 0.0f);
  out[R_W * W] = __fadd_rn(ok ? r.w : 0.0f, 0.0f);
  out[R_T1 * W] = __fadd_rn(ok ? r.t1 : 0.0f, 0.0f);
  out[R_T2 * W] = __fadd_rn(ok ? r.t2 : 0.0f, 0.0f);
  out[R_LOW * W] = __fadd_rn(ok ? r.low : 0.0f, 0.0f);
  out[R_HIGH * W] = __fadd_rn(ok ? r.high : 0.0f, 0.0f);
  out[R_MASKED * W] = __fadd_rn(ok ? r.masked : 0.0f, 0.0f);
  out[R_AX * W] = __fadd_rn(ok ? r.ax : 0.0f, 0.0f);
  out[R_AY * W] = __fadd_rn(ok ? r.ay : 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads) walk_records_kernel(
    const float* __restrict__ t_in, const float* __restrict__ u_in,
    const int32_t* __restrict__ idx_in, const bool* __restrict__ live_in,
    const float* __restrict__ top_in, const float* __restrict__ bot_in,
    const int32_t* __restrict__ mask, const bool* __restrict__ ovf_in,
    const float* __restrict__ table, const int32_t* __restrict__ aw,
    const float* __restrict__ cyw, const float* __restrict__ shear,
    const float* __restrict__ shift, float* __restrict__ rec_out,
    int32_t* __restrict__ words_out, bool* __restrict__ ovf_out, int SD, int C, int W,
    int K, int kc, int n_words, int wc, int n_cells, float p11, float Hf) {
  __shared__ int ord[kKmaxLimit];
  const int b = blockIdx.y;
  const int ns = kc ? min(kc, K) : K;
  if (threadIdx.x == 0) {
    const unsigned all = K == 32 ? 0xffffffffu : (1u << K) - 1u;
    const unsigned m = (unsigned)mask[b] & all;
    int j = 0;
    if (kc) {  // the crossings live in any column in K order, then the rest
      for (int k = 0; k < K && j < ns; ++k)
        if ((m >> k) & 1u) ord[j++] = k;
      for (int k = 0; k < K && j < ns; ++k)
        if (!((m >> k) & 1u)) ord[j++] = k;
      if (blockIdx.x == 0) ovf_out[b] = ovf_in[b] || __popc(m) > kc;
    } else {
      for (int k = 0; k < K; ++k) ord[k] = k;
      if (blockIdx.x == 0) ovf_out[b] = ovf_in[b];
    }
  }
  __syncthreads();
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const float cy = cyw[b], sh = shear[b];
  const float* tb = table + (size_t)b * SD * C;
  const float* shb = shift ? shift + (size_t)b * n_cells : nullptr;
  auto remap = [&](float cbase, float cid) -> float {
    if (!shb) return cbase;
    if (cid < 0.0f) return 0.0f;
    long long ci = (long long)cid;
    ci = ci < 0 ? 0 : (ci > n_cells - 1 ? n_cells - 1 : ci);
    return __fadd_rn(cbase, shb[ci]);
  };

  for (int j = 0; j < ns; ++j) {
    const size_t at = ((size_t)b * K + ord[j]) * W + w;
    const float t = t_in[at], uf = u_in[at], top = top_in[at], bot = bot_in[at];
    const bool live = live_in[at];
    const float* row = tb + (size_t)idx_in[at] * C;
    auto col = [&](int c) { return __ldg(row + c); };
    const bool valid = t < kValidT;
    const float st = valid ? t : 1.0f;
    const bool hb = col(C_HB) > 0.5f, solid = col(C_SOLID) > 0.5f;
    const bool sprite = col(C_SPRITE) > 0.5f;
    const bool fcs = col(C_FCS) > 0.5f, ffs = col(C_FFS) > 0.5f;
    const bool bcs = col(C_BCS) > 0.5f, bfs = col(C_BFS) > 0.5f;
    const float light_flat = col(C_LFLAT);
    const float r_fc = row_of(col(C_CEILROW), st, cy, sh, p11, Hf);
    const float r_ff = row_of(col(C_FLOORROW), st, cy, sh, p11, Hf);
    const float top1 = solid ? tmax(top, r_fc) : top;
    const float bot1 = solid ? tmin(bot, r_ff) : bot;
    float* out = rec_out + ((size_t)b * ns + j) * kRecords * 16 * W + w;
    const size_t rec_stride = (size_t)16 * W;

    // Ceiling span, with the sky band at sky -> non-sky boundaries.
    const bool flat_ok = live && solid;
    {
      const bool band = fcs && (!hb || !bcs);
      Rec r{};
      r.y0 = top;
      r.y1 = band ? tmin(bot1, row_of(col(C_FC), st, cy, sh, p11, Hf)) : tmin(bot, r_fc);
      r.kind = fcs ? 3.0f : 1.0f;
      r.p0 = col(C_CEILROW);
      r.ax = col(C_CA);
      r.ay = col(C_CA + 1);
      r.tsx = col(C_CA + 2);
      r.tsy = col(C_CA + 3);
      r.light = light_flat;
      r.cbase = remap(col(C_CCB), col(C_CCID));
      put(out, W, flat_ok, r);
    }
    // Floor span, with its sky band.
    {
      const bool band = ffs && (!hb || !bfs);
      Rec r{};
      r.y0 = band ? tmax(top1, row_of(col(C_FF), st, cy, sh, p11, Hf)) : tmax(top, r_ff);
      r.y1 = band ? bot1 : bot;
      r.kind = ffs ? 3.0f : 1.0f;
      r.p0 = col(C_FLOORROW);
      r.ax = col(C_FA);
      r.ay = col(C_FA + 1);
      r.tsx = col(C_FA + 2);
      r.tsy = col(C_FA + 3);
      r.light = light_flat;
      r.cbase = remap(col(C_FCB), col(C_FCID));
      put(out + rec_stride, W, flat_ok, r);
    }
    // Wall pieces lower / middle / upper (sprites ride the middle).
#pragma unroll
    for (int pi = 0; pi < 3; ++pi) {
      const int c0 = PIECE0 + pi * PIECE_C;
      Rec r{};
      r.low = col(c0 + P_LOW);
      r.high = col(c0 + P_HIGH);
      r.y0 = tmax(top1, row_of(r.high, st, cy, sh, p11, Hf));
      r.y1 = tmin(bot1, row_of(r.low, st, cy, sh, p11, Hf));
      r.kind = (pi == 1 && sprite) ? 4.0f : 2.0f;
      r.p0 = __fadd_rn(col(c0 + P_A), __fmul_rn(col(c0 + P_B), uf));
      r.ax = col(c0 + P_AB);
      r.ay = col(c0 + P_AB + 1);
      r.tsx = col(c0 + P_AB + 2);
      r.tsy = col(c0 + P_AB + 3);
      r.light = col(c0 + P_LIGHT);
      r.w = t;
      r.t1 = col(c0 + P_T1);
      r.t2 = col(c0 + P_T2);
      r.masked = col(c0 + P_EXMASK) > 0.5f ? 1.0f : 0.0f;
      r.cbase = remap(col(c0 + P_CB), col(c0 + P_CID));
      put(out + (2 + pi) * rec_stride, W, live && col(c0 + P_EXISTS) > 0.5f, r);
    }

    // The masked family's alpha words: one texture column per crossing.
    const int c0m = PIECE0 + PIECE_C;
    const float uu = __fadd_rn(col(c0m + P_A), __fmul_rn(col(c0m + P_B), uf));
    const float tsx = col(c0m + P_AB + 2);
    const float u1 = __fadd_rn(portal::jmod(uu, tsx == 0.0f ? 1.0f : tsx), col(c0m + P_AB));
    const int x_t = portal::imod(to_i32(floorf(u1)), wc);
    const int32_t* src = aw + (size_t)(x_t + (sprite ? wc : 0)) * n_words;
    int32_t* dst = words_out + ((size_t)b * ns + j) * n_words * W + w;
    for (int q = 0; q < n_words; ++q) dst[(size_t)q * W] = __ldg(src + q);
  }
}

template <int KMAX>
cudaError_t launch_cross(dim3 grid, cudaStream_t s, const float* p1, const float* p2,
                         const float* o, const float* d, const float* table,
                         const float* cyw, const float* shear, float* t, float* u,
                         int32_t* idx, bool* live, float* top, float* bot, int32_t* mask,
                         int SD, int C, int W, int K, float near_, float far_, float p11,
                         float Hf) {
  walk_cross_kernel<KMAX><<<grid, kThreads, 0, s>>>(p1, p2, o, d, table, cyw, shear, t, u,
                                                    idx, live, top, bot, mask, SD, C, W, K,
                                                    near_, far_, p11, Hf);
  return cudaGetLastError();
}

}  // namespace

// p1, p2 (B, SD, 2), o (B, 2), d (B, W, 2), table (B, SD, C), cyw, shear (B,)
// f32 -> t, u, idx (i32), live (bool), top, bot (B, K, W); mask (B,) i32,
// zeroed by the caller. 1 <= K <= min(SD, 32).
extern "C" int tdt_walk_cross(const void* p1, const void* p2, const void* o, const void* d,
                              const void* table, const void* cyw, const void* shear,
                              void* t, void* u, void* idx, void* live, void* top,
                              void* bot, void* mask, int B, int SD, int C, int W, int K,
                              float near_, float far_, float p11, float Hf, void* stream) {
  if (K < 1 || K > kKmaxLimit || K > SD) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return launch(grid, s, (const float*)p1, (const float*)p2, (const float*)o,
                  (const float*)d, (const float*)table, (const float*)cyw,
                  (const float*)shear, (float*)t, (float*)u, (int32_t*)idx, (bool*)live,
                  (float*)top, (float*)bot, (int32_t*)mask, SD, C, W, K, near_, far_, p11,
                  Hf);
  };
  cudaError_t err;
  if (K <= 8)
    err = args(launch_cross<8>);
  else if (K <= 16)
    err = args(launch_cross<16>);
  else if (K <= 24)
    err = args(launch_cross<24>);
  else
    err = args(launch_cross<32>);
  return (int)err;
}

// W1's outputs, mask (B,) i32, ovf_in (B,) bool, table (B, SD, C), aw
// (2 * wc, n_words) i32, cyw, shear (B,), shift (B, n_cells) f32 or null
// -> records (B, ns * 5, 16, W), words (B, ns, n_words, W) i32, ovf_out
// (B,) bool, with ns = min(kc, K), or K when kc = 0.
extern "C" int tdt_walk_records(const void* t, const void* u, const void* idx,
                                const void* live, const void* top, const void* bot,
                                const void* mask, const void* ovf_in, const void* table,
                                const void* aw, const void* cyw, const void* shear,
                                const void* shift, void* records, void* words,
                                void* ovf_out, int B, int SD, int C, int W, int K, int kc,
                                int n_words, int wc, int n_cells, float p11, float Hf,
                                void* stream) {
  if (K < 1 || K > kKmaxLimit || kc < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  walk_records_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)u, (const int32_t*)idx, (const bool*)live,
      (const float*)top, (const float*)bot, (const int32_t*)mask, (const bool*)ovf_in,
      (const float*)table, (const int32_t*)aw, (const float*)cyw, (const float*)shear,
      (const float*)shift, (float*)records, (int32_t*)words, (bool*)ovf_out, SD, C, W, K,
      kc, n_words, wc, n_cells, p11, Hf);
  return (int)cudaGetLastError();
}
