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
// family's alpha words; one thread per env also writes its overflow. W2
// runs on every level; it reads each crossing's attributes from the
// attribute table at its row, or, on big levels where kernel B4 has
// selected them (render/portal.py:walk), from B4's (B, C, K * W) output.
//
// Bound. W1 reads the rows (B x SD x 16 bytes) and the prefix columns of
// its valid crossings and writes 6 x (B, K, W) words; its work is SD
// crossing tests per column, plus an insertion into the K-list for each
// valid crossing that enters it. W2 writes the records, 5 x 16 words per kept crossing
// and column (1.68 GB for one config-5 member at 640x400, 0.50 ms at 3.35
// TB/s), and reads a table row per crossing (or B4's selection): it is
// bound by the records' bytes.
//
// Design. One thread per column.
//  W1: up to 160 columns of one env per block, the most warps up to five
//  that split the env's warps evenly (W = 320 and 640: 160), so no lane
//  idles. The block stages the env's rows as (e, p1 - o) and the t
//  numerator (the same in every column) in shared memory, 512 rows at a
//  time. Each warp then keeps, by ballot, only the rows its 32 columns may
//  find valid (cull_row, a conservative test on the warp's two edge rays;
//  a few of a level's rows). Each thread keeps only the VALID
//  crossings of smallest (depth, row id), sorted as (t, id) in registers,
//  inserted at compile-time indices; scanning rows in id order and
//  shifting only past a strictly larger depth keeps equal depths in id
//  order. The stable sort's first K are those, then the invalid rows
//  (depth BIG_T) in row order: while the valid list is not full, each
//  thread appends every invalid row's id, culled rows included, to its
//  own slots in shared memory (at most KMAX); once it is full, no invalid
//  row can be among the first K. A kept row is divided only where it can
//  matter: a back-facing row (denom < 1e-12) is invalid at once, and a
//  front-facing one is first tested on its numerators against
//  conservatively rounded products (t within (near, min(far, the list's
//  last depth)), u within [0, 1]); only a row that may pass takes the two
//  correctly rounded divisions. Then, per kept crossing, t and u again
//  (sentinel slots included: their u feeds the alpha words) and the clip
//  window front to back in the thread: the valid crossings first, their
//  six table columns read together (a running max / min is the cummax /
//  cummin prefix; row heights only for solid crossings, two more for
//  two-sided ones), then the invalid ones, which leave the window as it
//  is. The mask is OR'd over a warp, then into the env's word with one
//  atomicOr per warp. Templated on KMAX, the list's length (8, 16, 24 or
//  32); any K <= KMAX gives the same first K.
//  W2: 128 columns per block; each block works out the kept crossings'
//  order from the mask once (in shared memory); each thread then reads its
//  column's crossings and their attributes (table rows through the
//  read-only cache: a small level's table is 42-57 KB per env; or B4's
//  selection, column-major, neighbouring threads on neighbouring
//  addresses) and writes the records and words, neighbouring threads on
//  neighbouring addresses.
// Every operation rounds where the plain version's does: built with
// --fmad=false; a true division where the plain version divides by a
// tensor; torch.remainder as fmod plus the sign fix (portal_shade.cuh);
// XLA's saturating f32 -> i32; `+ 0.0f` turns -0.0 into +0.0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "portal_shade.cuh"

namespace {

constexpr int kThreads = 128;     // W2: columns per block
constexpr int kMaxThreads = 160;  // W1: columns per block at most (5 warps)
constexpr int kChunk = 512;       // rows W1 stages at a time
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

// Insert (td, id) into the sorted list (kt, kid) at compile-time indices
// (a list indexed at run time would go to local memory): every entry past
// the first strictly larger depth moves up one slot, so equal depths keep
// row order.
template <int KMAX>
__device__ __forceinline__ void insert(float (&kt)[KMAX], int (&kid)[KMAX], float td,
                                       int id) {
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j) {
    const bool shift = td < kt[j - 1];
    const bool here = td < kt[j];
    kt[j] = shift ? kt[j - 1] : (here ? td : kt[j]);
    kid[j] = shift ? kid[j - 1] : (here ? id : kid[j]);
  }
  if (td < kt[0]) {
    kt[0] = td;
    kid[0] = id;
  }
}

// Row r of an env as W1 stages it: (e0, e1, po0, po1) and the t numerator,
// rounded as the plain version rounds them.
__device__ __forceinline__ void load_row(const float* p1b, const float* p2b, int r, float ox,
                                         float oz, float4& q, float& nt) {
  const float ax = __ldg(p1b + 2 * r), az = __ldg(p1b + 2 * r + 1);
  q = make_float4(__fsub_rn(__ldg(p2b + 2 * r), ax), __fsub_rn(__ldg(p2b + 2 * r + 1), az),
                  __fsub_rn(ax, ox), __fsub_rn(az, oz));
  nt = __fsub_rn(__fmul_rn(q.z, q.y), __fmul_rn(q.w, q.x));
}

// Whether a row can be valid in no column of a warp, given that every
// column's ray lies in the cone of the warp's two edge rays (da, db):
// denom, u's numerator nu and nu - denom are linear in the ray, so each
// is a non-negative combination of its values at the edges. A row is
// dropped only where one of them has the failing sign at both edges by a
// margin (1e-5 of its terms' size) far above every rounding of the edge
// values and of the columns' own arithmetic: back-facing everywhere, or
// front-facing everywhere with u < 0 or u > 1 everywhere. nt <= 0 fails
// t > near >= 0 in every front-facing column, exactly (nt is the same in
// every column).
__device__ __forceinline__ bool cull_row(float4 q, float nt, float da0, float da1, float db0,
                                         float db1) {
  if (!(nt > 0.0f)) return true;
  const float dda = da0 * q.y - da1 * q.x, ddb = db0 * q.y - db1 * q.x;
  const float mdd = fmaxf(fabsf(da0 * q.y) + fabsf(da1 * q.x), fabsf(db0 * q.y) + fabsf(db1 * q.x));
  const float tol_d = 1e-5f * mdd + 1e-30f;
  if (dda < -tol_d && ddb < -tol_d) return true;  // back-facing in every column
  if (!(dda > tol_d && ddb > tol_d)) return false;
  const float nua = q.z * da1 - q.w * da0, nub = q.z * db1 - q.w * db0;
  const float mnu = fmaxf(fabsf(q.z * da1) + fabsf(q.w * da0), fabsf(q.z * db1) + fabsf(q.w * db0));
  // The floor keeps |u| of a culled u < 0 far above 2^-150 (a quotient
  // that rounds to -0.0 passes u >= 0).
  const float tol_u = 1e-5f * mnu + 1e-30f * (1.0f + mdd);
  if (nua < -tol_u && nub < -tol_u) return true;  // u < 0
  return nua - dda > tol_u + tol_d && nub - ddb > tol_u + tol_d;  // u > 1
}

template <int KMAX>
__global__ void __launch_bounds__(kMaxThreads, 4) walk_cross_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ table, const float* __restrict__ cyw,
    const float* __restrict__ shear, float* __restrict__ t_out,
    float* __restrict__ u_out, int32_t* __restrict__ idx_out,
    bool* __restrict__ live_out, float* __restrict__ top_out,
    float* __restrict__ bot_out, int32_t* __restrict__ mask_out, int SD, int C,
    int W, int K, float near_, float far_, float p11, float Hf) {
  extern __shared__ float4 smem[];
  float4* rows = smem;                                   // a chunk's rows by position
  float* nts = reinterpret_cast<float*>(rows + kChunk);  // their t numerators
  int* wl = reinterpret_cast<int*>(nts + kChunk);        // per warp, the rows it keeps
  int* ids = wl + (blockDim.x >> 5) * kChunk;            // per thread, KMAX x nth
  const int nth = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int w = blockIdx.x * nth + tid;
  const bool act = w < W;
  const float ox = o[2 * b], oz = o[2 * b + 1];
  const float* dr = d + (size_t)b * W * 2;
  const float d0 = act ? dr[2 * w] : 0.0f, d1 = act ? dr[2 * w + 1] : 0.0f;
  // The warp's edge rays, and whether its rays lie in their cone, as the
  // walk's do (a sweep of fwd + right * x): only then, and for near >= 0,
  // does the warp cull rows (cull_row).
  const int wa = w - lane, last = min(31, W - 1 - wa);
  const float da0 = __shfl_sync(0xffffffffu, d0, 0), da1 = __shfl_sync(0xffffffffu, d1, 0);
  const float dl0 = __shfl_sync(0xffffffffu, d0, max(last, 0));
  const float dl1 = __shfl_sync(0xffffffffu, d1, max(last, 0));
  bool cone = true;
  if (act && last > 0) {
    const float na = fabsf(da0) + fabsf(da1), nl = fabsf(dl0) + fabsf(dl1);
    const float nw = fabsf(d0) + fabsf(d1), cr = da0 * dl1 - da1 * dl0;
    const float sg = cr > 0.0f ? 1.0f : -1.0f;
    cone = fabsf(cr) > 1e-6f * na * nl && sg * (da0 * d1 - da1 * d0) >= -1e-6f * na * nw &&
           sg * (d0 * dl1 - d1 * dl0) >= -1e-6f * nw * nl;
  }
  const bool cull = __all_sync(0xffffffffu, cone) && near_ >= 0.0f;
  int* mine = wl + warp * kChunk;
  const float* tb = table + (size_t)b * SD * C;

  // The valid crossings of smallest (depth, row id), sorted; nv of them.
  float kt[KMAX];
  int kid[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    kt[j] = INFINITY;
    kid[j] = 0;
  }
  int nv = 0, ninv = 0, prev = -1;
  // Until the list is full, every row that is not valid is invalid, and
  // the first of them (at most KMAX) fill the slots past the valid ones
  // (depth BIG_T, row order); once it is full, none of them can.
  auto invalid_upto = [&](int end) {  // rows prev + 1 .. end - 1, all invalid
    for (int r = prev + 1; r < end && nv < KMAX && ninv < KMAX; ++r) ids[ninv++ * nth + tid] = r;
  };

  const float* p1b = p1 + (size_t)b * SD * 2;
  const float* p2b = p2 + (size_t)b * SD * 2;
  for (int s0 = 0; s0 < SD; s0 += kChunk) {
    const int n = min(kChunk, SD - s0);
    __syncthreads();
    for (int i = tid; i < n; i += nth) {
      float4 q;
      float nt;
      load_row(p1b, p2b, s0 + i, ox, oz, q, nt);
      rows[i] = q;
      nts[i] = nt;
    }
    __syncthreads();
    if (wa >= W) continue;
    // The rows the warp's columns may find valid, in row order: a ballot
    // per 32 rows.
    int kept = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool keep = i < n && (!cull || !cull_row(rows[i], nts[i], da0, da1, dl0, dl1));
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (keep) mine[kept + __popc(bal & ((1u << lane) - 1u))] = i;
      kept += __popc(bal);
    }
    __syncwarp();
    if (!act || kept == 0) continue;
    // Software-pipelined: the next kept row is read while this one is
    // tested.
    int i_next = mine[0];
    float4 r_next = rows[i_next];
    float nt_next = nts[i_next];
    for (int j = 0; j < kept; ++j) {
      const int i = i_next, id = s0 + i;
      const float4 r = r_next;
      const float nt = nt_next;
      if (j + 1 < kept) {
        i_next = mine[j + 1];
        r_next = rows[i_next];
        nt_next = nts[i_next];
      }
      invalid_upto(id);
      prev = id;
      const float denom = __fsub_rn(__fmul_rn(d0, r.y), __fmul_rn(d1, r.x));
      const float last = kt[KMAX - 1];  // INFINITY until KMAX valid rows are in
      bool valid = false;
      // Only a front-facing row (denom > 0 and |denom| >= 1e-12) can be
      // valid. Its quotients are then tested first on their numerators,
      // conservatively (products rounded away from the quotient's side),
      // and divided only where the exact quotient may pass: t in (near,
      // min(far, last)), u in [0, 1] (u rounds to -0.0, which passes, only
      // above -2^-150; to 1.0 only up to 1 + 2^-24).
      if (denom >= 1e-12f) {
        const float nu = __fsub_rn(__fmul_rn(r.z, d1), __fmul_rn(r.w, d0));
        if (nt > __fmul_rd(near_, denom) && nt < __fmul_ru(fminf(far_, last), denom) &&
            nu > -__fmul_ru(denom, 0x1p-149f) && nu < __fmul_ru(denom, 0x1.000004p+0f)) {
          const float t = __fdiv_rn(nt, denom);
          if (t > near_ && t < far_ && t < last) {
            const float u = __fdiv_rn(nu, denom);
            valid = u >= 0.0f && u <= 1.0f;
            if (valid) {
              insert<KMAX>(kt, kid, t, id);
              nv += nv < KMAX;
            }
          }
        }
      }
      if (!valid && nv < KMAX && ninv < KMAX) ids[ninv++ * nth + tid] = id;
    }
  }
  if (!act) return;
  invalid_upto(SD);

  // The first K of the stable sort: the valid crossings (slots KMAX - nv
  // on), then the invalid rows in row order (slots 0 on; of those, only
  // the first K - nv are read, and they end below KMAX - nv).
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < nv) ids[(KMAX - nv + k) * nth + tid] = kid[k];

  // Per kept crossing: t and u again (the same operations) and the clip
  // window front to back (the cummax / cummin prefix is a running max /
  // min). The valid crossings first, their six table columns read at once;
  // then the invalid ones, which leave the window as it is.
  const float cy = cyw[b], sh = shear[b];
  const size_t at0 = (size_t)b * K * W + w;
  float ct = kNeg, cb = kPos;
  bool blk = false;
  unsigned bits = 0u;
  const int kv = min(nv, K);
  for (int k = 0; k < kv; ++k) {
    const int id = ids[(KMAX - nv + k) * nth + tid];
    const float* pr = tb + (size_t)id * C;
    const float hbv = __ldg(pr + C_HB), solid = __ldg(pr + C_SOLID);
    const float h_fc = __ldg(pr + C_CEILROW), h_ff = __ldg(pr + C_FLOORROW);
    const float h_bc = __ldg(pr + C_BCROW), h_bf = __ldg(pr + C_BFROW);
    float4 q;
    float nt;
    if (SD <= kChunk) {
      q = rows[id];
      nt = nts[id];
    } else {
      load_row(p1b, p2b, id, ox, oz, q, nt);
    }
    const float denom = __fsub_rn(__fmul_rn(d0, q.y), __fmul_rn(d1, q.x));  // >= 1e-12
    const float t = __fdiv_rn(nt, denom);
    const float u = __fdiv_rn(__fsub_rn(__fmul_rn(q.z, d1), __fmul_rn(q.w, d0)), denom);
    const float top = tmax(ct, 0.0f);
    const float bot = tmin(cb, Hf);
    bool blocker = false;  // sprites and masked middles never occlude
    if (solid > 0.5f) {
      const float r_fc = row_of(h_fc, t, cy, sh, p11, Hf);
      const float r_ff = row_of(h_ff, t, cy, sh, p11, Hf);
      float step_top = r_fc, step_bot = r_ff;
      blocker = true;
      if (hbv > 0.5f) {
        const float r_bc = row_of(h_bc, t, cy, sh, p11, Hf);
        const float r_bf = row_of(h_bf, t, cy, sh, p11, Hf);
        step_top = tmax(r_fc, r_bc);
        step_bot = tmin(r_ff, r_bf);
        blocker = tmax(tmax(top, r_fc), r_bc) >= tmin(tmin(bot, r_ff), r_bf);
      }
      ct = tmax(ct, step_top);
      cb = tmin(cb, step_bot);
    }
    const bool live = !blk;
    const size_t at = at0 + (size_t)k * W;
    t_out[at] = t;
    u_out[at] = u;
    idx_out[at] = id;
    live_out[at] = live;
    top_out[at] = top;
    bot_out[at] = bot;
    blk = blk || blocker;
    bits |= (unsigned)live << k;
  }
  const float top = tmax(ct, 0.0f), bot = tmin(cb, Hf);
#pragma unroll 4
  for (int k = kv; k < K; ++k) {
    const int id = ids[(k - nv) * nth + tid];
    float4 q;
    float nt;
    if (SD <= kChunk) {
      q = rows[id];
    } else {
      load_row(p1b, p2b, id, ox, oz, q, nt);
    }
    const float denom = __fsub_rn(__fmul_rn(d0, q.y), __fmul_rn(d1, q.x));
    const size_t at = at0 + (size_t)k * W;
    t_out[at] = kBigT;
    u_out[at] = __fdiv_rn(__fsub_rn(__fmul_rn(q.z, d1), __fmul_rn(q.w, d0)),
                          fabsf(denom) < 1e-12f ? 1.0f : denom);
    idx_out[at] = id;
    live_out[at] = false;
    top_out[at] = top;
    bot_out[at] = bot;
  }
  bits = __reduce_or_sync(__activemask(), bits);
  if (lane == __ffs(__activemask()) - 1 && bits)
    atomicOr(reinterpret_cast<unsigned*>(mask_out) + b, bits);
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

// SEL: the attributes are B4's selection (B, C, K * W), else the table
// (B, SD, C) read at row idx.
template <bool SEL>
__global__ void __launch_bounds__(kThreads) walk_records_kernel(
    const float* __restrict__ t_in, const float* __restrict__ u_in,
    const int32_t* __restrict__ idx_in, const bool* __restrict__ live_in,
    const float* __restrict__ top_in, const float* __restrict__ bot_in,
    const int32_t* __restrict__ mask, const bool* __restrict__ ovf_in,
    const float* __restrict__ attr, const int32_t* __restrict__ aw,
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
  const float* ab = attr + (size_t)b * (SEL ? (size_t)C * K * W : (size_t)SD * C);
  const int kw = K * W;
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
    // Column c of this crossing: its table row's, or B4's selection's
    // (column-major, neighbouring threads on neighbouring addresses).
    const float* row = SEL ? ab + (size_t)ord[j] * W + w : ab + (size_t)idx_in[at] * C;
    auto col = [&](int c) { return __ldg(row + (SEL ? c * kw : c)); };
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
cudaError_t launch_cross(dim3 grid, int nth, cudaStream_t s, const float* p1, const float* p2,
                         const float* o, const float* d, const float* table,
                         const float* cyw, const float* shear, float* t, float* u,
                         int32_t* idx, bool* live, float* top, float* bot, int32_t* mask,
                         int SD, int C, int W, int K, float near_, float far_, float p11,
                         float Hf) {
  // At most 40 KB (nth <= 160, KMAX <= 32): no opt-in needed.
  const size_t smem = kChunk * (sizeof(float4) + sizeof(float)) +
                      (size_t)(nth / 32) * kChunk * sizeof(int) + (size_t)KMAX * nth * sizeof(int);
  walk_cross_kernel<KMAX><<<grid, nth, smem, s>>>(p1, p2, o, d, table, cyw, shear, t, u,
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
  // Columns per block: the most warps, up to five, that split the row's
  // warps evenly (W = 320 or 640: 160 columns), so no lane idles.
  const int warps = (W + 31) / 32;
  int per = 1;
  for (int q = kMaxThreads / 32; q > 1 && per == 1; --q)
    if (warps % q == 0) per = q;
  const int nth = 32 * per;
  const dim3 grid((W + nth - 1) / nth, B);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    return launch(grid, nth, s, (const float*)p1, (const float*)p2, (const float*)o,
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

// W1's outputs, mask (B,) i32, ovf_in (B,) bool, the attributes: table
// (B, SD, C) read at row idx, or (table null) B4's selection sel (B, C,
// K * W); aw (2 * wc, n_words) i32, cyw, shear (B,), shift (B, n_cells)
// f32 or null -> records (B, ns * 5, 16, W), words (B, ns, n_words, W)
// i32, ovf_out (B,) bool, with ns = min(kc, K), or K when kc = 0.
extern "C" int tdt_walk_records(const void* t, const void* u, const void* idx,
                                const void* live, const void* top, const void* bot,
                                const void* mask, const void* ovf_in, const void* table,
                                const void* sel, const void* aw, const void* cyw,
                                const void* shear,
                                const void* shift, void* records, void* words,
                                void* ovf_out, int B, int SD, int C, int W, int K, int kc,
                                int n_words, int wc, int n_cells, float p11, float Hf,
                                void* stream) {
  if (K < 1 || K > kKmaxLimit || kc < 0 || !table == !sel) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  auto kernel = sel ? walk_records_kernel<true> : walk_records_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)u, (const int32_t*)idx, (const bool*)live,
      (const float*)top, (const float*)bot, (const int32_t*)mask, (const bool*)ovf_in,
      (const float*)(sel ? sel : table), (const int32_t*)aw, (const float*)cyw,
      (const float*)shear, (const float*)shift, (float*)records, (int32_t*)words,
      (bool*)ovf_out, SD, C, W, K, kc, n_words, wc, n_cells, p11, Hf);
  return (int)cudaGetLastError();
}
