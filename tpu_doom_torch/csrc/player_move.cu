// Kernel B1: one tick's swept-sphere collision sequence per env.
//
// Replaces tpu_doom/ops/collision_pallas.py:player_move_pallas (kernel
// _move_kernel, math _move_core / _sweep_tile). The arithmetic is the
// plain version's (tpu_doom_torch/ops/collision.py:_sweep) operation for
// operation; built with --fmad=false so no a*b+c contracts, which keeps
// the two bit-identical.
//
// Bound: latency. Per env the work is a chain of sweeps over M triangles
// (102 on :test:), each a few hundred dependent operations with IEEE
// divisions and square roots, then an argmin; bytes (13 M floats) and
// operations are far below what the card moves in the same time.
//
// Design: one block per env, every sweep spread over the block's threads,
// one triangle test per thread per pass (M <= 128 on :test:).
//   * The env's rows are staged once in shared memory (13 x M floats) and
//     read from there by every sweep.
//   * The ground probe, the noclip probe and the first clip substep depend
//     only on the input state, so they run at once: the block holds a
//     group of 128 threads for each (two groups without the noclip probe),
//     and each group tests every triangle for its sweep.
//   * The nearest hit is an argmin over (dist, index), lower index on ties
//     (jnp.argmin's rule): a warp-shuffle min carrying the candidate's
//     normal, then one step over the warps' results in shared memory, in
//     two buffers used in turn, so one barrier per sweep.
//   * Substeps 2..S run only while the env is still blocked: an env that
//     is not blocked moves by its whole displacement and the plain
//     version's later substeps change nothing. Every thread holds the same
//     reduced result, so the loop's exit is uniform across the block.
// Any M >= 1 and B >= 1 work; the rows' shared memory above 48 KB (M > 945)
// asks for the opt-in, and a refusal is returned as the error.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr float kBig = 1e4f;
constexpr float kFeetRadius = 0.2f;
constexpr float kProbeH = 2000.0f;
constexpr int kGroup = 128;  // threads per sweep of the first pass
constexpr int kMaxGroups = 3;
constexpr int kMaxWarps = kGroup * kMaxGroups / 32;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// jnp.minimum: NaN-propagating.
__device__ __forceinline__ float jmin(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

// One sweep's sphere: centre, unit direction, radius.
struct Ray {
  float cx, cy, cz, nvx, nvy, nvz, sp_safe, radius, rr, cc;
  bool moving;
};

__device__ __forceinline__ Ray make_ray(float cx, float cy, float cz,
                                        float dx, float dy, float dz,
                                        float radius) {
  Ray r;
  const float speed = sqrtf(dx * dx + dy * dy + dz * dz);
  r.moving = speed > 0.0f;
  r.sp_safe = r.moving ? speed : 1.0f;
  r.nvx = dx / r.sp_safe;
  r.nvy = dy / r.sp_safe;
  r.nvz = dz / r.sp_safe;
  r.cx = cx;
  r.cy = cy;
  r.cz = cz;
  r.radius = radius;
  r.cc = dot3(cx, cy, cz, cx, cy, cz);
  r.rr = radius * radius;
  return r;
}

// A sweep's best hit so far: distance (inf for none), triangle index,
// contact normal (not yet normalised).
struct Cand {
  float d;
  int i;
  float nx, ny, nz;
};

__device__ __forceinline__ bool better(float d, int i, const Cand& c) {
  return d < c.d || (d == c.d && i < c.i);
}

// The swept sphere `ray` against triangle m of the staged rows (13, M);
// updates `best`.
__device__ __forceinline__ void test_triangle(const float* __restrict__ rows,
                                              int M, int m, const Ray& ray,
                                              Cand& best) {
  const float inf = __int_as_float(0x7f800000);
  const float cx = ray.cx, cy = ray.cy, cz = ray.cz;
  const float nvx = ray.nvx, nvy = ray.nvy, nvz = ray.nvz;
  const float radius = ray.radius, rr = ray.rr, cc = ray.cc;
  float v[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) v[c] = rows[c * M + m];
  const bool tri_mask = rows[12 * M + m] > 0.5f;
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float v1x = v[3], v1y = v[4], v1z = v[5];
  const float v2x = v[6], v2y = v[7], v2z = v[8];
  const float nx = v[9], ny = v[10], nz = v[11];

  float ndv = dot3(nx, ny, nz, nvx, nvy, nvz);
  bool facing = ndv < 0.0f;
  float intercept = -dot3(v0x, v0y, v0z, nx, ny, nz);
  float spd = dot3(cx, cy, cz, nx, ny, nz) + intercept;
  bool not_behind = spd >= -radius;

  float min_dist = kBig, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;

  // Plane face test with point-in-triangle.
  float safe_ndv = ndv == 0.0f ? -1.0f : ndv;
  float dist = -(spd - radius) / safe_ndv;
  float opx = cx + nvx * dist, opy = cy + nvy * dist, opz = cz + nvz * dist;
  float ux = v1x - v0x, uy = v1y - v0y, uz = v1z - v0z;
  float vx_ = v2x - v0x, vy_ = v2y - v0y, vz_ = v2z - v0z;
  float cnx = uy * vz_ - uz * vy_;
  float cny = uz * vx_ - ux * vz_;
  float cnz = ux * vy_ - uy * vx_;
  float wx = opx - v0x, wy = opy - v0y, wz = opz - v0z;
  float n2 = dot3(cnx, cny, cnz, cnx, cny, cnz);
  float n2_safe = n2 == 0.0f ? 1.0f : n2;
  float uwx = uy * wz - uz * wy;
  float uwy = uz * wx - ux * wz;
  float uwz = ux * wy - uy * wx;
  float gamma = dot3(uwx, uwy, uwz, cnx, cny, cnz) / n2_safe;
  float wvx = wy * vz_ - wz * vy_;
  float wvy = wz * vx_ - wx * vz_;
  float wvz = wx * vy_ - wy * vx_;
  float beta = dot3(wvx, wvy, wvz, cnx, cny, cnz) / n2_safe;
  float alpha = 1.0f - gamma - beta;
  bool inside = (n2 > 0.0f) && (alpha >= 0.0f) && (alpha <= 1.0f) &&
                (beta >= 0.0f) && (beta <= 1.0f) && (gamma >= 0.0f) &&
                (gamma <= 1.0f);
  if ((spd >= radius) && inside) {
    min_dist = dist;
    bnx = nx;
    bny = ny;
    bnz = nz;
  }

  // Vertex tests.
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float px = v[3 * k], py = v[3 * k + 1], pz = v[3 * k + 2];
    float b = 2.0f * dot3(-nvx, -nvy, -nvz, px - cx, py - cy, pz - cz);
    float c = cc + dot3(px, py, pz, px, py, pz) -
              2.0f * dot3(px, py, pz, cx, cy, cz) - rr;
    float disc = b * b - 4.0f * c;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float r1 = (-b + sq) / 2.0f;
    float r2 = (-b - sq) / 2.0f;
    float d = disc >= 0.0f ? jmin(r1, r2) : inf;
    if ((d >= 0.0f) && (d < min_dist)) {
      min_dist = d;
      bnx = cx - (px - nvx * d);
      bny = cy - (py - nvy * d);
      bnz = cz - (pz - nvz * d);
    }
  }

  // Edge tests: (v0, v1), (v1, v2), (v2, v0).
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int k2 = (k + 1) % 3;
    float e1x = v[3 * k], e1y = v[3 * k + 1], e1z = v[3 * k + 2];
    float e2x = v[3 * k2], e2y = v[3 * k2 + 1], e2z = v[3 * k2 + 2];
    float edx = e2x - e1x, edy = e2y - e1y, edz = e2z - e1z;
    float enx = nvy * edz - nvz * edy;
    float eny = nvz * edx - nvx * edz;
    float enz = nvx * edy - nvy * edx;
    float en_mag = sqrtf(dot3(enx, eny, enz, enx, eny, enz));
    bool en_ok = en_mag >= 1e-16f;
    float en_div = fmaxf(en_mag, 1e-30f);
    enx = en_ok ? enx / en_div : 0.0f;
    eny = en_ok ? eny / en_div : 0.0f;
    enz = en_ok ? enz / en_div : 0.0f;
    float edge_intercept = -dot3(e1x, e1y, e1z, enx, eny, enz);
    float edge_distance = dot3(cx, cy, cz, enx, eny, enz) + edge_intercept;
    bool near_plane = fabsf(edge_distance) <= radius;
    float circle_r = sqrtf(fmaxf(rr - edge_distance * edge_distance, 0.0f));
    float ccx = cx - enx * edge_distance;
    float ccy = cy - eny * edge_distance;
    float ccz = cz - enz * edge_distance;
    float ecx = ccx - e1x, ecy = ccy - e1y, ecz = ccz - e1z;
    float edge_m2 = fmaxf(dot3(edx, edy, edz, edx, edy, edz), 1e-30f);
    float fr = dot3(ecx, ecy, ecz, edx, edy, edz) / edge_m2;
    float olx = e1x + edx * fr, oly = e1y + edy * fr, olz = e1z + edz * fr;
    float dirx = olx - ccx, diry = oly - ccy, dirz = olz - ccz;
    float dmag = sqrtf(dot3(dirx, diry, dirz, dirx, diry, dirz));
    bool d_ok = dmag >= 1e-16f;
    float d_div = fmaxf(dmag, 1e-30f);
    dirx = d_ok ? dirx / d_div : 0.0f;
    diry = d_ok ? diry / d_div : 0.0f;
    dirz = d_ok ? dirz / d_div : 0.0f;
    float cax = ccx + dirx * circle_r;
    float cay = ccy + diry * circle_r;
    float caz = ccz + dirz * circle_r;

    float a0 = fabsf(enx), a1 = fabsf(eny), a2 = fabsf(enz);
    bool use12 = (a0 > a1) && (a0 > a2);
    bool use_z = use12 || (a1 > a2);
    float p1x = use12 ? cay : cax, p1y = use_z ? caz : cay;
    float qx = cax + nvx, qy = cay + nvy, qz = caz + nvz;
    float p2x = use12 ? qy : qx, p2y = use_z ? qz : qy;
    float q1x = use12 ? e1y : e1x, q1y = use_z ? e1z : e1y;
    float q2x = use12 ? e2y : e2x, q2y = use_z ? e2z : e2y;
    float d1x = p2x - p1x, d1y = p2y - p1y;
    float d2x = q1x - q2x, d2y = q1y - q2y;
    float denom = d2y * d1x - d2x * d1y;
    bool nonpar = denom != 0.0f;
    float tt = (d2x * (p1y - q1y) - d2y * (p1x - q1x)) /
               (nonpar ? denom : 1.0f);
    float inx = cax + nvx * tt, iny = cay + nvy * tt, inz = caz + nvz * tt;
    bool between = dot3(e1x - inx, e1y - iny, e1z - inz, e2x - inx,
                        e2y - iny, e2z - inz) <= 0.0f;
    if (near_plane && nonpar && (tt >= 0.0f) && (tt < min_dist) && between) {
      min_dist = tt;
      bnx = cx - cax;
      bny = cy - cay;
      bnz = cz - caz;
    }
  }

  bool valid =
      ray.moving && facing && not_behind && (min_dist < kBig) && tri_mask;
  float d_or_inf = valid ? min_dist : inf;
  if (better(d_or_inf, m, best)) best = Cand{d_or_inf, m, bnx, bny, bnz};
}

// This thread's best over triangles first, first + stride, ...
__device__ __forceinline__ Cand sweep_part(const float* __restrict__ rows,
                                           int M, const Ray& ray, int first,
                                           int stride) {
  Cand best{__int_as_float(0x7f800000), INT_MAX, 0.0f, 0.0f, 0.0f};
  for (int m = first; m < M; m += stride) test_triangle(rows, M, m, ray, best);
  return best;
}

// Warp argmin of the candidates; lane 0 writes it to red[warp].
__device__ __forceinline__ void publish(Cand c, Cand* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.d = __shfl_xor_sync(0xffffffffu, c.d, off);
    o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
    o.nx = __shfl_xor_sync(0xffffffffu, c.nx, off);
    o.ny = __shfl_xor_sync(0xffffffffu, c.ny, off);
    o.nz = __shfl_xor_sync(0xffffffffu, c.nz, off);
    if (better(o.d, o.i, c)) c = o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
}

// The argmin over warps first .. first + n - 1 (after a barrier).
__device__ __forceinline__ Cand collect(const Cand* red, int first, int n) {
  Cand b = red[first];
  for (int w = first + 1; w < first + n; ++w)
    if (better(red[w].d, red[w].i, b)) b = red[w];
  return b;
}

struct SweepOut {
  float t, nx, ny, nz;
};

// A sweep's result from its argmin.
__device__ __forceinline__ SweepOut finish(const Cand& b, const Ray& ray) {
  // + 0.0f: the reference sums the selected lane with zeros (-0 -> +0).
  const float onx = b.nx + 0.0f, ony = b.ny + 0.0f, onz = b.nz + 0.0f;
  const float nmag = sqrtf(onx * onx + ony * ony + onz * onz);
  const bool n_ok = nmag >= 1e-16f;
  const float n_div = fmaxf(nmag, 1e-30f);
  SweepOut r;
  r.t = b.d / ray.sp_safe;
  r.nx = n_ok ? onx / n_div : 0.0f;
  r.ny = n_ok ? ony / n_div : 0.0f;
  r.nz = n_ok ? onz / n_div : 0.0f;
  return r;
}

__global__ void __launch_bounds__(kGroup* kMaxGroups)
    player_move_kernel(const float* __restrict__ rows,
                       const float* __restrict__ state8,
                       float* __restrict__ out, int M, float radius,
                       float height, float dt, int substeps) {
  extern __shared__ float srows[];  // (13, M)
  __shared__ Cand red[2][kMaxWarps];
  const int env = blockIdx.x;
  const float inf = __int_as_float(0x7f800000);
  const float* g = rows + (size_t)env * 13 * M;
  for (int k = threadIdx.x; k < 13 * M; k += blockDim.x) srows[k] = g[k];
  const float* st = state8 + (size_t)env * 8;
  const float px = st[0], py = st[1], pz = st[2];
  const float vx = st[3], vy = st[4], vz = st[5];
  const int groups = blockDim.x / kGroup;  // 3 with the noclip probe, else 2
  __syncthreads();

  // First pass: group 0 the ground probe, group 1 the first clip substep,
  // group 2 the noclip probe.
  float time_left = 0.0f + dt;
  float dx = vx * time_left, dy = vy * time_left, dz = vz * time_left;
  const Ray ground = make_ray(px, py, pz, 0.0f, 0.0f - height, 0.0f,
                              kFeetRadius);
  Ray clip = make_ray(px, py, pz, dx, dy, dz, radius);
  const Ray probe =
      make_ray(px + vx * dt, py + vy * dt + kProbeH * 0.5f, pz + vz * dt, 0.0f,
               0.0f - kProbeH, 0.0f, radius);
  const int group = threadIdx.x / kGroup;
  const Ray mine = group == 0 ? ground : group == 1 ? clip : probe;
  publish(sweep_part(srows, M, mine, threadIdx.x % kGroup, kGroup), red[0]);
  __syncthreads();
  constexpr int gw = kGroup / 32;
  const SweepOut gnd = finish(collect(red[0], 0, gw), ground);
  SweepOut c = finish(collect(red[0], gw, gw), clip);
  const float nt = groups == 3 ? finish(collect(red[0], 2 * gw, gw), probe).t
                               : inf;

  float cpx = px, cpy = py, cpz = pz, cvx = vx, cvy = vy, cvz = vz;
  for (int s = 0; s < substeps; ++s) {
    if (s > 0) {
      dx = cvx * time_left;
      dy = cvy * time_left;
      dz = cvz * time_left;
      clip = make_ray(cpx, cpy, cpz, dx, dy, dz, radius);
      publish(sweep_part(srows, M, clip, threadIdx.x, blockDim.x), red[s & 1]);
      __syncthreads();
      c = finish(collect(red[s & 1], 0, blockDim.x / 32), clip);
    }
    float dmag = sqrtf(dx * dx + dy * dy + dz * dz);
    float adjusted = c.t - 0.001f / (dmag > 0.0f ? dmag : 1.0f);
    bool blocked = (c.t < inf) && (adjusted < 1.0f);
    float tcl = fminf(fmaxf(c.t, 0.0f), 1.0f);
    float adv = blocked ? adjusted : 1.0f;
    cpx = cpx + dx * adv;
    cpy = cpy + dy * adv;
    cpz = cpz + dz * adv;
    if (!blocked) break;  // done: later substeps would change nothing
    float ndv = c.nx * cvx + c.ny * cvy + c.nz * cvz;
    cvx = cvx - c.nx * ndv;
    cvy = cvy - c.ny * ndv;
    cvz = cvz - c.nz * ndv;
    time_left = time_left * (1.0f - tcl);
  }

  if (threadIdx.x == 0) {
    float* o = out + (size_t)env * 16;
    o[0] = gnd.t;
    o[1] = gnd.nx;
    o[2] = gnd.ny;
    o[3] = gnd.nz;
    o[4] = cpx;
    o[5] = cpy;
    o[6] = cpz;
    o[7] = cvx;
    o[8] = cvy;
    o[9] = cvz;
    o[10] = nt;
    for (int k = 11; k < 16; ++k) o[k] = 0.0f;
  }
}

}  // namespace

extern "C" int tdt_player_move(const void* rows, const void* state8, void* out,
                               int B, int M, float radius, float height,
                               float dt, int substeps, int enable_noclip,
                               void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)13 * M * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        player_move_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const int threads = kGroup * (enable_noclip ? 3 : 2);
  player_move_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)state8, (float*)out, M, radius, height,
      dt, substeps);
  return (int)cudaGetLastError();
}
