// Kernels S1 (effects_rows) and S2 (player_triggers): the step's work
// around kernel B1 (player_move.cu), one launch each per level and tic.
//
// No Pallas kernel stands behind these. They are the port's counterparts
// of the XLA-fused code of tpu_doom/sim/step.py around its
// player_move_pallas call:
//   S1: the move effects (sim/effects.py, three masked phase passes per
//       object), the fly and noclip toggles, and B1's inputs: the
//       broad-phase rows of the env's grid cell with the objects' new
//       offsets folded in (sim/collision.py:broadphase_rows) and its
//       (B, 8) state;
//   S2: the post-sweep player math (sim/player.py:step_player_with_moves:
//       look, movement force, slowdown clamp, PD spring, gravity, noclip
//       snap, vel += force * dt), the look direction, the trigger poll
//       (sim/triggers.py:poll_triggers), the fired effects (apply_fired:
//       the last fired definition of an object wins, only_once triggers
//       die, the exit code is a max) and the clock: every field of the new
//       state but the object offsets and the toggles, which are S1's.
// Their plain versions are the port's PyTorch code
// (tpu_doom_torch/ops/step.py:effects_rows_ref, player_triggers_ref), and
// each kernel is held bitwise to it on the card: built with --fmad=false,
// every operation in the plain version's order and rounding (PyTorch's
// `s / x` is (1 / x) * s, its division by a device scalar one rounding),
// cosf / sinf as torch.cos / torch.sin call them (no fast math),
// PyTorch's NaN rules for minimum, maximum and clamps, signed zeros kept.
//
// Bound on the H100: launches. An env's work is a few hundred operations
// on a few dozen floats, plus S1's rows (13 x M floats: 7.3 MB for 1,024
// envs at M = 141, 2.2 us at 3.35 TB/s). The plain version runs it as
// ~495 PyTorch kernels a tic, each a graph node of ~1.6 us.
//
// Design: a warp per env, 8 envs to a block of 256 threads; warps talk
// only within themselves (__syncwarp), so an env never waits for another.
//   S1: lane l animates objects l, l + 32, ... and writes them; after
//       __syncwarp the lanes write the env's rows m = l, l + 32, ...,
//       reading each row's object offset back from S1's own output, which
//       __syncwarp orders within the warp.
//   S2: every lane computes the env's player math, the same bits in each
//       lane, so nothing is broadcast; lanes poll triggers k = l, ...
//       (the fired flags to the warp's shared memory, the exit code by a
//       warp max), then insert definitions d = l, ... by a shared-memory
//       atomicMax of d + 1 per object (the last fired definition wins),
//       then write the objects. The scene's trigger and effect tables are
//       read from global memory: every warp reads them whole, coalesced,
//       and they stay in L1 and L2 (~1 KB a level).
// Any B, O, M, K and D >= 0 work; S2's shared memory (per warp O ints and
// K bytes) above 48 KB asks for the opt-in, and a refusal is returned.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;  // envs per block
constexpr int kThreads = 32 * kWarps;
constexpr size_t kStaticSmem = 48 * 1024;
constexpr float kI32MaxF = 2147483520.0f;  // the largest f32 below 2**31
constexpr float kGravity = 17.0f;          // sim/player.py:GRAVITY
constexpr float kProbeH = 2000.0f;         // sim/player.py:NOCLIP_PROBE_H
constexpr float kPushRange = 0.5f;         // sim/triggers.py:PUSH_RANGE
constexpr float kShootRange = 100.0f;      // sim/triggers.py:SHOOT_RANGE
constexpr int kPush = 1, kSwitch = 2, kWalkover = 3, kGun = 4;  // trigger types
constexpr int kExitNone = 0;

// torch.maximum / torch.minimum / clamp_min on CUDA: a NaN operand wins,
// else fmaxf / fminf.
__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.sign on CUDA: (0 < a) - (a < 0), so +0 for either zero and NaN.
__device__ __forceinline__ float t_sign(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

// _numerics.to_i32: NaN -> 0, infinities to the range's ends, clamp, cast.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) x = 0.0f;
  else if (x == INFINITY) x = kI32MaxF;
  else if (x == -INFINITY) x = -2147483648.0f;
  return (int)fminf(fmaxf(x, -2147483648.0f), kI32MaxF);
}

// S1's operands, each a device pointer, in the order of the wrapper's
// lists (ops/step.py:effects_rows).
struct EffectsIn {
  const float* pos;             // (B, 3)
  const float* vel;             // (B, 3)
  const float* offset;          // (B, O) object_offset
  const bool* active;           // (B, O) eff_active
  const float* first;           // (B, O) eff_first
  const float* second;          // (B, O) eff_second
  const bool* has_second;       // (B, O) eff_has_second
  const float* wait;            // (B, O) eff_wait
  const float* speed;           // (B, O) eff_speed
  const bool* fly;              // (B,)
  const bool* noclip;           // (B,)
  const bool* fly_toggle;       // (B,)
  const bool* clip_toggle;      // (B,)
  const float* bp_origin;       // (2,)
  const float* bp_inv_cell;     // ()
  const int* bp_dims;           // (2,) nx, nz
  const int* bp_cells;          // (nx * nz, M) triangle ids, -1 padded
  const float* coll_v0;         // (T, 3)
  const float* coll_v1;         // (T, 3)
  const float* coll_v2;         // (T, 3)
  const float* coll_normal;     // (T, 3)
  const int* coll_object;       // (T,)
};

struct EffectsOut {
  float* offset;                // (B, O)
  bool* active;                 // (B, O)
  float* first;                 // (B, O)
  bool* has_second;             // (B, O)
  float* wait;                  // (B, O)
  bool* fly;                    // (B,)
  bool* noclip;                 // (B,)
  float* rows;                  // (B, 13, M) [v0 | v1 | v2 | normal | mask]
  float* state8;                // (B, 8) [pos vel 0 0]
};

__global__ void __launch_bounds__(kThreads)
    effects_rows_kernel(EffectsIn in, EffectsOut out, int B, int O, int M,
                        float dt) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t eo = (size_t)b * O;

  // animate_effects: three masked phase passes per object.
  for (int o = lane; o < O; o += 32) {
    const size_t i = eo + o;
    float offset = in.offset[i], first = in.first[i], wait = in.wait[i];
    const float second = in.second[i], speed = in.speed[i];
    bool active = in.active[i], has_second = in.has_second[i];
    float budget = active ? dt : 0.0f;
    bool done = false;
    for (int pass = 0; pass < 3; ++pass) {
      bool run = active && !done;
      const bool needs_move = run && first != offset;
      const float diff = first - offset;
      const float sign = t_sign(diff);
      const float time_to_target = fabsf(diff) / t_max(speed, 1e-30f);
      const bool partial = needs_move && time_to_target > budget;
      if (needs_move) offset = partial ? offset + sign * speed * budget : first;
      if (needs_move && !partial) budget = budget - time_to_target;
      const bool stalled = partial;
      run = run && !stalled;
      const bool wait_blocks = run && wait > budget;
      if (wait_blocks) wait = wait - budget;
      if (run && !wait_blocks) {
        budget = budget - wait;
        wait = 0.0f;
      }
      run = run && !wait_blocks;
      const bool promote = run && has_second;
      if (promote) {
        first = second;
        has_second = false;
      }
      const bool finished = run && !promote;
      if (finished) active = false;
      done = done || stalled || wait_blocks || finished;
    }
    out.offset[i] = offset;
    out.active[i] = active;
    out.first[i] = first;
    out.has_second[i] = has_second;
    out.wait[i] = wait;
  }
  if (lane == 0) {
    out.fly[b] = in.fly[b] != in.fly_toggle[b];
    out.noclip[b] = in.noclip[b] != in.clip_toggle[b];
  }
  if (lane < 8)
    out.state8[(size_t)b * 8 + lane] = lane < 3   ? in.pos[(size_t)b * 3 + lane]
                                       : lane < 6 ? in.vel[(size_t)b * 3 + lane - 3]
                                                  : 0.0f;

  // broadphase_rows: the env's grid cell, then its M rows.
  const float inv = in.bp_inv_cell[0];
  const float rel0 = (in.pos[(size_t)b * 3] - in.bp_origin[0]) * inv;
  const float rel1 = (in.pos[(size_t)b * 3 + 2] - in.bp_origin[1]) * inv;
  const int nx = in.bp_dims[0], nz = in.bp_dims[1];
  const int cx = min(max(to_i32(floorf(rel0)), 0), nx - 1);
  const int cz = min(max(to_i32(floorf(rel1)), 0), nz - 1);
  const int* cell = in.bp_cells + (size_t)(cx * nz + cz) * M;
  __syncwarp();  // the objects' new offsets, written above, are read below
  float* rows = out.rows + (size_t)b * 13 * M;
  for (int m = lane; m < M; m += 32) {
    const int idx = cell[m];
    const int t = max(idx, 0);
    const float dy = out.offset[eo + in.coll_object[t]];
    const float* v0 = in.coll_v0 + 3 * (size_t)t;
    const float* v1 = in.coll_v1 + 3 * (size_t)t;
    const float* v2 = in.coll_v2 + 3 * (size_t)t;
    const float* n = in.coll_normal + 3 * (size_t)t;
    rows[0 * M + m] = v0[0];
    rows[1 * M + m] = v0[1] + dy;
    rows[2 * M + m] = v0[2];
    rows[3 * M + m] = v1[0];
    rows[4 * M + m] = v1[1] + dy;
    rows[5 * M + m] = v1[2];
    rows[6 * M + m] = v2[0];
    rows[7 * M + m] = v2[1] + dy;
    rows[8 * M + m] = v2[2];
    rows[9 * M + m] = n[0];
    rows[10 * M + m] = n[1];
    rows[11 * M + m] = n[2];
    rows[12 * M + m] = idx >= 0 ? 1.0f : 0.0f;
  }
}

// S2's operands (ops/step.py:player_triggers).
struct PlayerIn {
  const float* mv;              // (B, 16) B1's output
  const float* pos;             // (B, 3)
  const float* vel;             // (B, 3)
  const float* yaw;             // (B,)
  const float* pitch;           // (B,)
  const float* last_height_diff;  // (B,)
  const float* time;            // (B,)
  const int* tick;              // (B,)
  const bool* trig_alive;       // (B, K)
  const int* exit_triggered;    // (B,)
  const bool* fly;              // (B,) S1's
  const bool* noclip;           // (B,) S1's
  const bool* active;           // (B, O) S1's
  const float* first;           // (B, O) S1's
  const float* second;          // (B, O) the state's
  const bool* has_second;       // (B, O) S1's
  const float* wait;            // (B, O) S1's
  const float* speed;           // (B, O) the state's
  const float* movement;        // (B, 2)
  const float* look;            // (B, 2)
  const bool* jump;             // (B,)
  const bool* push;             // (B,)
  const bool* shoot;            // (B,)
  const float* trig_origin;     // (K, 2)
  const float* trig_displace;   // (K, 2)
  const float* trig_length;     // (K,)
  const int* trig_type;         // (K,)
  const bool* trig_only_once;   // (K,)
  const int* trig_exit;         // (K,)
  const int* eff_trigger;       // (D,) trigger ids, in [0, K)
  const int* eff_object;        // (D,)
  const float* eff_first_offset;   // (D,)
  const float* eff_second_offset;  // (D,)
  const bool* eff_has_second;   // (D,)
  const float* eff_speed;       // (D,)
  const float* eff_wait;        // (D,)
};

struct PlayerOut {
  float* pos;                   // (B, 3)
  float* vel;                   // (B, 3)
  float* yaw;                   // (B,)
  float* pitch;                 // (B,)
  float* last_height_diff;      // (B,)
  float* time;                  // (B,)
  int* tick;                    // (B,)
  bool* trig_alive;             // (B, K)
  int* exit_triggered;          // (B,)
  bool* active;                 // (B, O)
  float* first;                 // (B, O)
  float* second;                // (B, O)
  bool* has_second;             // (B, O)
  float* wait;                  // (B, O)
  float* speed;                 // (B, O)
};

// The player config, rounded to f32 as the plain version's scalars are.
struct PlayerParams {
  float dt, height, move_force, friction, ground_drag, air_drag, spring_p,
      spring_d;
  float pitch_lo, pitch_hi;  // f32(f32(1e-2) -+ f32(pi / 2)), before - pitch
  float jump_vy;             // f32(JUMP_SPEED) / f32(dt)
  bool enable_noclip;
};

// sim/player.py:rotate_vec, R_y(yaw) @ R_x(pitch) @ v, from the angles'
// cos and sin.
__device__ __forceinline__ void rotate(float cy, float sy, float cx, float sx,
                                       float v0, float v1, float v2,
                                       float out[3]) {
  const float vy = v1 * cx - v2 * sx;
  const float vz = v1 * sx + v2 * cx;
  const float vx = v0;
  out[0] = vx * cy + vz * sy;
  out[1] = vy;
  out[2] = -vx * sy + vz * cy;
}

__device__ __forceinline__ float sum3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// sim/player.py:_normalize_or_zero, in place.
__device__ __forceinline__ void normalize_or_zero(float v[3]) {
  const float m = sqrtf(sum3(v, v));
  const bool ok = m >= 1e-16f;
  const float d = ok ? m : 1.0f;
  for (int i = 0; i < 3; ++i) v[i] = ok ? v[i] / d : 0.0f;
}

// sim/triggers.py:_segment_intersect for trigger k.
__device__ __forceinline__ bool segment_hit(const PlayerIn& in, int k, float ox,
                                            float oz, float dx, float dz,
                                            float length) {
  const float tox = in.trig_origin[2 * k], toz = in.trig_origin[2 * k + 1];
  const float tdx = in.trig_displace[2 * k], tdz = in.trig_displace[2 * k + 1];
  const float denom = dx * tdz - dz * tdx;
  const bool nonpar = fabsf(denom) >= 1e-16f;
  const float rx = tox - ox;
  const float rz = toz - oz;
  const float offset = (rx * tdz - rz * tdx) / (nonpar ? denom : 1.0f);
  const bool in_self = offset >= 0.0f && offset < length;
  const float px = ox + dx * offset;
  const float pz = oz + dz * offset;
  const float other = fabsf(tdx) > fabsf(tdz)
                          ? (px - tox) / (tdx == 0.0f ? 1.0f : tdx)
                          : (pz - toz) / (tdz == 0.0f ? 1.0f : tdz);
  const bool in_other = other >= 0.0f && other < in.trig_length[k];
  return nonpar && in_self && in_other;
}

__global__ void __launch_bounds__(kThreads)
    player_triggers_kernel(PlayerIn in, PlayerOut out, PlayerParams p, int B,
                           int K, int D, int O) {
  extern __shared__ int smem[];  // per warp: best (O ints), fired (K bytes)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  int* best = smem + (size_t)warp * (O + (K + 3) / 4);
  unsigned char* fired = reinterpret_cast<unsigned char*>(best + O);
  for (int o = lane; o < O; o += 32) best[o] = 0;

  // step_player_with_moves, in every lane.
  const float* mv = in.mv + (size_t)b * 16;
  const float pos[3] = {in.pos[3 * (size_t)b], in.pos[3 * (size_t)b + 1],
                        in.pos[3 * (size_t)b + 2]};
  const float vel[3] = {in.vel[3 * (size_t)b], in.vel[3 * (size_t)b + 1],
                        in.vel[3 * (size_t)b + 2]};
  const float pitch = in.pitch[b];
  const float look0 = in.look[2 * (size_t)b], look1 = in.look[2 * (size_t)b + 1];
  const float new_pitch =
      pitch + t_min(t_max(-look1, p.pitch_lo - pitch), p.pitch_hi - pitch);
  const float new_yaw = in.yaw[b] - look0;

  const float gt = mv[0];
  const bool grounded = isfinite(gt) && gt < 1.0f;
  const float height = grounded ? gt * p.height : p.height;
  const float gn[3] = {grounded ? mv[1] : 0.0f, grounded ? mv[2] : 0.0f,
                       grounded ? mv[3] : 0.0f};

  const float mx = in.movement[2 * (size_t)b], mz = in.movement[2 * (size_t)b + 1];
  const bool jump = in.jump[b], fly = in.fly[b];
  const float cx = cosf(new_pitch), sx = sinf(new_pitch);
  const float cy = cosf(new_yaw), sy = sinf(new_yaw);
  float fly_dir[3] = {mx, jump ? 0.5f : 0.0f, mz};
  normalize_or_zero(fly_dir);
  float fly_force[3];
  rotate(cy, sy, cx, sx, fly_dir[0], fly_dir[1], fly_dir[2], fly_force);
  float walk[3];
  rotate(cy, sy, cx, sx, mx, 0.0f, mz, walk);
  walk[1] = 0.0f;
  normalize_or_zero(walk);
  float force[3];
  const bool jumping = grounded && jump && vel[1] < 0.1f;
  for (int i = 0; i < 3; ++i) {
    fly_force[i] = fly_force[i] * p.move_force;
    walk[i] = walk[i] * p.move_force;
    const float grounded_force = jumping && i == 1 ? p.jump_vy : walk[i];
    const float ground_force = grounded ? grounded_force : walk[i] * 0.1f;
    force[i] = fly ? fly_force[i] : ground_force;
  }

  // The slowdown and its clamp. PyTorch's `s / x` is (1 / x) * s.
  const float speed = sqrtf(sum3(vel, vel));
  const bool has_speed = speed > 0.0f;
  const float safe_speed = has_speed ? speed : 1.0f;
  const float fly_k = (1.0f / safe_speed) * p.friction + p.ground_drag * speed;
  const float gdot = sum3(gn, vel);
  float tang[3];
  for (int i = 0; i < 3; ++i) tang[i] = vel[i] - gn[i] * gdot;
  const float tspeed = sqrtf(sum3(tang, tang));
  const bool has_t = tspeed > 0.0f;
  const float ground_k =
      (1.0f / (has_t ? tspeed : 1.0f)) * p.friction + p.ground_drag * tspeed;
  float slow[3];
  for (int i = 0; i < 3; ++i) {
    const float fly_slow = -vel[i] * fly_k;
    const float ground_slow = has_t ? -tang[i] * ground_k : 0.0f;
    slow[i] = fly ? fly_slow : grounded ? ground_slow : 0.0f;
    slow[i] = slow[i] - vel[i] * p.air_drag * speed;
  }
  const float slow_norm = sqrtf(sum3(slow, slow));
  const bool has_slow = has_speed && slow_norm > 0.0f;
  const float safe_norm = has_slow ? slow_norm : 1.0f;
  const float max_slow = -sum3(vel, slow) / safe_norm / p.dt;
  for (int i = 0; i < 3; ++i) {
    const float clamped =
        slow_norm >= max_slow ? slow[i] / safe_norm * max_slow : slow[i];
    force[i] = force[i] + (has_slow ? clamped : 0.0f);
  }

  // The ground spring and gravity.
  const float height_diff = p.height - height;
  const float derivative = (height_diff - in.last_height_diff[b]) / p.dt;
  force[1] = force[1] + (height_diff * p.spring_p + derivative * p.spring_d);
  force[1] = force[1] + (fly ? 0.0f : -kGravity);

  // Clip (B1's) or noclip commit, then vel += force * dt.
  float new_pos[3] = {mv[4], mv[5], mv[6]};
  float new_vel[3] = {mv[7], mv[8], mv[9]};
  if (p.enable_noclip && in.noclip[b]) {
    float q[3];
    for (int i = 0; i < 3; ++i) q[i] = pos[i] + vel[i] * p.dt;
    const float nt = mv[10];
    const float ground_y = isfinite(nt) ? q[1] + kProbeH * (0.5f - nt) : pos[1];
    const bool snap = !fly && q[1] <= ground_y;
    new_pos[0] = q[0];
    new_pos[1] = snap ? ground_y : q[1];
    new_pos[2] = q[2];
    new_vel[0] = vel[0];
    new_vel[1] = snap && vel[1] < 0.0f ? 0.0f : vel[1];
    new_vel[2] = vel[2];
  }
  for (int i = 0; i < 3; ++i) new_vel[i] = new_vel[i] + force[i] * p.dt;

  // poll_triggers: the walked segment and the aim from the moved player.
  float moved[3], look[3];
  for (int i = 0; i < 3; ++i) moved[i] = new_vel[i] * p.dt;
  rotate(cy, sy, cx, sx, 0.0f, 0.0f, -1.0f, look);
  const float wx = -moved[0], wz = -moved[2];
  const float wlen = sqrtf(wx * wx + wz * wz);
  const bool some_walk = wlen >= 1e-16f;
  const float wdiv = some_walk ? wlen : 1.0f;
  const float wdx = some_walk ? wx / wdiv : 0.0f;
  const float wdz = some_walk ? wz / wdiv : 0.0f;
  const float lmag = sqrtf(look[0] * look[0] + look[2] * look[2]);
  const bool ok_look = lmag >= 1e-16f;
  const float ldiv = ok_look ? lmag : 1.0f;
  const float lxn = ok_look ? look[0] / ldiv : 0.0f;
  const float lzn = ok_look ? look[2] / ldiv : 0.0f;
  const bool push = in.push[b], shoot = in.shoot[b];
  const float arange = push ? kPushRange : kShootRange;
  const float ox = new_pos[0], oz = new_pos[2];
  int code = INT_MIN;
  for (int k = lane; k < K; k += 32) {
    const bool walked = segment_hit(in, k, ox, oz, wdx, wdz, wlen);
    const bool aim = segment_hit(in, k, ox, oz, lxn, lzn, arange) && (push || shoot);
    const int type = in.trig_type[k];
    bool f = type == kWalkover                     ? walked
             : type == kPush || type == kSwitch ? aim && push
             : type == kGun                     ? aim && shoot
                                                : walked || (aim && push);
    // apply_fired: only live triggers fire; only_once ones die.
    const size_t bk = (size_t)b * K + k;
    const bool alive = in.trig_alive[bk];
    f = f && alive;
    out.trig_alive[bk] = alive && !(f && in.trig_only_once[k]);
    fired[k] = f;
    code = max(code, f ? in.trig_exit[k] : kExitNone);
  }
  code = __reduce_max_sync(0xffffffffu, code);
  __syncwarp();  // fired and the zeroed best, for every lane

  // apply_fired: the last fired definition of each object wins.
  for (int d = lane; d < D; d += 32) {
    const int obj = in.eff_object[d];
    if (fired[in.eff_trigger[d]] && obj >= 0 && obj < O) atomicMax(best + obj, d + 1);
  }
  __syncwarp();
  const size_t eo = (size_t)b * O;
  for (int o = lane; o < O; o += 32) {
    const int win = best[o];
    const bool has = win > 0;
    const int d = has ? win - 1 : 0;
    const size_t i = eo + o;
    out.active[i] = has ? true : in.active[i];
    out.first[i] = has ? in.eff_first_offset[d] : in.first[i];
    out.second[i] = has ? in.eff_second_offset[d] : in.second[i];
    out.has_second[i] = has ? in.eff_has_second[d] : in.has_second[i];
    out.wait[i] = has ? in.eff_wait[d] : in.wait[i];
    out.speed[i] = has ? in.eff_speed[d] : in.speed[i];
  }

  if (lane < 3) {  // selects, not new_pos[lane]: that would put the arrays in local memory
    out.pos[3 * (size_t)b + lane] = lane == 0 ? new_pos[0] : lane == 1 ? new_pos[1] : new_pos[2];
    out.vel[3 * (size_t)b + lane] = lane == 0 ? new_vel[0] : lane == 1 ? new_vel[1] : new_vel[2];
  }
  if (lane == 0) {
    out.yaw[b] = new_yaw;
    out.pitch[b] = new_pitch;
    out.last_height_diff[b] = height_diff;
    out.time[b] = in.time[b] + p.dt;
    out.tick[b] = in.tick[b] + 1;
    out.exit_triggered[b] = max(in.exit_triggered[b], code);
  }
}

int blocks(int B) { return (B + kWarps - 1) / kWarps; }

}  // namespace

// in / out: host arrays of device pointers in the order of struct
// EffectsIn / EffectsOut. B envs, O objects, M rows per grid cell.
extern "C" int tdt_effects_rows(const void* const* in, int n_in, void* const* out,
                                int n_out, int B, int O, int M, float dt,
                                void* stream) {
  if (n_in * sizeof(void*) != sizeof(EffectsIn) ||
      n_out * sizeof(void*) != sizeof(EffectsOut) || O < 0 || M < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  EffectsIn i;
  EffectsOut o;
  memcpy(&i, in, sizeof(i));
  memcpy(&o, out, sizeof(o));
  effects_rows_kernel<<<blocks(B), kThreads, 0, (cudaStream_t)stream>>>(
      i, o, B, O, M, dt);
  return (int)cudaGetLastError();
}

// in / out: host arrays of device pointers in the order of struct PlayerIn
// / PlayerOut; K triggers, D effect definitions, O objects; the player
// config rounded to f32 (struct PlayerParams).
extern "C" int tdt_player_triggers(const void* const* in, int n_in,
                                   void* const* out, int n_out, int B, int K,
                                   int D, int O, float dt, float height,
                                   float move_force, float friction,
                                   float ground_drag, float air_drag,
                                   float spring_p, float spring_d,
                                   float pitch_lo, float pitch_hi,
                                   float jump_vy, int enable_noclip,
                                   void* stream) {
  if (n_in * sizeof(void*) != sizeof(PlayerIn) ||
      n_out * sizeof(void*) != sizeof(PlayerOut) || K < 0 || D < 0 || O < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  PlayerIn i;
  PlayerOut o;
  memcpy(&i, in, sizeof(i));
  memcpy(&o, out, sizeof(o));
  const PlayerParams p{dt,       height,   move_force, friction, ground_drag,
                       air_drag, spring_p, spring_d,   pitch_lo, pitch_hi,
                       jump_vy,  enable_noclip != 0};
  const size_t smem = (size_t)kWarps * (O + (K + 3) / 4) * sizeof(int);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        player_triggers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  player_triggers_kernel<<<blocks(B), kThreads, smem, (cudaStream_t)stream>>>(
      i, o, p, B, K, D, O);
  return (int)cudaGetLastError();
}
