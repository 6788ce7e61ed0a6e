#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`tpu_doom_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: nvcc builds csrc/*.cu for sm_90a from the checkout (one nvcc
     per source, in parallel).
  3. kernels: each kernel against its plain PyTorch version on the card at
     main-path shapes, with error ceilings, and both timed (medians of
     single calls; the kernel also as the median of runs of 10 launches
     back to back, `ms_b2b`), beside its bound (bytes over 3.35 TB/s or
     f32 operations over 67 TFLOP/s, whichever is larger; B2's and B8's
     bytes are those these inputs need, from the plain version's
     winners; B1's operations the sweeps these inputs need, up to each
     env's first clip substep that is not blocked) and, where one PyTorch
     call computes the same function, that call's time (single and back
     to back). On :test: (B1: 256
     envs; B2, then B7 and B8 of the portal_jnp configuration on the same
     state: 256 envs at 320x200, with the chain B7 -> B8 against B2
     printed; B3 and B9: the 8 verify poses at 320x200, 3 layers, and
     the maze shape, fallback_sim's 128 pitched envs on :texstress: at
     reset, against the plain versions on 16 of them; their bounds count
     one coverage test per covering (pixel, triangle) pair, whatever K);
     on :texstress: at 320x200 x 256 envs after 8 bench ticks, from the
     port's own walk: B4 and B2 on the global table (records (256, 120,
     16, 320)) at shipped defaults, B6, B5 and B2's per-env mode with
     portal_global_segs_max=1024 (all bitwise; B6 and torch.scatter_add
     also as runs of 10 launches captured in a CUDA graph, the device time
     without the wrapper's host share); B1 on :texstress:'s rows (bitwise,
     with their M); the bank's shapes at 640x400: on config 5's MAP01
     after 8 bank ticks (padded to 141 walk rows, 1,024 envs), B1 on the
     rows of its next step and B2 in one launch (the plain version and
     the bound in slices of 256 envs); on the bank verify leg's MAP01
     under portal_jnp (64 envs, half pitched, its hole table padded to
     the bank's 67 rows), B7 and B8, then B3 and B9 on one block of the
     fallback (the 32 pitched envs one run of its WHILE node renders;
     the plain versions on 8 of them); all bitwise (B3: equal). The entry
     points' shapes at 64x40 (`*_entry`): B1 and B2 on entry()'s 2 envs
     after 4 walking ticks, B3 on the CLI's one env under its default
     backend ("auto") after the 21 ticks of its dump-frames pilot.
  4. tools: the kernels of the port's two instruments, which no main-path
     segment runs (their launch counts there stay 0). B10
     (tools/onehotbench.py): ldg, smem and copy bitwise against the plain
     version at the TPU tool's defaults (S, n, iters, grid) = (534, 3072,
     16, 64), which are launch-bound, at a ragged n = 3073, and at the
     main path's volume, one lookup per pixel of a 256-env 320x200 frame
     (n = 16,384,000, iters = grid = 1), beside one torch.take, each timed
     single and back to back. B11 (tools/kernelbudget.py): B2's
     eight stage-budget variants on the tool's inputs (:test: x 256 envs
     at 320x200, reset, yaws from default_rng(0)), each at 0 px against
     its plain version and `full` bitwise equal to B2's production kernel,
     each timed as the median of runs of 10 launches back to back, with
     each stage's share (full - variant) / full.
  5. goldens: the triangle path (B3) and the jnp path (B9) against
     tests/golden/frames.npz at 160x100, the portal (B2) and portal_jnp
     (B7, B8) paths on the 8 verify poses at 320x200 against
     tests/golden/verify_ref.npz, and the 8 :texstress: states of
     tests/golden/verify_texstress_ref.npz at 320x200 in both texel
     configs and under portal_jnp (all made by the JAX package); above
     320x200 (tests/golden/regen_torch_ref.py), through portal and
     portal_jnp, each pose within 16 px: the verify poses at 640x400,
     :doom2: at 800x600 (MAP01's sprites, MAP02's strobe), the bank verify
     leg at 640x400 (E1M1 and MAP01 on padded tables), where portal and
     portal_jnp also stay within 16 px of each other over the leg.
  6. main path: every segment runs with the launch counts set to 0 just
     before it and read just after; each eager segment (step_render) is
     followed, where named, by its `rollout_` twin through
     DoomSim.rollout: the tick captured as CUDA graphs and replayed, its
     first 8 replayed ticks held bitwise to 8 eager ones (frames and final
     state), its timed windows under torch.cuda.set_sync_debug_mode("error")
     (a host synchronisation inside rollout fails the run), its
     env*frames/s printed beside the eager median with the kernel launches
     per replay (replays add their launches to the counts; the triangle
     fallback's, a conditional node, are counted on the device where it
     ran); the share of envs on the triangle fallback is read from a device
     tally after each segment:
     bench, rollout: DoomSim on :test: at 320x200 x 256 envs, bench
       actions, 8 warm-up ticks, then 5 windows of 32 timed ticks of step
       + render; env*frames/s per window, their median and spread, and
       the process's CPU ms per tick beside the wall ms; then the same
       through rollout, and (fallback_form, not a segment) rollout with
       the triangle path over every env on every tick instead of the
       conditional node, timed beside it;
     fallback, rollout_fallback: 4 ticks with portal_pitch="triangle" and
       half the envs pitched, so the triangle path (B3) runs inside the
       main path (the bench trajectory never overflows the crossing
       budget), eager and replayed;
     oracle_fallback, rollout_oracle_fallback: the same under
       raster_backend="portal_jnp", through the jnp triangle path (B9);
     oracle, rollout_oracle: raster_backend="portal_jnp" (B7 and B8 every
       frame; 4 warm-up ticks, 3 windows of 8 ticks);
     texstress_fallback, texstress_oracle_fallback: both fallbacks on
       :texstress: (B3, B9 on a maze's triangles);
     texstress, texstress_act, rollout_texstress_act: DoomSim on
       :texstress: at 320x200 x 256 envs, bench actions, at shipped
       defaults (the big-level walk with B4) and with
       portal_global_segs_max=1024 (the active-set path: B6, B5, B2 per
       env; also replayed, and its fallback_form timed); 4 warm-up ticks,
       then 3 windows of 8 ticks;
     bank5, bank8: LevelBank ticks (step_with_exits, then every level's
       render; bank_main's actions with a 5 % push) of BASELINE config 5
       (E1M1, E1M2, MAP01, MAP02 x 1,024 envs at 640x400) and of bench.py's
       L=8 bank (+ :stress:4, :stress:6, :texstress:4x16, :texstress:6x24,
       x 512 envs): one eager warm-up tick, the tick captured as one CUDA
       graph (graphs.CapturedTick, the (state, active) pair its state),
       8 eager ticks in lockstep with 8 replays, bitwise equal in state,
       active mask and frames, then 3 windows of 4 (bank8: 8) ticks, each
       run eagerly and then replayed under set_sync_debug_mode("error")
       from the same state, both ending bitwise equal; env*frames/s eager
       and replayed per window and as medians, device ms per replay
       between CUDA events, envs on the triangle fallback per tick of
       each window, peak device memory;
     bank_big: E1M1 and :texstress: at portal_global_segs_max=1024 (every
       level on the big-level walk and the active set) x 64 envs at
       320x200, each level's frames bitwise those of the level alone, 8
       replays bitwise eager ticks;
     bank_oracle, bank_fallback: E1M1 and MAP01 x 64 envs at 640x400,
       half pitched under portal_pitch="triangle", 4 replays bitwise eager
       ticks: under portal_jnp (B7, B8 on the padded hole table, B9 in the
       fallback's WHILE node) and under portal (B2, B3 there);
     legacy: :test: x 256 envs, 150 ticks of bench actions through B1's
       path and collision_backend="legacy" with the broad phase on and
       off: legacy within 1e-3 of B1's path, its two forms bitwise equal.
  7. entry points, each a segment with the launch counts set to 0 before
     it and read after (in a subprocess, its own counts of its timed
     window, from its `launches` line), every JSON line printed:
     entry_bench: `python3 -m tpu_doom_torch.bench` at its defaults (the
       captured step + render + checksum tick, 256 envs at 320x200, 32
       timed replays);
     entry_bank: the same with BENCH_BANK=1 BENCH_TICKS=4 (config 5);
     entry_verify: `--verify`, all seven legs, which must pass;
     entry_cli: `python -m tpu_doom_torch.cli` in this process on the
       card at 64x40: list-levels, check, bench and demo at its default
       backend ("auto": B3), dump-frames under "portal" (B2) and "auto";
       each dump-frames then runs again with --device cpu (the kernels'
       plain versions), and the card's frames and manifest must equal the
       CPU's, bitwise;
     entry_fn: tpu_doom_torch.entry's fn captured as a CapturedTick with
       seeded walking actions, 4 replays bitwise equal to 4 eager ticks;
       the same 4 ticks from CPU copies of the state and actions, bitwise
       equal to the card's in state and frames; then a checkpoint of the
       card state saved and loaded back, bitwise.
     A subprocess that fails, or prints no JSON line, fails the run.
  8. parallel (tpu_doom_torch.parallel, entry.dryrun_multichip), each a
     segment with its launch counts (a world's summed over its ranks):
     parallel_dp1_nccl: dryrun_multichip(1), a world of one NCCL rank in
       a process of its own, both legs (:test: 2 envs at 320x200 through
       portal, one step + render; the E1M1 + MAP01 bank, one
       step_with_exits + render) captured with their collectives and
       replayed once, each held bitwise to the same tick unsharded and
       eager here, frames and state; its mean_metric equal to x.mean();
     parallel_dp2_gloo: dryrun_multichip(2, backend="gloo"), two ranks on
       this card, eagerly: each rank's state shard and frames bitwise the
       same envs of the unsharded run, the metrics equal on both ranks;
     parallel_bank5_sharded: config 5 through the bank under the mesh of
       a world of one NCCL rank (a process of its own), captured with the
       all-gather of its exit migration inside, 8 replays bitwise equal to
       the unsharded captured bank tick's in state, active mask and
       frames; env*frames/s and device ms per replay of both, in turns,
       and the all-gather's device us per call (numbers to record).
     A rank that fails, or prints no OK line, fails the run.
The last two lines: the kernels' JSON summary (launches summed over the
main-path segments, and per segment), then the device JSON.
Imports neither JAX nor the JAX package: the GPU machine has neither.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_doom_torch.bench import bank_actions, bank_tick, bench_actions
from tpu_doom_torch.tools.banks import BANK5, BANK8, BANK_H, BANK_W, make_bank
from tpu_doom_torch.tools.fixtures import (B_MAIN, H_MAIN, W_MAIN, action_seq,
                                           capture_bank_tick, fallback_sim, make_sim,
                                           verify_ref, verify_state)

WARMUP_TICKS, TIMED_TICKS, WINDOWS, FALLBACK_TICKS = 8, 32, 5, 4
TEX_WAD, TEX_CAP = ":texstress:", 1024  # portal_global_segs_max of the active set
TEX_WARMUP, TEX_TICKS, TEX_WINDOWS = 4, 8, 3
EQUAL_TICKS = 8  # replayed ticks held bitwise to eager ones per rollout segment
TIMING_CALLS = 20
BACK_TO_BACK = 10  # kernel launches per pair of CUDA events
PX_CEILING = 16  # per-frame mismatch ceiling of the verify legs (bench.py:90)
BANK5_E, BANK8_E = 1024, 512  # envs per level: 4,096 in all
BANK_WINDOWS, BANK_TICKS = 3, 4  # timed windows of replayed bank ticks
BANK8_TICKS = 8  # the L=8 bank's windows: its fallback's load varies by tick
BANK_BIG = ((":test:", 0), (TEX_WAD, 0))  # a member on the big-level walk
BANK_BIG_E = 64
BANK_ORACLE_E = 64  # envs per level of the bank verify leg's segments
BANK_PLAIN_ENVS = 8  # envs the plain B3 and B9 run on at the bank's shape
LEGACY_TICKS = 150
TRAJECTORY_DRIFT_CEILING = 1e-3  # tests/test_torch_sim.py
B3_REL_TOL = 1e-6
MAZE_PLAIN_ENVS = 16  # envs the plain B3 and B9 run on at the maze shape
ENTRY_BANK_TICKS = 4  # timed ticks of the bank benchmark in phase 7
ENTRY_REPLAYS = 4  # entry()'s replays held bitwise to eager ticks
ENTRY_W, ENTRY_H = 64, 40  # entry() and the CLI runs of phase 7
CLI_DUMP_TICKS = 21  # phase 7's dump-frames: frames after ticks 1, 11 and 21
PARALLEL_REPLAYS = 8  # phase 8: sharded bank replays held bitwise to unsharded ones
GATHER_CALLS = 32  # phase 8: timed calls of the bank's all-gather alone
MEAN_METRIC_RTOL = 1e-6  # mean_metric against x.mean(): the order of the sums

KERNELS = {
    "player_move": dict(
        source="tpu_doom_torch/csrc/player_move.cu",
        replaces="tpu_doom/ops/collision_pallas.py:358"),
    "render_portal_fused": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:854"),
    "peel_resolve": dict(
        source="tpu_doom_torch/csrc/peel_resolve.cu",
        replaces="tpu_doom/ops/raster_pallas.py:322"),
    "select_rows": dict(
        source="tpu_doom_torch/csrc/select_rows.cu",
        replaces="tpu_doom/ops/raster_pallas.py:1162"),
    "gather_cells": dict(
        source="tpu_doom_torch/csrc/gather_cells.cu",
        replaces="tpu_doom/ops/raster_pallas.py:1075"),
    "scatter_live": dict(
        source="tpu_doom_torch/csrc/scatter_live.cu",
        replaces="tpu_doom/ops/raster_pallas.py:1199"),
    # B2 on :texstress:'s global table, R = 120 records per column.
    "render_portal_fused_texstress": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:854"),
    # B2 reading per-env active tables (raster_pallas.py:854, per_env_tex).
    "render_portal_fused_per_env": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:854"),
    "classify_alpha": dict(
        source="tpu_doom_torch/csrc/classify_alpha.cu",
        replaces="tpu_doom/ops/raster_pallas.py:479"),
    "shade_portal": dict(
        source="tpu_doom_torch/csrc/shade_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:1394"),
    "depth_peel": dict(
        source="tpu_doom_torch/csrc/depth_peel.cu",
        replaces="tpu_doom/ops/raster_pallas.py:169"),
    # B3 and B9 on a maze's triangles: fallback_sim's 128 pitched envs on
    # :texstress: (T = 2,056 rows).
    "peel_resolve_maze": dict(
        source="tpu_doom_torch/csrc/peel_resolve.cu",
        replaces="tpu_doom/ops/raster_pallas.py:322"),
    "depth_peel_maze": dict(
        source="tpu_doom_torch/csrc/depth_peel.cu",
        replaces="tpu_doom/ops/raster_pallas.py:169"),
    # B2 at config 5's shape: the bank's MAP01 at 640x400, 1,024 envs.
    "render_portal_fused_bank": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:854"),
    # The bank's shapes at 640x400: B1 on config 5's MAP01 (1,024 envs,
    # the padded table); B7 and B8 on the oracle bank's MAP01 (the padded
    # hole table); B3 and B9 on one block of its fallback (32 envs).
    "player_move_bank": dict(
        source="tpu_doom_torch/csrc/player_move.cu",
        replaces="tpu_doom/ops/collision_pallas.py:358"),
    "classify_alpha_bank": dict(
        source="tpu_doom_torch/csrc/classify_alpha.cu",
        replaces="tpu_doom/ops/raster_pallas.py:479"),
    "shade_portal_bank": dict(
        source="tpu_doom_torch/csrc/shade_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:1394"),
    "peel_resolve_bank": dict(
        source="tpu_doom_torch/csrc/peel_resolve.cu",
        replaces="tpu_doom/ops/raster_pallas.py:322"),
    "depth_peel_bank": dict(
        source="tpu_doom_torch/csrc/depth_peel.cu",
        replaces="tpu_doom/ops/raster_pallas.py:169"),
    # The entry points' shapes at 64x40 (phase 7): B1 and B2 on entry()'s
    # 2 envs, B3 on the CLI's one env under its default backend, "auto".
    "player_move_entry": dict(
        source="tpu_doom_torch/csrc/player_move.cu",
        replaces="tpu_doom/ops/collision_pallas.py:358"),
    "render_portal_fused_entry": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:854"),
    "peel_resolve_entry": dict(
        source="tpu_doom_torch/csrc/peel_resolve.cu",
        replaces="tpu_doom/ops/raster_pallas.py:322"),
    # The instruments' kernels (phase 4); no main-path segment launches them.
    "onehot_lookup": dict(
        source="tpu_doom_torch/csrc/onehot_lookup.cu",
        replaces="tools/onehotbench.py:82"),
    "render_portal_ablated": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tools/kernelbudget.py:201"),
}
TOOL_KERNELS = ("onehot_lookup", "render_portal_ablated")

# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# H100 SXM's memory rate and its operations over the f32 rate outside the
# tensor cores (NVIDIA's data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operation counts per unit of work, floors from the kernels' sources:
PEEL_TEST_OPS = 20    # one coverage test: five 3-term dot products
SWEEP_TRI_OPS = 300   # one swept-sphere vs triangle test (face, 3 vertex, 3 edge)
SHADE_PIXEL_OPS = 60  # one pixel's shade (texel address, light row)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, calls=TIMING_CALLS, per_pair=1, warmup=2):
    """Median milliseconds per call over `calls` pairs of CUDA events, each
    pair around `per_pair` calls back to back, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_pair):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_pair)
    return float(np.median(times))


def graph_ms(fn):
    """Median ms per call of BACK_TO_BACK calls of `fn` captured as one
    CUDA graph, over TIMING_CALLS replays: the device time of back-to-back
    launches without the host's share. The launches the capture records
    run no kernel, so the launch counts are set back."""
    from tpu_doom_torch.ops import add_launches, host_launch_counts

    fn()
    torch.cuda.synchronize()
    before = host_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BACK_TO_BACK):
            fn()
    after = host_launch_counts()
    add_launches({k: before[k] - after[k] for k in after})
    return time_ms(graph.replay) / BACK_TO_BACK


def kernel_ms(fn):
    """A kernel's (ms, ms_b2b): the median ms of single launches, which
    includes whatever of the wrapper's host time the device waits for,
    and the median ms per launch over TIMING_CALLS runs of BACK_TO_BACK
    launches back to back, which is device time."""
    return time_ms(fn), time_ms(fn, per_pair=BACK_TO_BACK)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops=0.0):
    """{bound_ms, bound_by} for moving n_bytes and doing ops f32 operations."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def record(results, name, err, ms, ms_b2b, plain, n_bytes, ops=0.0,
           library_ms=None, library_ms_b2b=None):
    """Store a kernel's numbers and print its bound and yardstick."""
    results[name].update(max_abs_err=err, ms=ms, ms_b2b=ms_b2b, plain_ms=plain,
                         library_ms=library_ms, library_ms_b2b=library_ms_b2b,
                         **bound(n_bytes, ops))
    r = results[name]
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    if library_ms_b2b is not None:
        lib += f" ({library_ms_b2b:.4f} back to back)"
    print(f"[bound] {name}: {n_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP -> bound"
          f" {r['bound_ms']:.4f} ms by {r['bound_by']}; kernel {ms:.4f} ms"
          f" ({r['bound_ms'] / ms:.1%} of bound), {ms_b2b:.4f} ms back to back"
          f" ({r['bound_ms'] / ms_b2b:.1%}); one PyTorch call: {lib}")


@torch.no_grad()
def clip_substeps_run(rows, st8, radius, dt, substeps):
    """The clip substeps B1 runs per env on these inputs -> (B,) int64:
    each env's substeps up to and including its first that is not blocked
    (all `substeps` while it stays blocked). The plain version's substep
    loop (ops/collision.py:player_move_ref), counting the substeps before
    `done`."""
    from tpu_doom_torch._numerics import f32, rdiv
    from tpu_doom_torch.ops.collision import INF, _sweep

    comp = tuple(rows[:, i] for i in range(12))
    mask = rows[:, 12] > 0.5
    radius, dt = f32(radius), f32(dt)
    cpx, cpy, cpz, cvx, cvy, cvz = (st8[:, k:k + 1] for k in range(6))
    time_left = torch.zeros_like(cpx) + dt
    done = torch.zeros_like(cpx, dtype=torch.bool)
    runs = torch.zeros_like(cpx, dtype=torch.int64)
    for _ in range(substeps):
        runs += (~done).long()
        dx, dy, dz = cvx * time_left, cvy * time_left, cvz * time_left
        ct, cnx, cny, cnz = _sweep(comp, mask, cpx, cpy, cpz, dx, dy, dz, radius)
        dmag = torch.sqrt(dx * dx + dy * dy + dz * dz)
        adjusted = ct - rdiv(0.001, torch.where(dmag > 0.0, dmag, 1.0))
        blocked = (ct < INF) & (adjusted < 1.0) & ~done
        tcl = torch.clamp(ct, 0.0, 1.0)
        adv = torch.where(blocked, adjusted, 1.0)
        cpx = torch.where(done, cpx, cpx + dx * adv)
        cpy = torch.where(done, cpy, cpy + dy * adv)
        cpz = torch.where(done, cpz, cpz + dz * adv)
        ndv = cnx * cvx + cny * cvy + cnz * cvz
        cvx = torch.where(blocked, cvx - cnx * ndv, cvx)
        cvy = torch.where(blocked, cvy - cny * ndv, cvy)
        cvz = torch.where(blocked, cvz - cnz * ndv, cvz)
        time_left = torch.where(blocked, time_left * (1.0 - tcl), time_left)
        done = done | ~blocked
    return runs[:, 0]


def player_move_sweeps(rows, st8, radius, dt, substeps, enable_noclip):
    """The sweeps B1 must run on these inputs, summed over envs: per env
    the ground probe, the noclip probe when it is on, and the clip
    substeps up to and including the first that is not blocked."""
    runs = clip_substeps_run(rows, st8, radius, dt, substeps)
    return int(runs.sum()) + rows.shape[0] * (1 + int(bool(enable_noclip)))


def _distinct(t):
    return int(torch.unique(t).numel())


def _table_bytes(key, lin, crow, v1, hole, textured, tex, hole_bytes):
    """Bytes of the tables that the textured pixels read, each distinct
    entry once: the texel at `key` (its address, per env in the per-env
    mode), the hole byte (global table with holes) and, at pixels that are
    no hole, the colormap entry."""
    n = _distinct(key[textured]) * tex.element_size()
    if tex.dim() == 2 and hole_bytes is not None:
        n += _distinct((lin >> 3)[textured])
    return n + _distinct((crow * 256 + v1)[textured & ~hole])


def _kinds(kind):
    """(textured, wall, flat) masks of the classified kind channel."""
    textured = (kind != 0.0) & (kind != 3.0)
    wall = (kind == 2.0) | (kind == 4.0)
    return textured, wall, textured & ~wall


@torch.no_grad()
def portal_bytes(args, kw):
    """The bytes B2 must move on these inputs, in either table mode (its
    bound's): both outputs; of the records, per env and column, the span
    bounds (channels 0-1) of every record up to the one where the
    column's last row finds its winner (all R where a row finds none), the
    alpha flag (channel 13) of each masked-family record among them that
    covers a row still open, and where that flag is set one word and the
    alpha test's other channels (15, and 5 and 8-12 unless the record wins
    in the column); once per column, the channels each winner's kind uses
    (the kind alone for kind 0 and the sky, 6 for a flat, 11 for a wall);
    the camera and shear; dxz of each column with a flat pixel, the sky
    image at sky pixels, and each distinct table entry read. The plain
    walk on the records with channel 2 set to each record's position + 1
    gives the winners."""
    from tpu_doom_torch._numerics import f32
    from tpu_doom_torch.ops.raster import (
        MASKED_FAMILY,
        RECORDS_PER_CROSSING,
        _classify,
        _global_texel,
        _ndc_rows,
        _shade_address,
    )

    records, words, cam, hc, dxz, _, tex, hole_bytes, _, H, p11, n_rows = args
    shear = kw["shear"]
    B, R, _, W = records.shape
    dev = records.device
    y, ndc0 = _ndc_rows(H, dev)
    ndc_y = ndc0 + shear[:, None, None]
    cam_x, cam_y, cam_z = (cam[:, i, None, None] for i in range(3))
    marked = records.clone()
    marked[:, :, 2] = torch.arange(1, R + 1, dtype=torch.float32, device=dev)[None, :, None]
    win = _classify(marked, words, cam_y, hc, ndc_y, y, f32(p11), False)[:, 0].long() - 1
    del marked
    ch = _classify(records, words, cam_y, hc, ndc_y, y, f32(p11), False)
    n = 2 * win.numel() * 4 + nbytes(cam, shear)
    open_ = win < 0
    n += 8 * int((torch.where(open_, R - 1, win).amax(1) + 1).sum())
    for r in range(MASKED_FAMILY, R, RECORDS_PER_CROSSING):
        rec = records[:, r]
        covers = (y >= rec[:, None, 0]) & (y < rec[:, None, 1])
        tested = (covers & (open_ | (win >= r))).any(1)
        flagged = tested & (rec[:, 13] > 0.5)
        n += (4 * int(tested.sum()) + 8 * int(flagged.sum())
              + 24 * int((flagged & ~(win == r).any(1)).sum()))
    kind = ch[:, 0]
    textured, wall, flat = _kinds(kind)
    used = torch.where(wall, 11, torch.where(textured, 6, 1))
    column = torch.arange(B * W, device=dev).view(B, 1, W)
    winners = torch.unique(((column * R + win) * 16 + used)[~open_])
    n += 4 * int((winners % 16).sum())
    n += 8 * int(flat.any(1).sum()) + 4 * int((kind == 3.0).sum())
    S1 = tex.shape[-2]
    lin, crow, _, _ = _shade_address(ch, ndc_y, dxz[:, 0, None, :], dxz[:, 1, None, :],
                                     cam_x, cam_y, cam_z, f32(p11), n_rows, S1)
    if tex.dim() == 3:
        v = torch.gather(tex.reshape(B, -1).to(torch.int32), 1,
                         lin.long().reshape(B, -1)).reshape(lin.shape)
        hole, v1 = v == 256, v.clamp_max(255)
        key = lin.long() + torch.arange(B, device=dev).view(B, 1, 1) * (S1 * 128)
    else:
        v1, hole = _global_texel(tex, hole_bytes, lin)
        key = lin
    return n + _table_bytes(key, lin, crow, v1, hole, textured, tex, hole_bytes)


@torch.no_grad()
def shade_bytes(ch, sargs, shear):
    """The bytes B8 must move on these inputs (its bound's): both outputs;
    each pixel's kind and the other channels its kind uses (5 for a flat,
    10 for a wall); dxz at flat pixels and the sky image at sky pixels;
    ndc_y, the camera and shear; and each distinct table entry read."""
    from tpu_doom_torch._numerics import f32
    from tpu_doom_torch.ops.raster import _global_texel, _shade_address

    dxz, ndc_y, _, cam, tex, hole_bytes, _, p11, n_rows = sargs
    kind = ch[:, 0]
    textured, wall, flat = _kinds(kind)
    n = 3 * kind.numel() * 4 + nbytes(ndc_y, cam, shear)
    n += 40 * int(wall.sum()) + 28 * int(flat.sum()) + 4 * int((kind == 3.0).sum())
    lin, crow, _, _ = _shade_address(
        ch, ndc_y + shear[:, None], dxz[:, 0], dxz[:, 1], cam[:, 0, None],
        cam[:, 1, None], cam[:, 2, None], f32(p11), n_rows, tex.shape[0])
    v1, hole = _global_texel(tex, hole_bytes, lin)
    return n + _table_bytes(lin, lin, crow, v1, hole, textured, tex, hole_bytes)


def tool_wrappers():
    from tpu_doom_torch.tools.kernelbudget import render_portal_ablated
    from tpu_doom_torch.tools.onehotbench import lookup

    return {"onehot_lookup": lookup, "render_portal_ablated": render_portal_ablated}


def reset_counts():
    """Set every kernel's launch count to 0, the tools' included."""
    from tpu_doom_torch.ops import reset_launch_counts

    reset_launch_counts()
    for fn in tool_wrappers().values():
        fn.launches = 0


def read_counts():
    """Launches per kernel since `reset_counts`, the tools' included."""
    from tpu_doom_torch.ops import launch_counts

    return {**launch_counts(), **{k: fn.launches for k, fn in tool_wrappers().items()}}


def max_abs_err(a, b):
    """Max |a - b| over entries finite in both; inf where the non-finite
    pattern differs."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or not torch.equal(
            a[~fin], b[~fin]):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def phase_device():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")
    return card


def phase_build():
    from tpu_doom_torch import _build

    path, secs = _build.build()
    _build.load()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} -> {path} in {secs:.2f} s")
    for line in _build.ptxas_usage(path):
        print(f"[build] ptxas {line}")


def phase_player_move(results, suffix, label, scene, cfg, state):
    """B1 on the rows the step gives it for `state` of `scene` (the broad
    phase's triangles per env), bitwise against its plain version, timed
    beside its bound: the sweeps these inputs need (`player_move_sweeps`)
    times M triangles times SWEEP_TRI_OPS, or the bytes, the larger."""
    from tpu_doom_torch.ops import player_move, player_move_ref
    from tpu_doom_torch.sim.collision import broadphase_rows

    pcfg = cfg.player
    rows = broadphase_rows(scene, state.object_offset, state.pos)
    st8 = torch.cat([state.pos, state.vel, torch.zeros_like(state.pos[:, :2])], 1)
    kw = dict(radius=pcfg.radius, height=pcfg.height, dt=cfg.timestep,
              substeps=pcfg.clip_substeps, enable_noclip=pcfg.enable_noclip)
    got = player_move(rows, st8, **kw)
    want = player_move_ref(rows, st8, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    same = bitwise_equal(got, want)
    ms, b2b = kernel_ms(lambda: player_move(rows, st8, **kw))
    plain = time_ms(lambda: player_move_ref(rows, st8, **kw))
    print(f"[kernel] B1 player_move {label} rows {tuple(rows.shape)}: bitwise equal"
          f" {same}, max_abs_err {err} (ceiling 0); {ms:.4f} ms ({b2b:.4f} back to back)"
          f" vs plain {plain:.4f} ms")
    require(same, f"B1 disagrees with its plain version on {label}: {err}")
    sweeps = player_move_sweeps(rows, st8, pcfg.radius, cfg.timestep,
                                pcfg.clip_substeps, pcfg.enable_noclip)
    most = rows.shape[0] * (pcfg.clip_substeps + 1 + int(pcfg.enable_noclip))
    b1_bytes = nbytes(rows, st8, got)
    print(f"[bound] B1 player_move {label}: {sweeps} sweeps these inputs need (of"
          f" {most} without the early exit) x M = {rows.shape[2]} triangles x"
          f" {SWEEP_TRI_OPS} operations = {sweeps * rows.shape[2] * SWEEP_TRI_OPS}"
          f" operations, beside {b1_bytes} bytes")
    record(results, "player_move" + suffix, err, ms, b2b, plain, b1_bytes,
           sweeps * rows.shape[2] * SWEEP_TRI_OPS)


def phase_portal(results, suffix, label, sim, state, width, height):
    """B2 on the port's own walk of `state` of `sim` at width x height, at
    0 px against its plain version, timed beside its bound -> its idx."""
    from tpu_doom_torch.ops import render_portal_fused, render_portal_fused_ref
    from tpu_doom_torch.render import portal as P

    args, kw, _ = P.fused_inputs(sim.portal_scene(), sim.scene, sim.config,
                                 width, height, state)
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc, wc))
    ms, b2b = kernel_ms(lambda: render_portal_fused(*args, **kw))
    plain = time_ms(lambda: render_portal_fused_ref(*args, **kw))
    print(f"[kernel] B2 render_portal_fused {label} records {tuple(args[0].shape)}: "
          f"{mism} mismatched idx/cov px (ceiling 0), max_abs_err {err};"
          f" {ms:.4f} ms ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(mism == 0, f"B2 disagrees with its plain version on {label} on {mism} px")
    record(results, "render_portal_fused" + suffix, err, ms, b2b, plain,
           portal_bytes(args, kw), gi.numel() * SHADE_PIXEL_OPS)
    return gi


def phase_kernels(results):
    sim = make_sim()
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    for _ in range(WARMUP_TICKS):
        state = sim.step(state, acts)

    # B1 at 256 envs, clip_substeps=4.
    phase_player_move(results, "", f"rows of :test:'s {B_MAIN} envs", sim.scene,
                      sim.config, state)

    # B2 on the port's own walk output, 256 envs at 320x200.
    gi = phase_portal(results, "", ":test:", sim, state, W_MAIN, H_MAIN)
    phase_kernels_oracle(results, state, gi)
    del gi

    # B3 and B9 on the 8 verify poses at 320x200, 3 layers.
    ref = verify_ref()
    vsim = make_sim(batch_size=8, portal_crossings=12, raster_backend="auto")
    phase_peel(results, "", "the 8 verify poses", vsim.scene, vsim.config,
               verify_state(vsim, ref))


def peel_pairs(rows, grid, ybounds=None, tile_p=None, chunk_t=None):
    """The (pixel, triangle) pairs where the triangle covers the pixel
    (`_peel_cover`), summed over envs: the coverage tests any exact peel of
    these inputs must make, whatever its number of layers (B3's and B9's
    bounds count PEEL_TEST_OPS for each); with ybounds, only the pairs
    B3's window-y cull admits."""
    from tpu_doom_torch.ops.raster import _chunk_ybounds, _peel_cover, _tile_ybounds

    B, T, _ = rows.shape
    P, dev = grid.shape[1], grid.device
    px, py = grid[0][None], grid[1][None]
    if ybounds is not None:
        cb = _chunk_ybounds(ybounds, chunk_t)[:, torch.arange(T, device=dev) // chunk_t]
        tb = _tile_ybounds(grid, tile_p)[torch.arange(P, device=dev) // tile_p]
    n = 0
    for b in range(B):
        cover, _ = _peel_cover(rows[b], px, py)
        if ybounds is not None:
            cover &= (cb[b, :, 0, None] <= tb[:, 1]) & (cb[b, :, 1, None] >= tb[:, 0])
        n += int(cover.sum())
    return n


def peel_tile_tests(rows, grid, width):
    """The coverage tests B3 and B9 make after their cull: per 32 x 8 tile,
    the rows `_peel_may_cover` keeps times the tile's pixels, summed over
    tiles and envs (B3's chunk y-cull may drop more)."""
    from tpu_doom_torch.ops.raster import _peel_may_cover, _peel_tile_boxes

    tile, boxes = _peel_tile_boxes(grid, width)
    pixels = torch.bincount(tile, minlength=boxes.shape[0]).to(torch.float64)
    return int(sum(float(_peel_may_cover(r, boxes).sum(0).to(torch.float64) @ pixels)
                   for r in rows))


def phase_peel(results, suffix, label, scene, cfg, state, plain_envs=None,
               width=W_MAIN, height=H_MAIN, b9=True):
    """B3 and B9 (B3 alone with b9=False) on the triangle path's inputs
    for `state` of `scene` at width x height, each against its plain
    version (where plain_envs is given, on the first plain_envs envs, the
    plain version timed once), timed beside its bound: the bytes of its
    inputs and output, or PEEL_TEST_OPS per covering (pixel, triangle)
    pair (`peel_pairs`), whichever takes longer."""
    from tpu_doom_torch.ops import (
        depth_peel,
        depth_peel_ref,
        pack_triangle_rows,
        peel_resolve,
        peel_resolve_ref,
    )
    from tpu_doom_torch.render import raster as R

    K = cfg.depth_layers
    trows, tattrs, grid, yb, _ = R.peel_inputs(scene, cfg, width, height, state)
    pk = dict(tile_p=cfg.raster_tile_p, chunk_t=cfg.raster_chunk_t)
    n = plain_envs or trows.shape[0]
    plain_calls = dict(calls=1, warmup=0) if plain_envs else {}
    slice_ = f" (plain version on envs 0-{n - 1}, one timed call)" if plain_envs else ""

    def b3():
        return peel_resolve(trows, tattrs, grid, yb, K, **pk, width=width)

    def b3_plain():
        return peel_resolve_ref(trows[:n], tattrs[:n], grid, yb[:n], K, **pk)

    got, want = b3(), b3_plain()
    torch.cuda.synchronize()
    sub = got[:n]
    cat_ok = all(torch.equal(sub[:, :, c], want[:, :, c]) for c in (11, 12, 13))
    fl = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    g, w = sub[:, :, fl].double(), want[:, :, fl].double()
    fin = torch.isfinite(w)
    fin_ok = torch.equal(torch.isfinite(g), fin) and torch.equal(g[~fin], w[~fin])
    rel = float(((g - w).abs() / w.abs().clamp_min(1e-30))[fin].max())
    err = max_abs_err(sub, want)
    del sub, want, g, w, fin
    ms, b2b = kernel_ms(b3)
    plain = time_ms(b3_plain, **plain_calls)
    pairs = peel_pairs(trows, grid, yb, **pk)
    print(f"[kernel] B3 peel_resolve {label} rows {tuple(trows.shape)} P={grid.shape[1]}"
          f" K={K}{slice_}: has/pass/transparent equal {cat_ok}, float max rel err"
          f" {rel} (ceiling {B3_REL_TOL}), max_abs_err {err}; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms; {pairs} covering"
          f" (pixel, triangle) pairs, {peel_tile_tests(trows, grid, width)} tests after"
          " the cull")
    require(cat_ok and fin_ok and rel <= B3_REL_TOL,
            f"B3 disagrees with its plain version on {label}")
    record(results, "peel_resolve" + suffix, err, ms, b2b, plain,
           nbytes(trows, tattrs, grid, yb, got), pairs * PEEL_TEST_OPS)
    b3z = got[:, :, 0].clone()
    del got
    if not b9:
        return

    # B9 on the same states: the "jnp" path's unsorted 16-column rows.
    prep = R.prepare(scene, cfg, width, height, state)
    rows16 = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    del prep

    def b9():
        return depth_peel(rows16, grid, K, width=width)

    def b9_plain():
        return depth_peel_ref(rows16[:n], grid, K)

    (z, ids), (zr, idr) = b9(), b9_plain()
    torch.cuda.synchronize()
    same = torch.equal(ids[:n], idr) and bitwise_equal(z[:n], zr)
    err = max_abs_err(z[:n], zr)
    ms, b2b = kernel_ms(b9)
    plain = time_ms(b9_plain, **plain_calls)
    pairs = peel_pairs(rows16, grid)
    # For the record: B9's z against B3's channel 0 (the same winners: B3's
    # y-sorted rows carry the draw-order ids B9 has as positions).
    print(f"[kernel] B9 depth_peel {label} rows {tuple(rows16.shape)} P={grid.shape[1]}"
          f" K={K}{slice_}: ids equal and z bitwise {same} (ceiling 0), max_abs_err"
          f" {err}; z vs B3's channel 0 max_abs_err {max_abs_err(z, b3z)}; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms; {pairs} covering"
          f" (pixel, triangle) pairs, {peel_tile_tests(rows16, grid, width)} tests after"
          " the cull")
    require(same, f"B9 disagrees with its plain version on {label}")
    record(results, "depth_peel" + suffix, err, ms, b2b, plain,
           nbytes(rows16, grid, z, ids), pairs * PEEL_TEST_OPS)


def phase_kernels_maze(results):
    """B3 and B9 at the maze shape: the 128 pitched envs of fallback_sim
    on :texstress: at reset, which the fallback renders through the
    triangle path; the plain versions on a 16-env slice."""
    sim, state, _ = fallback_sim(wad_file=TEX_WAD)
    pitched = type(state)(*(x[: B_MAIN // 2] for x in state))
    require(bool((pitched.pitch.abs() > 0.0).all()), "the maze envs are not pitched")
    phase_peel(results, "_maze", f"{TEX_WAD} {B_MAIN // 2} pitched envs", sim.scene,
               sim.config, pitched, plain_envs=MAZE_PLAIN_ENVS)


def entry_walk_actions(acts):
    """Seeded walking, turning and pushing actions for entry()'s 2 envs
    (tests/test_torch_cli.py's (e)), on the device of `acts`."""
    rng = np.random.default_rng(5)
    dev = acts.movement.device
    return acts._replace(
        movement=torch.as_tensor(rng.uniform(-1, 1, (2, 2)).astype(np.float32), device=dev),
        look=torch.as_tensor(rng.uniform(-0.05, 0.05, (2, 2)).astype(np.float32), device=dev),
        push=torch.tensor([True, False], device=dev))


def phase_kernels_entry(results):
    """The entry points' shapes (phase 7's): B1 and B2 on entry()'s 2 envs
    at 64x40 after ENTRY_REPLAYS walking ticks, and B3 on the CLI's one
    env under its default backend ("auto") after its dump-frames pilot's
    CLI_DUMP_TICKS ticks, each against its plain version."""
    from tpu_doom_torch import cli
    from tpu_doom_torch.entry import entry, entry_sim

    sim = entry_sim()
    fn, (state, acts) = entry()
    acts = entry_walk_actions(acts)
    with torch.no_grad():
        for _ in range(ENTRY_REPLAYS):
            state, _ = fn(state, acts)
    label = f"entry()'s 2 envs at {ENTRY_W}x{ENTRY_H}"
    phase_player_move(results, "_entry", label, sim.scene, sim.config, state)
    phase_portal(results, "_entry", label, sim, state, ENTRY_W, ENTRY_H)

    csim = cli.make_sim(cli.build_parser().parse_args(
        ["--iwad", ":test:", "-r", f"{ENTRY_W}x{ENTRY_H}"]))
    state = csim.reset(1)
    with torch.no_grad():
        for t in range(CLI_DUMP_TICKS):
            state = csim.step(state, cli.scripted_actions(csim, state, t))
    phase_peel(results, "_entry", f"the CLI's env at {ENTRY_W}x{ENTRY_H} (auto)",
               csim.scene, csim.config, state, width=ENTRY_W, height=ENTRY_H, b9=False)


def phase_kernels_oracle(results, state, b2_idx=None, suffix="", label=":test:",
                         scenes=None, width=W_MAIN, height=H_MAIN):
    """B7 then B8 (the `portal_jnp` configuration) on the port's own walk
    of `state`, each bitwise against its plain version: on :test: at 256
    envs x 320x200 from B2's state, where the chain against B2's frame
    `b2_idx` is printed for the record (the same function at zero pitch),
    or on `scenes`, a (portal scene, scene, config) triple, at width x
    height."""
    from tpu_doom_torch.ops import (
        classify_alpha,
        classify_alpha_ref,
        shade_portal,
        shade_portal_ref,
    )
    from tpu_doom_torch.render import portal as P

    if scenes is None:
        sim = make_sim(raster_backend="portal_jnp")
        scenes = (sim.portal_scene(), sim.scene, sim.config)
    cargs, sargs, shear, _ = P.oracle_inputs(*scenes, width, height, state)
    ch = classify_alpha(*cargs, shear=shear)
    want = classify_alpha_ref(*cargs, shear=shear)
    torch.cuda.synchronize()
    same = bitwise_equal(ch, want)
    err = max_abs_err(ch, want)
    del want
    ms, b2b = kernel_ms(lambda: classify_alpha(*cargs, shear=shear))
    plain = time_ms(lambda: classify_alpha_ref(*cargs, shear=shear))
    print(f"[kernel] B7 classify_alpha {label} records {tuple(cargs[0].shape)} ->"
          f" {tuple(ch.shape)}: bitwise equal {same} (ceiling 0), max_abs_err"
          f" {err}; {ms:.4f} ms ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(same, f"B7 disagrees with its plain version on {label}")
    record(results, "classify_alpha" + suffix, err, ms, b2b, plain,
           nbytes(*cargs[:3], shear, ch))

    B = ch.shape[0]
    ch = ch.reshape(B, 11, -1)
    del cargs
    gi, gc = shade_portal(ch, *sargs, shear=shear)
    wi, wc = shade_portal_ref(ch, *sargs, shear=shear)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc, wc))
    del wi, wc
    ms, b2b = kernel_ms(lambda: shade_portal(ch, *sargs, shear=shear))
    plain = time_ms(lambda: shade_portal_ref(ch, *sargs, shear=shear))
    chain = ("" if b2_idx is None else "; the chain B7 -> B8 differs from B2 on"
             f" {int((gi.reshape(b2_idx.shape) != b2_idx).sum())} px of this zero-pitch"
             " state")
    print(f"[kernel] B8 shade_portal {label} ch {tuple(ch.shape)} table"
          f" {tuple(sargs[4].shape)} hole {tuple(sargs[5].shape)}: {mism}"
          f" mismatched idx/cov px (ceiling 0), max_abs_err {err}; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms{chain}")
    require(mism == 0, f"B8 disagrees with its plain version on {label} on {mism} px")
    record(results, "shade_portal" + suffix, err, ms, b2b, plain,
           shade_bytes(ch, sargs, shear), gi.numel() * SHADE_PIXEL_OPS)


@contextlib.contextmanager
def captured(module, name):
    """Record the arguments of every call to `module.name` (a kernel
    wrapper the walk calls) while the block runs."""
    orig, calls = getattr(module, name), []

    def spy(*args):
        calls.append(args)
        return orig(*args)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def bitwise_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def texstress_state():
    """The :texstress: main-path state: 256 envs after 8 bench ticks."""
    sim = make_sim(wad_file=TEX_WAD)
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    for _ in range(WARMUP_TICKS):
        state = sim.step(state, acts)
    return state


def phase_kernels_texstress(results):
    """B4, B6, B5 and B2's per-env mode on the inputs the port's own walk
    gives them on :texstress: x 256 envs at 320x200, bitwise against
    their plain versions."""
    from tpu_doom_torch.ops import (
        gather_cells,
        gather_cells_ref,
        render_portal_fused,
        render_portal_fused_ref,
        scatter_live,
        scatter_live_ref,
        select_rows,
        select_rows_ref,
    )
    from tpu_doom_torch.render import portal as P

    state = texstress_state()
    sim = make_sim(wad_file=TEX_WAD)
    from tpu_doom_torch.ops import player_move, player_move_ref
    from tpu_doom_torch.sim.collision import broadphase_rows

    rows = broadphase_rows(sim.scene, state.object_offset, state.pos)
    st8 = torch.cat([state.pos, state.vel, torch.zeros_like(state.pos[:, :2])], 1)
    pcfg = sim.config.player
    kw = dict(radius=pcfg.radius, height=pcfg.height, dt=sim.config.timestep,
              substeps=pcfg.clip_substeps, enable_noclip=pcfg.enable_noclip)
    same = bitwise_equal(player_move(rows, st8, **kw), player_move_ref(rows, st8, **kw))
    runs = clip_substeps_run(rows, st8, pcfg.radius, sim.config.timestep,
                             pcfg.clip_substeps)
    print(f"[kernel] B1 player_move {TEX_WAD} rows {tuple(rows.shape)}: M ="
          f" {rows.shape[2]}, bitwise equal {same} (ceiling 0); clip substeps run per"
          f" env: {torch.bincount(runs, minlength=pcfg.clip_substeps + 1).tolist()}"
          " envs at 0, 1, ... substeps")
    require(same, f"B1 on {TEX_WAD} disagrees with its plain version")
    del rows, st8
    with captured(P, "select_rows") as calls:
        args, kw, _ = P.fused_inputs(sim.portal_scene(), sim.scene, sim.config,
                                     W_MAIN, H_MAIN, state)
    require(len(calls) == 1, f"the :texstress: walk called B4 {len(calls)} times, not once")
    idx, tab = calls[0]
    got, want = select_rows(idx, tab), select_rows_ref(idx, tab)
    torch.cuda.synchronize()
    same = bitwise_equal(got, want)
    err = max_abs_err(got, want)
    ms, b2b = kernel_ms(lambda: select_rows(idx, tab))
    plain = time_ms(lambda: select_rows_ref(idx, tab))
    print(f"[kernel] B4 select_rows idx {tuple(idx.shape)} table {tuple(tab.shape)}"
          f" -> {tuple(got.shape)}: bitwise equal {same} (ceiling 0), max_abs_err"
          f" {err}; {ms:.4f} ms ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(same, "B4 disagrees with its plain version")
    C = tab.shape[2]
    lib = time_ms(lambda: torch.gather(
        tab.transpose(1, 2), 2, idx.long()[:, None, :].expand(-1, C, -1)))
    record(results, "select_rows", err, ms, b2b, plain, nbytes(idx, tab, got),
           library_ms=lib)
    del calls, idx, tab, got, want

    require(args[6].dim() == 2, "B2 is not in its global-table mode at shipped defaults")
    gi, gc_ = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc_ != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc_, wc))
    ms, b2b = kernel_ms(lambda: render_portal_fused(*args, **kw))
    plain = time_ms(lambda: render_portal_fused_ref(*args, **kw))
    print(f"[kernel] B2 render_portal_fused {TEX_WAD} global table"
          f" {tuple(args[6].shape)} records {tuple(args[0].shape)}: {mism} mismatched"
          f" idx/cov px (ceiling 0), max_abs_err {err}; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(mism == 0, f"B2 on {TEX_WAD} disagrees with its plain version on {mism} px")
    record(results, "render_portal_fused_texstress", err, ms, b2b, plain,
           portal_bytes(args, kw), gi.numel() * SHADE_PIXEL_OPS)
    del args, kw, gi, gc_, wi, wc, sim

    sim = make_sim(wad_file=TEX_WAD, portal_global_segs_max=TEX_CAP)
    require(P.active_segs(sim.portal_scene(), sim.config) > 0,
            "the active-set path is not engaged at the lowered cap")
    with captured(P, "scatter_live") as sl, captured(P, "gather_cells") as gc:
        args, kw, overflow = P.fused_inputs(
            sim.portal_scene(), sim.scene, sim.config, W_MAIN, H_MAIN, state)
    require(len(sl) == 1 and len(gc) == 1, "the active-set walk skipped B6 or B5")
    sidx, live, n_rows = sl[0]
    got, want = scatter_live(sidx, live, n_rows), scatter_live_ref(sidx, live, n_rows)
    torch.cuda.synchronize()
    same = bitwise_equal(got, want)
    err = max_abs_err(got, want)
    ms, b2b = kernel_ms(lambda: scatter_live(sidx, live, n_rows))
    plain = time_ms(lambda: scatter_live_ref(sidx, live, n_rows))
    print(f"[kernel] B6 scatter_live idx {tuple(sidx.shape)} -> ({sidx.shape[0]},"
          f" {n_rows}): bitwise equal {same} (ceiling 0), max_abs_err {err},"
          f" {int(want.sum())} live crossings; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(same, "B6 disagrees with its plain version")
    ok = (sidx >= 0) & (sidx < n_rows)
    sl_idx, sl_live = torch.where(ok, sidx, 0).long(), torch.where(ok, live, 0.0)
    zeros = torch.zeros((sidx.shape[0], n_rows), dtype=torch.float32, device=sidx.device)
    lib, lib_b2b = kernel_ms(lambda: torch.scatter_add(zeros, 1, sl_idx, sl_live))
    graph_b2b = graph_ms(lambda: scatter_live(sidx, live, n_rows))
    lib_graph = graph_ms(lambda: torch.scatter_add(zeros, 1, sl_idx, sl_live))
    print(f"[kernel] B6 back to back inside a CUDA graph (device time, no wrapper):"
          f" {graph_b2b:.4f} ms; torch.scatter_add {lib_graph:.4f} ms")
    record(results, "scatter_live", err, ms, b2b, plain, nbytes(sidx, live, got),
           library_ms=lib, library_ms_b2b=lib_b2b)

    meta, tex_full, act = gc[0]
    got, want = gather_cells(meta, tex_full, act), gather_cells_ref(meta, tex_full, act)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = max_abs_err(got, want)
    ms, b2b = kernel_ms(lambda: gather_cells(meta, tex_full, act))
    plain = time_ms(lambda: gather_cells_ref(meta, tex_full, act))
    print(f"[kernel] B5 gather_cells meta {tuple(meta.shape)} table"
          f" {tuple(tex_full.shape)} -> {tuple(got.shape)}: equal {same} (ceiling 0),"
          f" max_abs_err {err}, {int(meta[..., 2].sum()) * 8} rows copied,"
          f" {int(overflow.sum())} envs over the active budget; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(same, "B5 disagrees with its plain version")
    copied = int(meta[..., 2].sum()) * 8 * 128 * tex_full.element_size()
    record(results, "gather_cells", err, ms, b2b, plain, nbytes(meta, got) + copied)
    del sl, gc, sidx, live, meta, tex_full, got, want

    require(args[6].dim() == 3, "B2 is not in its per-env mode on the active set")
    gi, gc_ = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc_ != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc_, wc))
    ms, b2b = kernel_ms(lambda: render_portal_fused(*args, **kw))
    plain = time_ms(lambda: render_portal_fused_ref(*args, **kw))
    print(f"[kernel] B2 render_portal_fused per-env tables {tuple(args[6].shape)}"
          f" records {tuple(args[0].shape)}: {mism} mismatched idx/cov px"
          f" (ceiling 0), max_abs_err {err}; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(mism == 0, f"B2 per-env disagrees with its plain version on {mism} px")
    record(results, "render_portal_fused_per_env", err, ms, b2b, plain,
           portal_bytes(args, kw), gi.numel() * SHADE_PIXEL_OPS)


def phase_tools(results):
    """Phase 4: B10 and B11, the instruments' kernels, against their plain
    versions on the card, timed."""
    from tpu_doom_torch.ops import render_portal_fused
    from tpu_doom_torch.tools import kernelbudget as KB
    from tpu_doom_torch.tools import onehotbench as OH

    # B10 at the TPU tool's defaults (3.1 M lookups per call: bound 0.3 us,
    # so launch-bound), at a ragged n (the kernel's scalar path for the
    # last quad and for rows that are not 16-byte aligned), then at the main
    # path's volume (one lookup per pixel of a 256-env frame), which is what
    # the table record keeps, beside torch.take timed the same two ways.
    for label, (S, n, iters, grid) in (
            ("the TPU tool's defaults (launch-bound)", (534, 3072, 16, 64)),
            ("a ragged n", (534, 3073, 16, 64)),
            ("the main path's volume", (534, B_MAIN * W_MAIN * H_MAIN, 1, 1))):
        idx, tab = OH.make_inputs(S, n, "cuda")
        ms, b2b = {}, {}
        for v in OH.VARIANTS:
            got = OH.lookup(idx, tab, iters, grid, v)
            want = OH.lookup_ref(idx, tab, iters, grid, v)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            del got, want
            print(f"[tool] B10 onehot_lookup {v} S={S} n={n} iters={iters} grid={grid}:"
                  f" equal to its plain version {same} (ceiling 0)")
            require(same, f"B10 {v} disagrees with its plain version")
            ms[v], b2b[v] = kernel_ms(lambda v=v: OH.lookup(idx, tab, iters, grid, v))
        plain = time_ms(lambda: OH.lookup_ref(idx, tab, iters, grid))
        # One add per lookup; the bytes are idx and the table read once and
        # the (grid, n) int32 output written once.
        n_bytes, ops = nbytes(idx, tab) + grid * n * 4, grid * iters * n
        # The library yardstick: torch.take, which computes the same function
        # at iters = 1 (idx < S * 128); it takes int64 indices, made untimed.
        idx64 = idx.long()
        lib, lib_b2b = (kernel_ms(lambda: torch.take(tab.view(-1), idx64))
                        if iters == 1 else (None, None))
        times = ", ".join(f"{v} {ms[v]:.4f} ms ({b2b[v]:.4f} back to back,"
                          f" {b2b[v] * 1e6 / (iters * grid * n):.6f} ns per element"
                          " lookup)" for v in OH.VARIANTS)
        take = ("none at iters > 1" if lib is None
                else f"{lib:.4f} ms ({lib_b2b:.4f} back to back)")
        print(f"[tool] B10 at {label}: {times}; plain {plain:.4f} ms; one"
              f" torch.take: {take}")
        if iters == 1:
            record(results, "onehot_lookup", 0.0, ms["ldg"], b2b["ldg"], plain, n_bytes,
                   ops, library_ms=lib, library_ms_b2b=lib_b2b)
        else:
            b = bound(n_bytes, ops)
            print(f"[bound] B10 at {label}: {n_bytes / 1e6:.3f} MB -> bound"
                  f" {b['bound_ms']:.6f} ms by {b['bound_by']}")
        del idx, idx64, tab

    # B11 on the TPU tool's inputs.
    args, kw = KB.budget_inputs(B_MAIN, W_MAIN, H_MAIN, "cuda")
    pi, pc = render_portal_fused(*args, **kw)
    b2b = BACK_TO_BACK
    ms = {"prod": time_ms(lambda: render_portal_fused(*args, **kw), per_pair=b2b)}
    plain, err = {}, {}
    for name, stages in KB.ABLATIONS.items():
        gi, gc = KB.render_portal_ablated(*args, **kw, ablate=stages)
        wi, wc = KB.render_portal_ablated_ref(*args, **kw, ablate=stages)
        torch.cuda.synchronize()
        mism = int((gi != wi).sum()) + int((gc != wc).sum())
        err[name] = max(max_abs_err(gi, wi), max_abs_err(gc, wc))
        same_b2 = bitwise_equal(gi, pi) and bitwise_equal(gc, pc)
        ms[name] = time_ms(lambda s=stages: KB.render_portal_ablated(*args, **kw, ablate=s),
                           per_pair=b2b)
        plain[name] = time_ms(lambda s=stages: KB.render_portal_ablated_ref(
            *args, **kw, ablate=s), calls=3)
        print(f"[tool] B11 render_portal_ablated {name} records {tuple(args[0].shape)}:"
              f" {mism} mismatched idx/cov px (ceiling 0), max_abs_err {err[name]};"
              f" bitwise equal to B2 {same_b2}; {ms[name]:.4f} ms (median of"
              f" {TIMING_CALLS} runs of {b2b} back to back) vs plain {plain[name]:.4f}"
              " ms (median of 3)")
        require(mism == 0, f"B11 {name} disagrees with its plain version on {mism} px")
        require(same_b2 or name != "full", "B11 full is not bitwise B2's production output")
    print(f"[tool] B11 stage budget, :test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs: prod"
          f" {ms['prod']:.4f} ms, full {ms['full']:.4f} ms; share (full - variant) / full: "
          + ", ".join(f"{n} {(ms['full'] - ms[n]) / ms['full']:+.4f}"
                      for n in KB.ABLATIONS if n != "full")
          + "; no_flatten: not applicable on this card")
    single = time_ms(lambda: KB.render_portal_ablated(*args, **kw))
    record(results, "render_portal_ablated", err["full"], single, ms["full"], plain["full"],
           portal_bytes(args, kw), pi.numel() * SHADE_PIXEL_OPS)


GOLDEN_SCENARIOS = {
    # tests/golden/regen.py:22-36: pos, yaw, pitch, time, door offset.
    "start": (None, None, None, None, 0.0),
    "big_room": ([-2.2, 0.2, -8.8], 0.9, 0.3, 1.25, 0.0),
    "door_half_open": ([-2.56, 0.33, -5.4], None, None, None, 0.5),
    "grate": ([-3.5, 1.0, -9.0], None, None, 0.4, 0.0),
}


def phase_goldens():
    with np.load("tests/golden/frames.npz") as z:
        golden = {k: z[k] for k in z.files}
    # frames.npz was made by the JAX package's "jnp" configuration
    # (tests/golden/regen.py:43): the port's B3 path and its "jnp" path.
    for backend, label in (("auto", "triangle path"), ("jnp", "jnp path (B9)")):
        phase_golden_frames(golden, make_sim(batch_size=1, raster_backend=backend),
                            label)

    ref = verify_ref()
    for backend in ("portal", "portal_jnp"):
        vsim = make_sim(batch_size=8, portal_crossings=12, raster_backend=backend)
        idx, cov = vsim.render(verify_state(vsim, ref))
        idx, cov = idx.cpu().numpy(), cov.cpu().numpy()
        for i in range(idx.shape[0]):
            n = int((idx[i] != ref["idx"][i]).sum())
            nc = int((cov[i] != ref["cov"][i]).sum())
            print(f"[golden] {backend} verify pose {i} 320x200: {n} px, {nc} cov"
                  f" differ from JAX portal_jnp (ceiling {PX_CEILING})")
            require(n <= PX_CEILING and nc <= PX_CEILING,
                    f"{backend} verify pose {i} failed")
        del vsim

    # :texstress: (the big-level walk), 8 states, both texel-table paths
    # and the portal_jnp configuration (B7, B8 on the dense global table).
    # The ceiling is summed over the 8 envs (bench.py:144-145). `idx` was
    # rendered stage by stage; `idx_fused` by the JAX package's one
    # compiled program, which differs from it on this level (see
    # tests/golden/regen_torch_ref.py) and is printed for the record.
    from tpu_doom_torch.sim.state import SimState

    with np.load("tests/golden/verify_texstress_ref.npz") as z:
        tref = {k: z[k] for k in z.files}
    jax_own = int((tref["idx_fused"] != tref["idx"]).sum())
    for name, extra in (("shipped defaults", {}),
                        (f"portal_global_segs_max={TEX_CAP}",
                         dict(portal_global_segs_max=TEX_CAP)),
                        ("portal_jnp", dict(raster_backend="portal_jnp"))):
        tsim = make_sim(wad_file=TEX_WAD, batch_size=8, **extra)
        st = SimState(*(torch.as_tensor(tref[k], device=tsim.device)
                        for k in SimState._fields))
        idx, cov = (x.cpu().numpy() for x in tsim.render(st))
        n = (idx != tref["idx"]).sum(axis=(1, 2))
        nc = (cov != tref["cov"]).sum(axis=(1, 2))
        nf = int((idx != tref["idx_fused"]).sum())
        print(f"[golden] :texstress: {name}, 8 states 320x200: {int(n.sum())} px"
              f" (per env {n.tolist()}), {int(nc.sum())} cov differ from JAX"
              f" portal_jnp, summed (ceiling {PX_CEILING}); {nf} px from the JAX"
              f" one-program render, which differs from portal_jnp by {jax_own}")
        require(n.sum() <= PX_CEILING and nc.sum() <= PX_CEILING,
                f":texstress: reference frames failed ({name})")


def phase_goldens_hires():
    """The port above 320x200 against the JAX package's portal_jnp frames
    (tests/golden/regen_torch_ref.py), through "portal" (B2) and
    "portal_jnp" (B7, B8), each pose within PX_CEILING: the 8 verify poses
    at 640x400; :doom2: at 800x600 (MAP01's sprites, scrolling wall and
    door pockets, MAP02's strobe room at two phases); the bank verify leg
    at 640x400 (E1M1 and MAP01 on padded tables, 4 envs each), where the
    port's portal and portal_jnp also stay within PX_CEILING of each other
    over the whole leg (bench.py:187)."""
    from tpu_doom_torch.utils.config import PlayerConfig

    def held(label, idx, cov, ref_idx, ref_cov):
        idx, cov = idx.cpu().numpy(), cov.cpu().numpy()
        for i in range(idx.shape[0]):
            n = int((idx[i] != ref_idx[i]).sum())
            nc = int((cov[i] != ref_cov[i]).sum())
            print(f"[golden] {label} {i}: {n} px, {nc} cov differ from JAX portal_jnp"
                  f" (ceiling {PX_CEILING})")
            require(n <= PX_CEILING and nc <= PX_CEILING, f"{label} {i} failed")

    with np.load("tests/golden/verify_640x400_ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    for backend in ("portal", "portal_jnp"):
        vsim = make_sim(batch_size=8, portal_crossings=12, raster_backend=backend,
                        width=BANK_W, height=BANK_H)
        held(f"{backend} verify pose at {BANK_W}x{BANK_H}",
             *vsim.render(verify_state(vsim, ref)), ref["idx"], ref["cov"])
        del vsim

    with np.load("tests/golden/verify_doom2_ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    for level, key in ((0, "map01"), (1, "map02")):
        n = ref[f"{key}_idx"].shape[0]
        for backend in ("portal", "portal_jnp"):
            sim = make_sim(wad_file=":doom2:", initial_level_index=level, batch_size=n,
                           width=800, height=600, raster_backend=backend)
            s = sim.reset(n)._replace(**{k: torch.as_tensor(ref[f"{key}_{k}"], device="cuda")
                                         for k in ("pos", "yaw", "pitch", "time")})
            held(f"{backend} :doom2: {key.upper()} pose at 800x600", *sim.render(s),
                 ref[f"{key}_idx"], ref[f"{key}_cov"])
            del sim

    with np.load("tests/golden/verify_bank_ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    frames = {}
    for backend in ("portal", "portal_jnp"):
        bank = make_bank(BANK5[0:1] + BANK5[2:3], raster_backend=backend,
                         player=PlayerConfig(clip_substeps=1))
        s = bank.reset(4)
        require(np.array_equal(s.pos.cpu().numpy(), ref["pos"]),
                "the bank's reset differs from the JAX bank's")
        idx, cov = bank.render(s._replace(yaw=torch.as_tensor(ref["yaw"], device="cuda")))
        held(f"{backend} bank verify leg (level, env) at {BANK_W}x{BANK_H}",
             idx.flatten(0, 1), cov.flatten(0, 1), ref["idx"].reshape(8, BANK_H, BANK_W),
             ref["cov"].reshape(8, BANK_H, BANK_W))
        frames[backend] = (idx, cov)
        del bank
    leg = int((frames["portal"][0] != frames["portal_jnp"][0]).sum())
    leg_cov = int((frames["portal"][1] != frames["portal_jnp"][1]).sum())
    print(f"[golden] bank verify leg, port portal against port portal_jnp on the same padded"
          f" tables: {leg} px, {leg_cov} cov over the leg (ceiling {PX_CEILING},"
          " bench.py:187)")
    require(leg <= PX_CEILING and leg_cov <= PX_CEILING, "the bank verify leg failed")


def _env_slice(args, kw, i, j):
    """B2's arguments for envs i..j-1 (the per-env ones sliced)."""
    per_env = {0, 1, 2, 4, 5}
    return (tuple(x[i:j] if n in per_env else x for n, x in enumerate(args)),
            dict(shear=kw["shear"][i:j]))


def phase_kernels_bank(results):
    """The kernels of the bank's path at its shapes, each against its plain
    version. On config 5 (4 x 1,024 envs, 640x400) after 8 bank ticks, at
    MAP01 (padded to 141 walk rows): B1 on the rows of the level's next
    step (the padded broad-phase table) and B2 on the env slice
    render_env_chunk gives it (1,024 envs). The plain B2 and its bound's
    byte count run on slices of 256 envs (the plain version's
    intermediates of 1,024 envs would not fit), each env being rendered on
    its own; the bound counts the table entries each slice reads, a few KB
    more than the whole batch reads. Then `phase_kernels_bank_oracle`."""
    from tpu_doom_torch.ops import render_portal_fused, render_portal_fused_ref
    from tpu_doom_torch.render import portal as P

    bank = make_bank(BANK5)
    L, E = bank.num_levels, resolved_chunk(bank.cfg, BANK5_E, BANK_W, BANK_H)
    state = bank.reset(E)
    active = torch.ones((L, E), dtype=torch.bool, device="cuda")
    acts = bank_actions(L, E)
    tick = bank_tick(bank, BANK_W, BANK_H)
    for _ in range(WARMUP_TICKS):
        (state, active), _ = tick((state, active), acts)
    lv = 2
    phase_player_move(results, "_bank", f"config 5's MAP01 ({E} envs, padded table)",
                      bank._at(bank.scenes, lv), bank.cfg, bank._at(state, lv))
    args, kw, _ = P.fused_inputs(bank._at(bank.pscenes, lv), bank._at(bank.scenes, lv),
                                 bank.cfg, BANK_W, BANK_H, bank._at(state, lv))
    del bank, state
    step = min(E, 256)
    parts = [_env_slice(args, kw, i, i + step) for i in range(0, E, step)]

    def plain():
        out = [render_portal_fused_ref(*a, **k) for a, k in parts]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = plain()
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc, wc))
    del wi, wc
    ms, b2b = kernel_ms(lambda: render_portal_fused(*args, **kw))
    plain_ms = time_ms(plain, calls=1, warmup=0)
    n_bytes = sum(portal_bytes(a, k) for a, k in parts)
    print(f"[kernel] B2 render_portal_fused at config 5's shape (MAP01 of the bank,"
          f" {E} of {BANK5_E} envs per launch) records {tuple(args[0].shape)}: {mism}"
          f" mismatched idx/cov px (ceiling 0), max_abs_err {err}; {ms:.4f} ms ({b2b:.4f}"
          f" back to back) vs plain {plain_ms:.4f} ms (one call, in slices of {step})")
    require(mism == 0, f"B2 disagrees with its plain version at the bank's shape on {mism} px")
    record(results, "render_portal_fused_bank", err, ms, b2b, plain_ms, n_bytes,
           gi.numel() * SHADE_PIXEL_OPS)
    del args, parts, gi, gc
    torch.cuda.empty_cache()
    phase_kernels_bank_oracle(results)


def phase_kernels_bank_oracle(results):
    """B7 and B8 on the bank verify leg's members under portal_jnp at
    640x400 (bank_oracle's bank: E1M1 and MAP01, BANK_ORACLE_E envs each,
    half pitched), at MAP01, whose hole table is padded from 56 to the
    bank's 67 rows; then B3 and B9 on the first fallback block of that
    level, the FALLBACK_ENVS pitched envs one run of the fallback's WHILE
    node renders through the triangle path, against their plain versions
    on the first BANK_PLAIN_ENVS of them."""
    from tpu_doom_torch.render.portal import FALLBACK_ENVS

    bank, state = bank_oracle_bank("portal_jnp")
    lv = 1
    require(tuple(bank.pscenes["hole_bytes"].shape[1:]) == (67, 128),
            f"the oracle bank's hole table is {tuple(bank.pscenes['hole_bytes'].shape)}")
    scene, one = bank._at(bank.scenes, lv), bank._at(state, lv)
    phase_kernels_oracle(results, one, suffix="_bank",
                         label=f"the oracle bank's MAP01 ({BANK_ORACLE_E} envs, padded"
                         " hole table)", scenes=(bank._at(bank.pscenes, lv), scene, bank.cfg),
                         width=BANK_W, height=BANK_H)
    block = type(one)(*(x[:FALLBACK_ENVS] for x in one))
    require(bool((block.pitch.abs() > 0.0).all()), "the fallback block is not pitched")
    phase_peel(results, "_bank", f"MAP01's first fallback block ({FALLBACK_ENVS} pitched"
               f" envs) at {BANK_W}x{BANK_H}", scene, bank.cfg, block,
               plain_envs=BANK_PLAIN_ENVS, width=BANK_W, height=BANK_H)
    del bank, state
    torch.cuda.empty_cache()


def phase_golden_frames(golden, sim, label):
    """The four frames.npz scenarios at 160x100 through `sim`."""
    dev = sim.device
    for name, (pos, yaw, pitch, t, door) in GOLDEN_SCENARIOS.items():
        s = sim.reset(1)
        if pos is not None:
            s = s._replace(pos=torch.tensor([pos], device=dev))
        if yaw is not None:
            s = s._replace(yaw=torch.tensor([yaw], device=dev))
        if pitch is not None:
            s = s._replace(pitch=torch.tensor([pitch], device=dev))
        if t is not None:
            s = s._replace(time=torch.tensor([t], device=dev))
        if door:
            oo = s.object_offset.clone()
            oo[0, 1] = door
            s = s._replace(object_offset=oo)
        idx, cov = sim.render(s, 160, 100)
        n = int((idx[0].cpu().numpy() != golden[f"{name}_idx"]).sum())
        cov_eq = bool((cov[0].cpu().numpy() == golden[f"{name}_cov"]).all())
        print(f"[golden] {label} {name} 160x100: {n} px differ, "
              f"coverage equal {cov_eq} (ceiling {PX_CEILING})")
        require(cov_eq and n <= PX_CEILING, f"golden {name} failed ({label})")


def run_ticks(sim, state, acts, ticks):
    """`ticks` ticks of step + render -> (state, checksum, coverage sum)
    as device scalars."""
    check = torch.zeros((), dtype=torch.int64, device=sim.device)
    cov_sum = torch.zeros((), dtype=torch.float64, device=sim.device)
    for _ in range(ticks):
        state, idx, cov = sim.step_render(state, acts)
        check += idx.sum(dtype=torch.int64)
        cov_sum += cov.sum(dtype=torch.float64)
    return state, check, cov_sum


def fallback_share(ticks):
    """Envs on the triangle fallback per env and tick since the tally was
    zeroed (read from the device: synchronises)."""
    from tpu_doom_torch.render import portal as P

    return int(P.fallback_tally("cuda")) / (ticks * B_MAIN)


def timed_segment(tag, label, sim, state, acts, windows, ticks, needed):
    """One main-path segment: the launch counts set to 0, `windows` timed
    windows of `ticks` ticks of step + render, the counts read. Prints
    every window, the median and min/max env*frames/s, the checksum, the
    coverage and the share of envs on the triangle fallback per tick;
    requires each `needed` kernel to have run every tick. Returns the
    launch counts."""
    from tpu_doom_torch.render import portal as P

    reset_counts()
    P.fallback_tally("cuda").zero_()
    check = torch.zeros((), dtype=torch.int64, device=sim.device)
    cov_sum = torch.zeros((), dtype=torch.float64, device=sim.device)
    rates = []
    for w in range(windows):
        t0, c0 = time.perf_counter(), time.process_time()
        state, c, cs = run_ticks(sim, state, acts, ticks)
        torch.cuda.synchronize()
        dt, cpu = time.perf_counter() - t0, time.process_time() - c0
        check += c
        cov_sum += cs
        rates.append(B_MAIN * ticks / dt)
        print(f"[{tag}] window {w}: {ticks} ticks in {dt:.4f} s,"
              f" {dt * 1e3 / ticks:.4f} ms/tick wall,"
              f" {cpu * 1e3 / ticks:.4f} ms/tick process CPU:"
              f" {rates[-1]:.1f} env*frames/s")
    counts = read_counts()
    coverage = float(cov_sum) / (windows * ticks * B_MAIN * W_MAIN * H_MAIN)
    median = float(np.median(rates))
    print(f"[{tag}] {label}, {windows} windows of {ticks} ticks of step + render:"
          f" median {median:.1f} env*frames/s (min"
          f" {min(rates):.1f}, max {max(rates):.1f}); checksum {int(check)},"
          f" coverage {coverage:.4f}; share of envs on the triangle fallback per"
          f" tick {fallback_share(windows * ticks):.4f}; launches {counts}")
    for name in needed:
        require(counts[name] >= windows * ticks, f"{tag}: {name} did not run every tick")
    require(int(check) > 0 and bool(torch.isfinite(state.pos).all()),
            f"{tag}: frames are all zero or the state is not finite")
    require(coverage > 0.5, f"{tag}: coverage {coverage} <= 0.5")
    return counts, median


def fallback_segment(tag, sim, state, acts, needed):
    """FALLBACK_TICKS ticks of the half-pitched fallback sim with the
    launch counts set to 0 before and read after; the triangle path's
    kernel `needed` must have run."""
    reset_counts()
    t0 = time.perf_counter()
    state, _, cov = run_ticks(sim, state, acts, FALLBACK_TICKS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    coverage = float(cov) / (FALLBACK_TICKS * B_MAIN * W_MAIN * H_MAIN)
    print(f"[{tag}] raster_backend={sim.config.raster_backend}"
          f" portal_pitch=triangle, {B_MAIN // 2} envs pitched 0.3,"
          f" {FALLBACK_TICKS} ticks in {dt:.4f} s ({dt * 1e3 / FALLBACK_TICKS:.4f}"
          f" ms/tick wall, no warm-up tick): launches {counts}, coverage {coverage:.4f}")
    require(counts[needed] > 0, f"{tag}: {needed} did not run in the fallback")
    require(coverage > 0.5, f"{tag}: coverage {coverage} <= 0.5")
    return counts, B_MAIN * FALLBACK_TICKS / dt


def rollout_segment(tag, label, sim, state, acts, windows, ticks, needed, eager):
    """A main-path segment through `DoomSim.rollout`, the captured tick
    replayed: first EQUAL_TICKS replayed ticks against as many eager
    step_render ticks, bitwise in frames and final state (this also
    captures the graphs); then, with the launch counts set to 0,
    `windows` timed rollouts of `ticks` ticks, each under
    torch.cuda.set_sync_debug_mode("error"), so that any host
    synchronisation inside rollout fails the run. Prints env*frames/s
    beside the eager segment's `eager`, the kernel launches per replayed
    tick, and the share of envs on the triangle fallback; requires each
    `needed` kernel to have run every tick. Returns (launch counts,
    median env*frames/s)."""
    seq = action_seq(acts, EQUAL_TICKS)
    got_state, got = sim.rollout(state, seq, EQUAL_TICKS)
    s, want = state, []
    for _ in range(EQUAL_TICKS):
        s, idx, _ = sim.step_render(s, acts)
        want.append(idx)
    same_frames = torch.equal(got, torch.stack(want))
    same_state = all(torch.equal(a, b) for a, b in zip(got_state, s))
    print(f"[{tag}] {EQUAL_TICKS} replayed ticks against {EQUAL_TICKS} eager ticks:"
          f" frames bitwise equal {same_frames}, final state bitwise equal {same_state}")
    require(same_frames and same_state, f"{tag}: the replayed ticks differ from eager ones")
    del got, want, got_state, s

    from tpu_doom_torch.render import portal as P

    seq = action_seq(acts, ticks)
    reset_counts()
    P.fallback_tally("cuda").zero_()
    check = torch.zeros((), dtype=torch.int64, device=sim.device)
    rates = []
    for w in range(windows):
        t0, c0 = time.perf_counter(), time.process_time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, frames = sim.rollout(state, seq, ticks)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt, cpu = time.perf_counter() - t0, time.process_time() - c0
        check += frames.sum(dtype=torch.int64)
        rates.append(B_MAIN * ticks / dt)
        print(f"[{tag}] window {w}: rollout of {ticks} ticks in {dt:.4f} s,"
              f" {dt * 1e3 / ticks:.4f} ms/tick wall, {cpu * 1e3 / ticks:.4f} ms/tick"
              f" process CPU: {rates[-1]:.1f} env*frames/s")
    counts = read_counts()
    tick = sim.tick_graphs().ticks[("render", B_MAIN, W_MAIN, H_MAIN)]
    median = float(np.median(rates))
    print(f"[{tag}] {label}, rollout (captured ticks replayed, no host"
          f" synchronisation inside), {windows} windows of {ticks} ticks: median"
          f" {median:.1f} env*frames/s (min {min(rates):.1f}, max {max(rates):.1f})"
          f" against the eager {eager:.1f}, {median / eager:.3f}x; kernel launches per"
          f" replayed tick {tick.launches}, the fallback's {[b.launches for b in tick.bodies]}"
          f" when it runs; share of envs on the triangle fallback per tick"
          f" {fallback_share(windows * ticks):.4f}; checksum {int(check)}; launches {counts}")
    for name in needed:
        require(counts[name] >= windows * ticks, f"{tag}: {name} did not run every tick")
    require(int(check) > 0 and bool(torch.isfinite(state.pos).all()),
            f"{tag}: frames are all zero or the state is not finite")
    return counts, median


@contextlib.contextmanager
def fallback_every_tick():
    """Captures made inside take the triangle path over every env on every
    tick, block by block, merged by torch.where (`graphs.device_while` in
    its eager form): the form of the fallback that needs no conditional
    node, timed beside it."""
    from tpu_doom_torch import graphs

    orig = graphs.device_while

    def unconditional(cond, body, runs):
        for _ in range(runs):
            body()

    graphs.device_while = unconditional
    try:
        yield
    finally:
        graphs.device_while = orig


def time_unconditional_fallback(tag, label, graph_rate, **kw):
    """The rollout of `kw`'s sim with the triangle path over every env on
    every tick, against `graph_rate` (the conditional node's): env*frames/s
    over TEX_WINDOWS windows of TEX_TICKS ticks, and the frames bitwise
    equal to the eager ones."""
    sim = make_sim(**kw)
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    seq = action_seq(acts, TEX_TICKS)
    with fallback_every_tick():
        got_state, got = sim.rollout(state, seq, TEX_TICKS)
    s, want = state, []
    for _ in range(TEX_TICKS):
        s, idx, _ = sim.step_render(s, acts)
        want.append(idx)
    same = torch.equal(got, torch.stack(want)) and all(
        torch.equal(a, b) for a, b in zip(got_state, s))
    rates = []
    for _ in range(TEX_WINDOWS):
        t0 = time.perf_counter()
        state, _ = sim.rollout(state, seq, TEX_TICKS)
        torch.cuda.synchronize()
        rates.append(B_MAIN * TEX_TICKS / (time.perf_counter() - t0))
    median = float(np.median(rates))
    print(f"[{tag}] {label}, rollout with the triangle path over all {B_MAIN} envs"
          f" on every tick (no conditional node): frames and state bitwise equal to"
          f" eager {same}; median {median:.1f} env*frames/s (min {min(rates):.1f}, max"
          f" {max(rates):.1f}) against {graph_rate:.1f} with the conditional node:"
          f" {B_MAIN / median * 1e3 - B_MAIN / graph_rate * 1e3:.4f} ms more per tick")
    require(same, f"{tag}: the unconditional fallback differs from eager")


def lockstep(graph, tick, state, active, acts, ticks):
    """`ticks` eager bank ticks in lockstep with as many replays of the
    captured `graph` -> (whether state, active mask and frames stayed
    bitwise equal, the eager state and active mask)."""
    sbuf, abuf = graph.state_buf
    same = True
    for _ in range(ticks):
        with torch.no_grad():
            (state, active), frames = tick((state, active), acts)
        graph.replay()
        same = (same and torch.equal(graph.outs[0], frames) and torch.equal(abuf, active)
                and all(torch.equal(a, b) for a, b in zip(sbuf, state)))
    return same, state, active


def bank_segment(tag, label, specs, E, width, height, windows, ticks, needed, **kw):
    """A bank segment: the launch counts set to 0; one eager warm-up bank
    tick; the tick captured as one graph; EQUAL_TICKS eager ticks in
    lockstep with as many replays, bitwise equal in state, active mask
    and frames; then `windows` windows over the same `ticks` ticks twice,
    from the state the window starts at: eager ticks, then replays under
    set_sync_debug_mode("error") (also timed with CUDA events, the device
    interval per tick), the two runs' final states bitwise equal; the
    counts read. Prints per window and as medians the env*frames/s eager
    and replayed on the same ticks (host clock, ending in a synchronize),
    the envs on the triangle fallback per tick, the peak device memory
    before and after the capture. Returns (launch counts, replayed
    env*frames/s)."""
    from tpu_doom_torch.render import portal as P
    from tpu_doom_torch.sim.state import SimState

    bank = make_bank(specs, **kw)
    L = bank.num_levels
    state = bank.reset(E)
    active = torch.ones((L, E), dtype=torch.bool, device="cuda")
    acts = bank_actions(L, E)
    tick = bank_tick(bank, width, height)
    print(f"[{tag}] {label}: {L} levels x {E} envs at {width}x{height}, padded walk rows"
          f" {bank.pscenes['has_back'].shape[1]}, texel table"
          f" {tuple(bank.pscenes['tex_i8'].shape[1:])}, render_env_chunk"
          f" {bank.cfg.render_env_chunk} -> {resolved_chunk(bank.cfg, E, width, height)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    P.fallback_tally("cuda").zero_()
    with torch.no_grad():
        (state, active), _ = tick((state, active), acts)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    graph = capture_bank_tick(bank, state, active, acts, width, height)
    sbuf, abuf = graph.state_buf
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated()
    same, state, active = lockstep(graph, tick, state, active, acts, EQUAL_TICKS)
    print(f"[{tag}] {EQUAL_TICKS} replayed bank ticks against {EQUAL_TICKS} eager ones:"
          f" state, active mask and frames bitwise equal {same}; capture {capture_s:.2f} s")
    require(same, f"{tag}: the replayed bank ticks differ from eager ones")
    check = torch.zeros((), dtype=torch.int64, device="cuda")
    rates, eager_rates, dev_ms = [], [], []
    for w in range(windows):
        s_e, a_e = SimState(*(x.clone() for x in sbuf)), abuf.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(ticks):
                (s_e, a_e), _ = tick((s_e, a_e), acts)
        torch.cuda.synchronize()
        eager_rates.append(L * E * ticks / (time.perf_counter() - t0))
        before = int(P.fallback_tally("cuda"))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            for _ in range(ticks):
                graph.replay()
                check += graph.outs[0].sum(dtype=torch.int64)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(L * E * ticks / dt)
        dev_ms.append(start.elapsed_time(end) / ticks)
        fallen = (int(P.fallback_tally("cuda")) - before) / ticks
        same = torch.equal(a_e, abuf) and all(torch.equal(a, b) for a, b in zip(s_e, sbuf))
        print(f"[{tag}] window {w}: {ticks} ticks from the same state, eager"
              f" {eager_rates[-1]:.1f} env*frames/s; replayed {dt * 1e3 / ticks:.4f} ms/tick"
              f" wall, {dev_ms[-1]:.4f} ms/tick between CUDA events: {rates[-1]:.1f}"
              f" env*frames/s; final states bitwise equal {same}; {fallen:.1f} envs on the"
              " triangle fallback per tick")
        require(same, f"{tag}: window {w}'s replays end unlike its eager ticks")
    counts = read_counts()
    eager_rate = float(np.median(eager_rates))
    median = float(np.median(rates))
    peak = torch.cuda.max_memory_allocated()
    moved = int((~abuf).sum())
    n_ticks = 2 + EQUAL_TICKS * 2 + windows * ticks * 2
    print(f"[{tag}] {label}, {L} x {E} envs at {width}x{height}, {windows} windows of"
          f" {ticks} ticks: eager median {eager_rate:.1f} env*frames/s (min"
          f" {min(eager_rates):.1f}, max {max(eager_rates):.1f}); replayed median"
          f" {median:.1f} env*frames/s (min {min(rates):.1f}, max {max(rates):.1f}),"
          f" {median / eager_rate:.3f}x, device {float(np.median(dev_ms)):.4f} ms/tick"
          f" between CUDA events; peak device memory {eager_peak / 2**30:.2f} GiB eager,"
          f" {graph_peak / 2**30:.2f} GiB after the capture, {peak / 2**30:.2f} GiB in all;"
          f" kernel launches per replayed tick {graph.launches}, the {len(graph.bodies)}"
          f" fallback bodies' per run; inactive slots after the run {moved}; share of envs"
          f" on the triangle fallback per env and tick"
          f" {int(P.fallback_tally('cuda')) / (n_ticks * L * E):.4f}; checksum {int(check)};"
          f" launches {counts}")
    for name in needed:
        require(counts[name] >= windows * ticks * L, f"{tag}: {name} did not run every tick")
    require(int(check) > 0 and bool(torch.isfinite(sbuf.pos).all()),
            f"{tag}: frames are all zero or the state is not finite")
    require(moved == 0, f"{tag}: {moved} slots went inactive: every group was full, so"
            " an exit must restart its env in place")
    del graph, sbuf, abuf, bank, state, active
    torch.cuda.empty_cache()
    return counts, median


def resolved_chunk(cfg, batch, width, height):
    """The env slice render_dispatch uses for this batch (AUTO resolved)."""
    from tpu_doom_torch.render import env_chunk

    return env_chunk(cfg, batch, width, height)


def bank_big_segment(tag):
    """A bank with a member on the big-level walk (:test: E1M1 and
    :texstress:, whose 600 walk rows put every level on it) at
    portal_global_segs_max=1024, so that every level also takes the
    active-set path (B4, B6, B5, B2 per env): BANK_BIG_E envs per level at
    320x200, after 4 bank ticks. Each level's frames are held bitwise to
    the same states rendered by a DoomSim of that level alone (the port's
    `test_bank_portal_matches_standalone`), then EQUAL_TICKS replays of the
    captured bank tick to eager ones. Returns the launch counts."""
    from tpu_doom_torch.sim.state import SimState

    bank = make_bank(BANK_BIG, width=W_MAIN, height=H_MAIN,
                     portal_global_segs_max=TEX_CAP)
    L, E = bank.num_levels, BANK_BIG_E
    state = bank.reset(E)
    active = torch.ones((L, E), dtype=torch.bool, device="cuda")
    acts = bank_actions(L, E)
    tick = bank_tick(bank, W_MAIN, H_MAIN)
    reset_counts()
    with torch.no_grad():
        for _ in range(4):
            (state, active), _ = tick((state, active), acts)
        idx, cov = bank.render(state)
    diff = []
    for lv, (wad, level) in enumerate(BANK_BIG):
        sim = make_sim(wad_file=wad, initial_level_index=level, batch_size=E,
                       portal_global_segs_max=TEX_CAP)
        i1, c1 = sim.render(SimState(*(x[lv] for x in state)))
        diff.append(int((i1 != idx[lv]).sum()) + int((c1 != cov[lv]).sum()))
        del sim
    graph = capture_bank_tick(bank, state, active, acts, W_MAIN, H_MAIN)
    same = lockstep(graph, tick, state, active, acts, EQUAL_TICKS)[0]
    counts = read_counts()
    print(f"[{tag}] a bank of {[w for w, _ in BANK_BIG]} at {W_MAIN}x{H_MAIN} x {E} envs,"
          f" portal_global_segs_max={TEX_CAP}, padded walk rows"
          f" {bank.pscenes['has_back'].shape[1]}: each level's frames against that level"
          f" rendered alone: {diff} mismatched idx/cov px (ceiling 0); {EQUAL_TICKS} replays"
          f" against eager ticks bitwise equal {same}; launches {counts}")
    require(diff == [0] * L, f"{tag}: a level of the bank renders unlike itself alone")
    require(same, f"{tag}: the replayed bank ticks differ from eager ones")
    for name in ("player_move", "select_rows", "scatter_live", "gather_cells",
                 "render_portal_fused_per_env"):
        require(counts[name] > 0, f"{tag}: {name} did not run")
    del graph, bank
    torch.cuda.empty_cache()
    return counts


def bank_oracle_bank(backend):
    """The bank verify leg's members (:test: E1M1, :doom2: MAP01) under
    `backend` with portal_pitch="triangle", BANK_ORACLE_E envs per level
    at 640x400, the first half of each level pitched 0.3 so that the
    fallback runs -> (bank, state)."""
    bank = make_bank(BANK5[0:1] + BANK5[2:3], raster_backend=backend,
                     portal_pitch="triangle")
    state = bank.reset(BANK_ORACLE_E)
    pitch = state.pitch.clone()
    pitch[:, : BANK_ORACLE_E // 2] = 0.3
    return bank, state._replace(pitch=pitch)


def bank_oracle_segment(tag, backend):
    """bank_oracle_bank(backend)'s ticks: under portal_jnp, the reference
    configuration, B7 and B8 on the padded hole table and B9 in the
    fallback's WHILE node; under portal, B2 and B3 there. FALLBACK_TICKS
    replays of the captured bank tick bitwise against eager ticks.
    Returns the launch counts."""
    bank, state = bank_oracle_bank(backend)
    L, E = bank.num_levels, BANK_ORACLE_E
    active = torch.ones((L, E), dtype=torch.bool, device="cuda")
    acts = bank_actions(L, E)
    tick = bank_tick(bank, BANK_W, BANK_H)
    reset_counts()
    graph = capture_bank_tick(bank, state, active, acts, BANK_W, BANK_H)
    same = lockstep(graph, tick, state, active, acts, FALLBACK_TICKS)[0]
    counts = read_counts()
    print(f"[{tag}] the bank verify leg's members under {backend}, {L} x {E} envs at"
          f" {BANK_W}x{BANK_H}, half pitched under portal_pitch=triangle, hole table"
          f" {tuple(bank.pscenes['hole_bytes'].shape)} for texel table"
          f" {tuple(bank.pscenes['tex_i8'].shape)}: {FALLBACK_TICKS} replays against eager"
          f" ticks bitwise equal {same}; launches {counts}")
    require(same, f"{tag}: the replayed bank ticks differ from eager ones")
    needed = (("classify_alpha", "shade_portal", "depth_peel") if backend == "portal_jnp"
              else ("render_portal_fused", "peel_resolve"))
    for name in needed:
        require(counts[name] > 0, f"{tag}: {name} did not run")
    del graph, bank
    torch.cuda.empty_cache()
    return counts


def legacy_segment(tag):
    """B1 against its second oracle on the card: :test: x 256 envs, bench
    actions, LEGACY_TICKS ticks in lockstep through the shipped path (B1)
    and through collision_backend="legacy" with the broad phase on and off
    (plain PyTorch); the two legacy runs bitwise equal, the legacy run
    within TRAJECTORY_DRIFT_CEILING of B1's. Returns the launch counts."""
    from tpu_doom_torch.utils.config import PlayerConfig

    sims = {name: make_sim(player=PlayerConfig(clip_substeps=4, **pk)) for name, pk in (
        ("b1", {}), ("legacy", dict(collision_backend="legacy")),
        ("brute", dict(collision_backend="legacy", collision_broadphase=False)))}
    states = {k: s.reset() for k, s in sims.items()}
    acts = bench_actions(sims["b1"], B_MAIN)
    reset_counts()
    drift = torch.zeros((), dtype=torch.float32, device="cuda")
    same = torch.ones((), dtype=torch.bool, device="cuda")
    t = {k: 0.0 for k in sims}
    for _ in range(LEGACY_TICKS):
        for k, sim in sims.items():
            t0 = time.perf_counter()
            states[k] = sim.step(states[k], acts)
            torch.cuda.synchronize()
            t[k] += time.perf_counter() - t0
        drift = torch.maximum(drift, (states["legacy"].pos - states["b1"].pos).abs().max())
        same &= all(torch.equal(a, b) for a, b in zip(states["legacy"], states["brute"]))
    counts = read_counts()
    print(f"[{tag}] :test: {B_MAIN} envs, {LEGACY_TICKS} ticks of bench actions: the legacy"
          f" oracle (broad phase) against B1's path, max |pos| drift {float(drift):.3e}"
          f" (ceiling {TRAJECTORY_DRIFT_CEILING}); legacy brute force and broad phase"
          f" bitwise equal {bool(same)}; ms/tick " + ", ".join(
              f"{k} {v * 1e3 / LEGACY_TICKS:.4f}" for k, v in t.items())
          + f"; launches {counts}")
    require(float(drift) <= TRAJECTORY_DRIFT_CEILING, f"{tag}: legacy drifts from B1's path")
    require(bool(same), f"{tag}: the legacy brute force and broad phase differ")
    require(counts["player_move"] == LEGACY_TICKS, f"{tag}: B1 did not run every tick")
    return counts


def phase_bank():
    """The level-bank and legacy segments of the main path -> {segment:
    launch counts}."""
    segments = {}
    segments["bank5"], _ = bank_segment(
        "bank5", "BASELINE config 5 (E1M1, E1M2, MAP01, MAP02)", BANK5, BANK5_E, BANK_W,
        BANK_H, BANK_WINDOWS, BANK_TICKS, ("player_move", "render_portal_fused"))
    segments["bank8"], _ = bank_segment(
        "bank8", "the L=8 bank (bench.py:277-283)", BANK8, BANK8_E, BANK_W, BANK_H,
        BANK_WINDOWS, BANK8_TICKS, ("player_move", "render_portal_fused"))
    segments["bank_big"] = bank_big_segment("bank_big")
    segments["bank_oracle"] = bank_oracle_segment("bank_oracle", "portal_jnp")
    segments["bank_fallback"] = bank_oracle_segment("bank_fallback", "portal")
    segments["legacy"] = legacy_segment("legacy")
    return segments


def phase_main(results):
    from tpu_doom_torch.render import portal as P

    P.fallback_tally("cuda")  # before any capture, so that the graphs count too
    sim = make_sim()
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    state, _, _ = run_ticks(sim, state, acts, WARMUP_TICKS)
    torch.cuda.synchronize()
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    print(f"[host] {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable;"
          f" load average {load}")
    main_needed = ("player_move", "render_portal_fused")
    segments, eager = {}, {}
    segments["bench"], eager["bench"] = timed_segment(
        "main", f":test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs", sim, state, acts,
        WINDOWS, TIMED_TICKS, main_needed)
    segments["rollout"], graph_rate = rollout_segment(
        "rollout", f":test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs", sim, state, acts,
        WINDOWS, TIMED_TICKS, main_needed, eager["bench"])
    del sim, state
    time_unconditional_fallback("fallback_form", f":test: {W_MAIN}x{H_MAIN}", graph_rate)

    # The half-pitched fallback batch, eager then replayed: the triangle
    # path (B3; B9 under portal_jnp) inside the graph's conditional node.
    for seg, backend, needed in (("fallback", "portal", "peel_resolve"),
                                 ("oracle_fallback", "portal_jnp", "depth_peel")):
        fsim, fstate, facts = fallback_sim(raster_backend=backend)
        segments[seg], eager[seg] = fallback_segment(seg, fsim, fstate, facts, needed)
        segments["rollout_" + seg], _ = rollout_segment(
            "rollout_" + seg, f":test: raster_backend={backend} portal_pitch=triangle,"
            f" {B_MAIN // 2} envs pitched 0.3", fsim, fstate, facts, 1, FALLBACK_TICKS,
            (needed,), eager[seg])
        del fsim, fstate

    # The portal_jnp configuration (B7 then B8 every frame).
    sim = make_sim(raster_backend="portal_jnp")
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    state, _, _ = run_ticks(sim, state, acts, TEX_WARMUP)
    torch.cuda.synchronize()
    oracle_needed = ("player_move", "classify_alpha", "shade_portal")
    segments["oracle"], eager["oracle"] = timed_segment(
        "oracle", f":test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs raster_backend=portal_jnp",
        sim, state, acts, TEX_WINDOWS, TEX_TICKS, oracle_needed)
    segments["rollout_oracle"], _ = rollout_segment(
        "rollout_oracle", f":test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs"
        " raster_backend=portal_jnp", sim, state, acts, TEX_WINDOWS, TEX_TICKS,
        oracle_needed, eager["oracle"])
    del sim, state

    # The same two fallbacks on a maze's triangles (:texstress:).
    for seg, backend, needed in (("texstress_fallback", "portal", "peel_resolve"),
                                 ("texstress_oracle_fallback", "portal_jnp",
                                  "depth_peel")):
        fsim, fstate, facts = fallback_sim(wad_file=TEX_WAD, raster_backend=backend)
        segments[seg], _ = fallback_segment(seg, fsim, fstate, facts, needed)
        del fsim, fstate

    for seg, extra, needed in (
            ("texstress", {}, ("player_move", "render_portal_fused", "select_rows")),
            ("texstress_act", dict(portal_global_segs_max=TEX_CAP),
             ("player_move", "render_portal_fused", "select_rows", "scatter_live",
              "gather_cells", "render_portal_fused_per_env"))):
        sim = make_sim(wad_file=TEX_WAD, **extra)
        state = sim.reset()
        acts = bench_actions(sim, B_MAIN)
        state, _, _ = run_ticks(sim, state, acts, TEX_WARMUP)
        torch.cuda.synchronize()
        label = f"{TEX_WAD} {W_MAIN}x{H_MAIN} x {B_MAIN} envs {extra or 'shipped defaults'}"
        segments[seg], eager[seg] = timed_segment(
            seg, label, sim, state, acts, TEX_WINDOWS, TEX_TICKS, needed)
        if extra:  # B6 and B5 inside the graph
            segments["rollout_" + seg], graph_rate = rollout_segment(
                "rollout_" + seg, label, sim, state, acts, TEX_WINDOWS, TEX_TICKS,
                needed, eager[seg])
        del sim, state
        if extra:
            time_unconditional_fallback("fallback_form", label, graph_rate,
                                        wad_file=TEX_WAD, **extra)

    segments.update(phase_bank())
    return segments


def tally(results, segments):
    """Each kernel row's launches: summed over the segments and per
    segment, the rows at the bank's and the maze's shapes split out."""
    for seg, c in segments.items():  # B2's global-table, B3's and B9's launches on :texstress:
        maze = "texstress" in seg
        c["render_portal_fused_texstress"] = (
            c["render_portal_fused"] - c["render_portal_fused_per_env"] if maze else 0)
        # The bank's rows: its 640x400 segments (bank_big runs 320x200);
        # entry_bank and parallel_bank5_sharded are config 5's tick.
        config5 = ("bank5", "bank8", "entry_bank", "parallel_bank5_sharded")
        c["render_portal_fused_bank"] = c["render_portal_fused"] if seg in config5 else 0
        at_bank = seg in config5 + ("bank_oracle", "bank_fallback")
        for name in ("player_move", "classify_alpha", "shade_portal", "peel_resolve",
                     "depth_peel"):
            c[name + "_bank"] = c[name] if at_bank else 0
        c["peel_resolve_maze"] = c["peel_resolve"] if maze else 0
        c["depth_peel_maze"] = c["depth_peel"] if maze else 0
        # The entry points' rows: the CLI's and entry()'s runs at 64x40.
        at_entry = seg in ("entry_cli", "entry_fn")
        for name in ("player_move", "render_portal_fused", "peel_resolve"):
            c[name + "_entry"] = c[name] if at_entry else 0
    totals = {k: sum(c.get(k, 0) for c in segments.values()) for k in results}
    for name, r in results.items():
        require(name in TOOL_KERNELS or totals[name] > 0,
                f"{name} never launched on the main path")
        r.update(launches=totals[name],
                 **{f"{seg}_launches": c.get(name, 0) for seg, c in segments.items()})


ENTRY_TIMEOUT = 300  # seconds per entry-point subprocess


def entry_point(tag, args, needed=(), **env):
    """`python3 -m <args>` on the card in a subprocess with `env` added:
    its JSON line (the last of its stdout) and its own launch counts (its
    stderr's `launches` line, from just before its timed window to just
    after). Prints the JSON line and its stderr's summary lines; fails the
    run if it fails, prints no JSON line, or launched a `needed` kernel
    no time."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                       timeout=ENTRY_TIMEOUT, env={**os.environ, **env})
    secs = time.perf_counter() - t0
    command = " ".join([f"{k}={v}" for k, v in env.items()] + ["python3 -m", *args])
    for line in r.stderr.splitlines():
        if line.startswith(("bench ", "bank ", "Traceback", "RuntimeError")):
            print(f"[{tag}] {line}")
    lines = r.stdout.strip().splitlines()
    print(f"[{tag}] {command}: rc {r.returncode} in {secs:.1f} s")
    require(r.returncode == 0 and lines, f"{tag}: {command} failed: {r.stderr[-2000:]}")
    print(f"[{tag}] {lines[-1]}")
    out = json.loads(lines[-1])
    counts = [json.loads(x[len("launches "):]) for x in r.stderr.splitlines()
              if x.startswith("launches ")]
    require(len(counts) == 1, f"{tag}: no launch counts printed")
    for name in needed:
        require(counts[0][name] > 0, f"{tag}: {name} was not launched")
    return out, counts[0]


@contextlib.contextmanager
def segment(segments, tag):
    """The launch counts set to 0 before the block and read into
    segments[tag] after it."""
    reset_counts()
    yield
    segments[tag] = read_counts()


def entry_fn_segment(tag, out_dir):
    """tpu_doom_torch.entry's fn captured as one graph with seeded walking
    actions, 4 replays bitwise equal to 4 eager ticks; the same 4 ticks
    from CPU copies of the state and actions (the kernels' plain
    versions) held to the card's; then the card state through a
    checkpoint, bitwise."""
    from tpu_doom_torch.entry import entry
    from tpu_doom_torch.graphs import CapturedTick
    from tpu_doom_torch.sim.state import Actions, SimState
    from tpu_doom_torch.utils.checkpoint import load_state, save_state

    fn, (state, acts) = entry()
    cpu_fn, _ = entry(device="cpu")
    acts = entry_walk_actions(acts)
    cpu_state = SimState(*(x.cpu() for x in state))
    cpu_acts = Actions(*(x.cpu() for x in acts))
    graph = CapturedTick(fn, SimState(*(x.clone() for x in state)), acts)
    same = same_cpu = True
    for _ in range(ENTRY_REPLAYS):
        with torch.no_grad():
            state, frames = fn(state, acts)
            cpu_state, cpu_frames = cpu_fn(cpu_state, cpu_acts)
        graph.replay()
        same = (same and torch.equal(graph.outs[0], frames)
                and all(torch.equal(a, b) for a, b in zip(graph.state_buf, state)))
        same_cpu = (same_cpu and torch.equal(frames.cpu(), cpu_frames)
                    and all(torch.equal(a.cpu(), b) for a, b in zip(state, cpu_state)))
    print(f"[{tag}] entry(): fn captured, {ENTRY_REPLAYS} replays against as many eager"
          f" ticks: state and frames {tuple(frames.shape)} bitwise equal {same}; kernel"
          f" launches per replay {graph.launches}")
    print(f"[{tag}] entry(): the same {ENTRY_REPLAYS} ticks from CPU copies (the plain"
          f" versions): state and frames bitwise equal to the card's {same_cpu}")
    require(same, f"{tag}: entry()'s replays differ from its eager ticks")
    require(same_cpu, f"{tag}: entry()'s card ticks differ from its CPU ticks")
    path = os.path.join(out_dir, "state.npz")
    save_state(path, state, tick=ENTRY_REPLAYS)
    back, meta = load_state(path)
    same = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(back, state))
    print(f"[{tag}] checkpoint of the card state ({len(state)} fields) saved and loaded"
          f" back on {back.pos.device}: bitwise equal {same}, meta {dict(meta)}")
    require(same and int(meta["tick"]) == ENTRY_REPLAYS, f"{tag}: checkpoint round trip")


def cli_dump_against_cpu(tag, cli, out, backend):
    """The CLI's dump-frames under `backend` (None: its default) on the
    card, then with --device cpu: the card's frames and manifest bitwise
    the CPU's."""
    dump = ["dump-frames", "--ticks", str(CLI_DUMP_TICKS), "--every", "10"]
    chosen = ["--backend", backend] if backend else []
    runs = {}
    for dev in ("cuda", "cpu"):
        argv = ["--device", dev, "--iwad", ":test:", "-r", f"{ENTRY_W}x{ENTRY_H}",
                *chosen, *dump, "--out", f"{out}/{dev}"]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        print(f"[{tag}] python -m tpu_doom_torch.cli {' '.join(argv)}: rc {rc} in"
              f" {time.perf_counter() - t0:.1f} s")
        require(rc == 0, f"{tag}: dump-frames on {dev} failed")
        with open(f"{out}/{dev}/manifest.json") as f:
            runs[dev] = json.load(f)
    card, cpu = runs["cuda"], runs["cpu"]
    px = 0
    for f in card["frames"]:
        fa, fb = (np.load(f"{out}/{d}/{f['file']}") for d in ("cuda", "cpu"))
        require(fa.shape == fb.shape == (ENTRY_H, ENTRY_W), f"{tag}: frame shape {fa.shape}")
        px += int((fa != fb).sum())
    name = backend or "auto (the default)"
    print(f"[{tag}] dump-frames under {name}, card vs CPU: manifests (poses included)"
          f" equal {card == cpu}, {len(card['frames'])} frames, {px} px differ (ceiling 0)")
    require(card == cpu and len(card["frames"]) == 3 and px == 0,
            f"{tag}: dump-frames under {name} differs between the card and the CPU")


def phase_entry_points():
    """Phase 7: the port's entry points on the card -> {segment: launch
    counts}."""
    import tempfile

    from tpu_doom_torch import cli

    torch.cuda.empty_cache()  # the subprocesses' memory
    segments = {}
    main_needed = ("player_move", "render_portal_fused")
    _, segments["entry_bench"] = entry_point(
        "entry_bench", ["tpu_doom_torch.bench"], main_needed)
    _, segments["entry_bank"] = entry_point(
        "entry_bank", ["tpu_doom_torch.bench"], main_needed, BENCH_BANK="1",
        BENCH_TICKS=str(ENTRY_BANK_TICKS))
    out, segments["entry_verify"] = entry_point(
        "entry_verify", ["tpu_doom_torch.bench", "--verify"],
        ("render_portal_fused", "classify_alpha", "shade_portal", "peel_resolve",
         "depth_peel", "select_rows", "scatter_live", "gather_cells"))
    for leg, r in out["legs"].items():
        print(f"[entry_verify] {leg}: portal vs portal_jnp {r['mismatch_px']} px,"
              f" {r['mismatch_cov']} cov; JAX golden {r['golden_px']} px, {r['golden_cov']}"
              f" cov ({r['golden_per']}, px ceiling {r['golden_ceiling']}); pass {r['pass']}")
    require(out["pass"] and len(out["legs"]) == 7, "entry_verify: --verify failed")
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        with segment(segments, "entry_cli"):
            base = ["--iwad", ":test:", "-r", f"{ENTRY_W}x{ENTRY_H}"]
            for args in (["list-levels"], ["check"], ["bench", "--ticks", "8"],
                         ["demo", "--ticks", "3", "--every", "2", "--out", f"{tmp}/demo"]):
                t0 = time.perf_counter()
                rc = cli.main(base + args)
                print(f"[entry_cli] python -m tpu_doom_torch.cli {' '.join(base + args)}:"
                      f" rc {rc} in {time.perf_counter() - t0:.1f} s")
                require(rc == 0, f"entry_cli: {args[0]} failed")
            for backend in ("portal", None):
                cli_dump_against_cpu("entry_cli", cli, f"{tmp}/dump_{backend or 'auto'}",
                                     backend)
            pngs = [x for x in os.listdir(f"{tmp}/demo") if x.endswith(".png")]
        print(f"[entry_cli] demo wrote {len(pngs)} PNGs; launches {segments['entry_cli']}")
        require(len(pngs) == 2, "entry_cli: demo wrote too little")
        with segment(segments, "entry_fn"):
            entry_fn_segment("entry_fn", tmp)
    # The CLI's default backend, "auto", renders through B3; one of its
    # dump-frames runs "portal" (B2).
    for seg, names in (("entry_cli", main_needed + ("peel_resolve",)),
                       ("entry_fn", main_needed)):
        for name in names:
            require(segments[seg][name] > 0, f"{seg}: {name} did not run")
    return segments


def _same(a, b):
    return np.array_equal(a, b.cpu().numpy())


def parallel_world(tag, n, backend=None):
    """`dryrun_multichip(n)` at its default shapes in a new world of n
    processes on the card (NCCL unless `backend`), each rank held to the
    same envs of `entry.dryrun_reference`: state shard and frame band bitwise
    in both legs (and the bank's active mask and moved envs). Every rank
    must have printed both OK lines and agree on the metrics. Returns
    (the ranks' results, their launch counts summed)."""
    from tpu_doom_torch.entry import dryrun_multichip, dryrun_reference

    t0 = time.perf_counter()
    ranks = dryrun_multichip(n, backend=backend)
    secs = time.perf_counter() - t0
    (state, frames, covered), (bstate, active, moved, bidx) = dryrun_reference(
        ranks[0]["mesh"][0])
    counts = {}
    for r in ranks:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
        envs, rows, benvs = slice(*r["envs"]), slice(*r["rows"]), slice(*r["bank"]["envs"])
        main_same = _same(r["frames"], frames[envs, rows]) and all(
            _same(a, b[envs]) for a, b in zip(r["state"], state))
        b = r["bank"]
        bank_same = (_same(b["frames"], bidx[:, benvs, rows]) and _same(b["active"],
                     active[:, benvs]) and _same(b["moved"], moved[:, benvs])
                     and all(_same(x, y[:, benvs]) for x, y in zip(b["state"], bstate)))
        oks = [x for x in r["lines"] if x.startswith(("dryrun_multichip OK:",
                                                     "dryrun_multichip bank leg OK:"))]
        print(f"[{tag}] rank {r['rank']} of {n}: mesh (dp, tp) {r['mesh']}, captured"
              f" {r['captured']}, envs {r['envs']}, rows {r['rows']}: main leg state and"
              f" frames bitwise the unsharded tick's {main_same}; bank leg envs"
              f" {b['envs']}: state, active, moved and frames bitwise {bank_same};"
              f" metrics {r['metrics']}; OK lines {len(oks)}")
        require(len(oks) == 2, f"{tag}: rank {r['rank']} printed {len(oks)} of 2 OK lines")
        require(main_same and bank_same, f"{tag}: rank {r['rank']} differs from the"
                " unsharded run")
        require(r["captured"] == (backend is None), f"{tag}: captured {r['captured']}")
    full = {"coverage": float(covered.float().mean()), "mean_y": float(state.pos[:, 1].mean())}
    rel = {k: abs(ranks[0]["metrics"][k] - v) / abs(v) for k, v in full.items()}
    agree = all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    print(f"[{tag}] dryrun_multichip({n}{'' if backend is None else f', backend={backend!r}'})"
          f" in {secs:.1f} s: mean_metric {ranks[0]['metrics']} equal on every rank {agree};"
          f" x.mean() of the unsharded tick {full}, relative difference {rel}; launches"
          f" {counts}")
    require(agree, f"{tag}: the ranks' metrics differ")
    if n == 1:
        require(ranks[0]["metrics"] == full, f"{tag}: mean_metric is not x.mean()")
    require(max(rel.values()) <= MEAN_METRIC_RTOL, f"{tag}: mean_metric off by {rel}")
    return ranks, counts


def bank5_sharded_rank(tag):
    """The rank of a world of one NCCL rank that `bank5_sharded_segment`
    starts: BASELINE config 5 through the bank under its (1, 1) mesh, the
    tick captured with the all-gather inside, next to the unsharded
    captured bank tick: PARALLEL_REPLAYS replays of each in lockstep,
    bitwise equal in state, active mask and frames; then windows of
    BANK_TICKS replays in turns (unsharded, sharded, sharded, unsharded,
    each pair over the same ticks), env*frames/s (host clock ending in a
    synchronize) and device ms per replay (CUDA events); and the
    all-gather alone, the tick's gather on the same masks, eager and
    captured (device us per call). Numbers to record, not a gate.
    Returns the launch counts."""
    from tpu_doom_torch.parallel import make_mesh
    from tpu_doom_torch.parallel.mesh import gather_envs

    mesh = make_mesh(1, 1)
    reset_counts()
    graphs = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        bank = make_bank(BANK5, mesh=m)
        L = bank.num_levels
        active = torch.ones((L, BANK5_E), dtype=torch.bool, device="cuda")
        graphs[name] = capture_bank_tick(bank, bank.reset(BANK5_E), active,
                                         bank_actions(L, BANK5_E), BANK_W, BANK_H)
        print(f"[{tag}] {name} config 5 bank tick captured", flush=True)
    plain, sharded = graphs["unsharded"], graphs["sharded"]

    def same():
        return (torch.equal(plain.outs[0], sharded.outs[0])
                and torch.equal(plain.state_buf[1], sharded.state_buf[1])
                and all(torch.equal(a, b) for a, b in zip(plain.state_buf[0],
                                                           sharded.state_buf[0])))

    equal = True
    for _ in range(PARALLEL_REPLAYS):
        plain.replay()
        sharded.replay()
        equal = equal and same()
    print(f"[{tag}] config 5 ({L} x {BANK5_E} envs at {BANK_W}x{BANK_H}) in a world of"
          f" one NCCL rank: {PARALLEL_REPLAYS} replays of the sharded bank tick against as"
          f" many of the unsharded one: state, active mask and frames bitwise equal"
          f" {equal}; kernel launches per replay, sharded {sharded.launches}", flush=True)
    require(equal, f"{tag}: the sharded bank tick differs from the unsharded one")
    rates = {"unsharded": [], "sharded": []}
    dev_ms = {"unsharded": [], "sharded": []}
    for order in (("unsharded", "sharded"), ("sharded", "unsharded")):
        for name in order:
            g = graphs[name]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(BANK_TICKS):
                g.replay()
            end.record()
            torch.cuda.synchronize()
            rates[name].append(L * BANK5_E * BANK_TICKS / (time.perf_counter() - t0))
            dev_ms[name].append(start.elapsed_time(end) / BANK_TICKS)
    equal = same()
    masks = torch.ones((2, L, BANK5_E), dtype=torch.bool, device="cuda")
    gather_eager = time_ms(lambda: gather_envs(masks, mesh, axis=2), calls=GATHER_CALLS)
    gather_graph = graph_ms(lambda: gather_envs(masks, mesh, axis=2))
    counts = read_counts()
    summary = {name: dict(env_frames_per_s=[round(x, 1) for x in rates[name]],
                          device_ms_per_replay=[round(x, 4) for x in dev_ms[name]])
               for name in rates}
    cost = float(np.mean(dev_ms["sharded"]) - np.mean(dev_ms["unsharded"]))
    print(f"[{tag}] windows of {BANK_TICKS} replays in turns (unsharded, sharded, sharded,"
          f" unsharded): {json.dumps(summary)}; sharded minus unsharded {cost * 1e3:.1f} us"
          f" of device time per replay; final states bitwise equal {equal}")
    print(f"[{tag}] the tick's all-gather ({masks.numel()} bytes of masks over a 'dp'"
          f" group of one): {gather_eager * 1e3:.2f} us per call eager,"
          f" {gather_graph * 1e3:.2f} us captured (device time, CUDA events)", flush=True)
    require(equal, f"{tag}: the timed replays end apart")
    return counts


def bank5_sharded_segment(tag):
    """`bank5_sharded_rank` in a world of one NCCL rank, a process of its
    own (as `parallel_dp1_nccl`) -> its launch counts."""
    from tpu_doom_torch.parallel import launch

    torch.cuda.empty_cache()
    (counts,) = launch(1, bank5_sharded_rank, tag)
    return counts


def phase_parallel():
    """Phase 8: tpu_doom_torch.parallel and dryrun_multichip on the card ->
    {segment: launch counts}."""
    torch.cuda.empty_cache()
    segments = {}
    needed = ("player_move", "render_portal_fused")
    _, segments["parallel_dp1_nccl"] = parallel_world("parallel_dp1_nccl", 1)
    _, segments["parallel_dp2_gloo"] = parallel_world("parallel_dp2_gloo", 2, "gloo")
    segments["parallel_bank5_sharded"] = bank5_sharded_segment("parallel_bank5_sharded")
    for seg, c in segments.items():
        for name in needed:
            require(c.get(name, 0) > 0, f"{seg}: {name} did not run")
    return segments


def main():
    faulthandler.enable()  # a crash in a kernel or a collective prints the Python stack
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    results = {name: dict(name=name, route="cuda", **meta)
               for name, meta in KERNELS.items()}
    phase_kernels(results)
    phase_kernels_maze(results)
    phase_kernels_texstress(results)
    phase_kernels_bank(results)
    phase_kernels_entry(results)
    phase_tools(results)
    phase_goldens()
    phase_goldens_hires()
    segments = phase_main(results)
    segments.update(phase_entry_points())
    segments.update(phase_parallel())
    tally(results, segments)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "ms_b2b", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_ms_b2b", *(f"{seg}_launches" for seg in segments))
    print(f"[time] chip_smoke.py took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: results[n][k] for k in order}
                                  for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
