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
     portal_global_segs_max=1024 (all bitwise); B1 on :texstress:'s rows
     (bitwise, with their M).
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
     configs and under portal_jnp (all made by the JAX package).
  6. main path: every segment runs with the launch counts set to 0 just
     before it and read just after:
     bench: DoomSim on :test: at 320x200 x 256 envs, bench actions, 8
       warm-up ticks, then 5 windows of 32 timed ticks of step + render;
       env*frames/s per window, their median and spread, and the
       process's CPU ms per tick beside the wall ms;
     fallback: 4 ticks with portal_pitch="triangle" and half the envs
       pitched, so the triangle path (B3) runs inside the main path (the
       bench trajectory never overflows the crossing budget);
     oracle, oracle_fallback: the same with raster_backend="portal_jnp"
       (B7 and B8 every frame; 4 warm-up ticks, 3 windows of 8 ticks),
       and its fallback through the jnp triangle path (B9);
     texstress_fallback, texstress_oracle_fallback: both fallbacks on
       :texstress: (B3, B9 on a maze's triangles);
     texstress, texstress_act: DoomSim on :texstress: at 320x200 x 256
       envs, bench actions, at shipped defaults (the big-level walk with
       B4) and with portal_global_segs_max=1024 (the active-set path: B6,
       B5, B2 per env); 4 warm-up ticks, then 3 windows of 8 ticks, with
       the share of envs that fell back to the triangle path per tick.
The last two lines: the kernels' JSON summary (launches summed over the
main-path segments, and per segment), then the device JSON.
Imports neither JAX nor the JAX package: the GPU machine has neither.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN, W_MAIN, H_MAIN = 256, 320, 200
WARMUP_TICKS, TIMED_TICKS, WINDOWS, FALLBACK_TICKS = 8, 32, 5, 4
TEX_WAD, TEX_CAP = ":texstress:", 1024  # portal_global_segs_max of the active set
TEX_WARMUP, TEX_TICKS, TEX_WINDOWS = 4, 8, 3
TIMING_CALLS = 20
BACK_TO_BACK = 10  # kernel launches per pair of CUDA events
PX_CEILING = 16  # per-frame mismatch ceiling of the verify legs (bench.py:90)
B3_REL_TOL = 1e-6
MAZE_PLAIN_ENVS = 16  # envs the plain B3 and B9 run on at the maze shape

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


def bench_actions(sim, batch):
    """bench.py's ACTIVE actions: walk forward, per-env yaw rate drawn
    from numpy's default_rng(0)."""
    rng = np.random.default_rng(0)
    look = np.stack([rng.uniform(-0.05, 0.05, batch).astype(np.float32),
                     np.zeros(batch, np.float32)], axis=1)
    acts = sim.null_actions(batch)
    return acts._replace(
        movement=torch.as_tensor(np.tile(np.array([[0.0, 1.0]], np.float32),
                                         (batch, 1)), device=sim.device),
        look=torch.as_tensor(look, device=sim.device),
    )


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


def make_sim(device="cuda", **kw):
    from tpu_doom_torch.models import DoomSim
    from tpu_doom_torch.utils.config import GameConfig, PlayerConfig

    base = dict(wad_file=":test:", width=W_MAIN, height=H_MAIN,
                batch_size=B_MAIN, raster_backend="portal",
                player=PlayerConfig(clip_substeps=4))
    base.update(kw)
    return DoomSim(GameConfig(**base), device)


def verify_ref():
    with np.load("tests/golden/verify_ref.npz") as z:
        return {k: z[k] for k in z.files}


def verify_state(sim, ref):
    s = sim.reset(ref["pos"].shape[0])
    dev = sim.device
    return s._replace(
        pos=torch.as_tensor(ref["pos"], device=dev),
        yaw=torch.as_tensor(ref["yaw"], device=dev),
        time=torch.as_tensor(ref["time"], device=dev),
        pitch=torch.as_tensor(ref["pitch"], device=dev),
        object_offset=torch.as_tensor(ref["object_offset"], device=dev),
    )


def phase_kernels(results):
    from tpu_doom_torch.ops import (
        player_move,
        player_move_ref,
        render_portal_fused,
        render_portal_fused_ref,
    )
    from tpu_doom_torch.render import portal as P
    from tpu_doom_torch.sim.collision import broadphase_rows

    sim = make_sim()
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    for _ in range(WARMUP_TICKS):
        state = sim.step(state, acts)
    pcfg = sim.config.player

    # B1 at 256 envs, clip_substeps=4.
    rows = broadphase_rows(sim.scene, state.object_offset, state.pos)
    st8 = torch.cat([state.pos, state.vel, torch.zeros_like(state.pos[:, :2])], 1)
    kw = dict(radius=pcfg.radius, height=pcfg.height, dt=sim.config.timestep,
              substeps=pcfg.clip_substeps, enable_noclip=pcfg.enable_noclip)
    got = player_move(rows, st8, **kw)
    want = player_move_ref(rows, st8, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms, b2b = kernel_ms(lambda: player_move(rows, st8, **kw))
    plain = time_ms(lambda: player_move_ref(rows, st8, **kw))
    print(f"[kernel] B1 player_move rows {tuple(rows.shape)}: max_abs_err {err}"
          f" (ceiling 0); {ms:.4f} ms ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(err == 0.0, f"B1 disagrees with its plain version: {err}")
    sweeps = player_move_sweeps(rows, st8, pcfg.radius, sim.config.timestep,
                                pcfg.clip_substeps, pcfg.enable_noclip)
    most = rows.shape[0] * (pcfg.clip_substeps + 1 + int(pcfg.enable_noclip))
    b1_bytes = nbytes(rows, st8, got)
    print(f"[bound] B1 player_move: {sweeps} sweeps these inputs need (of {most}"
          f" without the early exit) x M = {rows.shape[2]} triangles x"
          f" {SWEEP_TRI_OPS} operations = {sweeps * rows.shape[2] * SWEEP_TRI_OPS}"
          f" operations, beside {b1_bytes} bytes")
    record(results, "player_move", err, ms, b2b, plain, b1_bytes,
           sweeps * rows.shape[2] * SWEEP_TRI_OPS)

    # B2 on the port's own walk output, 256 envs at 320x200.
    args, kw, _ = P.fused_inputs(sim.portal_scene(), sim.scene, sim.config,
                                 W_MAIN, H_MAIN, state)
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc, wc))
    ms, b2b = kernel_ms(lambda: render_portal_fused(*args, **kw))
    plain = time_ms(lambda: render_portal_fused_ref(*args, **kw))
    print(f"[kernel] B2 render_portal_fused records {tuple(args[0].shape)}: "
          f"{mism} mismatched idx/cov px (ceiling 0), max_abs_err {err};"
          f" {ms:.4f} ms ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(mism == 0, f"B2 disagrees with its plain version on {mism} px")
    record(results, "render_portal_fused", err, ms, b2b, plain,
           portal_bytes(args, kw), gi.numel() * SHADE_PIXEL_OPS)
    del args, gc, wi, wc
    phase_kernels_oracle(results, state, gi)
    del gi

    # B3 and B9 on the 8 verify poses at 320x200, 3 layers.
    ref = verify_ref()
    vsim = make_sim(batch_size=8, portal_crossings=12, raster_backend="auto")
    phase_peel(results, "", "the 8 verify poses", vsim, verify_state(vsim, ref))


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


def phase_peel(results, suffix, label, sim, state, plain_envs=None):
    """B3 and B9 on the triangle path's inputs for `state` at 320x200, each
    against its plain version (where plain_envs is given, on the first
    plain_envs envs, the plain version timed once), timed beside its bound:
    the bytes of its inputs and output, or PEEL_TEST_OPS per covering
    (pixel, triangle) pair (`peel_pairs`), whichever takes longer."""
    from tpu_doom_torch.ops import (
        depth_peel,
        depth_peel_ref,
        pack_triangle_rows,
        peel_resolve,
        peel_resolve_ref,
    )
    from tpu_doom_torch.render import raster as R

    cfg = sim.config
    K = cfg.depth_layers
    trows, tattrs, grid, yb, _ = R.peel_inputs(sim.scene, cfg, W_MAIN, H_MAIN, state)
    pk = dict(tile_p=cfg.raster_tile_p, chunk_t=cfg.raster_chunk_t)
    n = plain_envs or trows.shape[0]
    plain_calls = dict(calls=1, warmup=0) if plain_envs else {}
    slice_ = f" (plain version on envs 0-{n - 1}, one timed call)" if plain_envs else ""

    def b3():
        return peel_resolve(trows, tattrs, grid, yb, K, **pk, width=W_MAIN)

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
          f" (pixel, triangle) pairs, {peel_tile_tests(trows, grid, W_MAIN)} tests after"
          " the cull")
    require(cat_ok and fin_ok and rel <= B3_REL_TOL,
            f"B3 disagrees with its plain version on {label}")
    record(results, "peel_resolve" + suffix, err, ms, b2b, plain,
           nbytes(trows, tattrs, grid, yb, got), pairs * PEEL_TEST_OPS)
    b3z = got[:, :, 0].clone()
    del got

    # B9 on the same states: the "jnp" path's unsorted 16-column rows.
    prep = R.prepare(sim.scene, cfg, W_MAIN, H_MAIN, state)
    rows16 = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    del prep

    def b9():
        return depth_peel(rows16, grid, K, width=W_MAIN)

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
          f" (pixel, triangle) pairs, {peel_tile_tests(rows16, grid, W_MAIN)} tests after"
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
    phase_peel(results, "_maze", f"{TEX_WAD} {B_MAIN // 2} pitched envs", sim, pitched,
               plain_envs=MAZE_PLAIN_ENVS)


def phase_kernels_oracle(results, state, b2_idx):
    """B7 then B8 (the `portal_jnp` configuration) on the port's own
    :test: walk at 256 envs x 320x200, from B2's state, each bitwise
    against its plain version; the chain against B2's frame is printed for
    the record (the same function at zero pitch)."""
    from tpu_doom_torch.ops import (
        classify_alpha,
        classify_alpha_ref,
        shade_portal,
        shade_portal_ref,
    )
    from tpu_doom_torch.render import portal as P

    sim = make_sim(raster_backend="portal_jnp")
    cargs, sargs, shear, _ = P.oracle_inputs(sim.portal_scene(), sim.scene,
                                             sim.config, W_MAIN, H_MAIN, state)
    ch = classify_alpha(*cargs, shear=shear)
    want = classify_alpha_ref(*cargs, shear=shear)
    torch.cuda.synchronize()
    same = bitwise_equal(ch, want)
    err = max_abs_err(ch, want)
    del want
    ms, b2b = kernel_ms(lambda: classify_alpha(*cargs, shear=shear))
    plain = time_ms(lambda: classify_alpha_ref(*cargs, shear=shear))
    print(f"[kernel] B7 classify_alpha records {tuple(cargs[0].shape)} ->"
          f" {tuple(ch.shape)}: bitwise equal {same} (ceiling 0), max_abs_err"
          f" {err}; {ms:.4f} ms ({b2b:.4f} back to back) vs plain {plain:.4f} ms")
    require(same, "B7 disagrees with its plain version")
    record(results, "classify_alpha", err, ms, b2b, plain,
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
    chain = int((gi.reshape(b2_idx.shape) != b2_idx).sum())
    print(f"[kernel] B8 shade_portal ch {tuple(ch.shape)} table"
          f" {tuple(sargs[4].shape)} hole {tuple(sargs[5].shape)}: {mism}"
          f" mismatched idx/cov px (ceiling 0), max_abs_err {err}; {ms:.4f} ms"
          f" ({b2b:.4f} back to back) vs plain {plain:.4f} ms; the chain"
          f" B7 -> B8 differs from B2 on {chain} px of this zero-pitch state")
    require(mism == 0, f"B8 disagrees with its plain version on {mism} px")
    record(results, "shade_portal", err, ms, b2b, plain,
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
    lib = time_ms(lambda: torch.scatter_add(zeros, 1, sl_idx, sl_live))
    record(results, "scatter_live", err, ms, b2b, plain, nbytes(sidx, live, got),
           library_ms=lib)

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


def fallback_sim(**kw):
    """The same DoomSim with portal_pitch="triangle" and half the envs
    pitched 0.3: every pitched env takes the triangle fallback (B3, or B9
    under portal_jnp)."""
    sim = make_sim(portal_pitch="triangle", **kw)
    state = sim.reset()
    pitch = state.pitch.clone()
    pitch[: B_MAIN // 2] = 0.3
    return sim, state._replace(pitch=pitch), bench_actions(sim, B_MAIN)


def run_ticks(sim, state, acts, ticks, fell=None):
    """`ticks` ticks of step + render -> (state, checksum, coverage sum)
    as device scalars; `fell` collects the envs that took the triangle
    fallback per tick."""
    from tpu_doom_torch.render import portal as P

    check = torch.zeros((), dtype=torch.int64, device=sim.device)
    cov_sum = torch.zeros((), dtype=torch.float64, device=sim.device)
    for _ in range(ticks):
        with captured(P, "render_frames") as fb:
            state, idx, cov = sim.step_render(state, acts)
        if fell is not None:
            fell.append(sum(int(c[2].pos.shape[0]) for c in fb))
        check += idx.sum(dtype=torch.int64)
        cov_sum += cov.sum(dtype=torch.float64)
    return state, check, cov_sum


def timed_segment(tag, label, sim, state, acts, windows, ticks, needed):
    """One main-path segment: the launch counts set to 0, `windows` timed
    windows of `ticks` ticks of step + render, the counts read. Prints
    every window, the median and min/max env*frames/s, the checksum, the
    coverage and the share of envs on the triangle fallback per tick;
    requires each `needed` kernel to have run every tick. Returns the
    launch counts."""
    reset_counts()
    check = torch.zeros((), dtype=torch.int64, device=sim.device)
    cov_sum = torch.zeros((), dtype=torch.float64, device=sim.device)
    rates, fell = [], []
    for w in range(windows):
        t0, c0 = time.perf_counter(), time.process_time()
        state, c, cs = run_ticks(sim, state, acts, ticks, fell)
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
    share = [round(f / B_MAIN, 4) for f in fell]
    print(f"[{tag}] {label}, {windows} windows of {ticks} ticks of step + render:"
          f" median {float(np.median(rates)):.1f} env*frames/s (min"
          f" {min(rates):.1f}, max {max(rates):.1f}); checksum {int(check)},"
          f" coverage {coverage:.4f}; share of envs on the triangle fallback per"
          f" tick {share}; launches {counts}")
    for name in needed:
        require(counts[name] >= windows * ticks, f"{tag}: {name} did not run every tick")
    require(int(check) > 0 and bool(torch.isfinite(state.pos).all()),
            f"{tag}: frames are all zero or the state is not finite")
    require(coverage > 0.5, f"{tag}: coverage {coverage} <= 0.5")
    return counts


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
    return counts


def phase_main(results):
    sim = make_sim()
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    state, _, _ = run_ticks(sim, state, acts, WARMUP_TICKS)
    fsim, fstate, facts = fallback_sim()
    torch.cuda.synchronize()
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    print(f"[host] {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable;"
          f" load average {load}")
    segments = {"bench": timed_segment(
        "main", f":test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs", sim, state, acts,
        WINDOWS, TIMED_TICKS, ("player_move", "render_portal_fused"))}

    segments["fallback"] = fallback_segment("fallback", fsim, fstate, facts,
                                            "peel_resolve")
    del sim, state, fsim, fstate

    # The portal_jnp configuration (B7 then B8 every frame) and its
    # fallback (the "jnp" triangle path, B9).
    sim = make_sim(raster_backend="portal_jnp")
    state = sim.reset()
    acts = bench_actions(sim, B_MAIN)
    state, _, _ = run_ticks(sim, state, acts, TEX_WARMUP)
    torch.cuda.synchronize()
    segments["oracle"] = timed_segment(
        "oracle", f":test: {W_MAIN}x{H_MAIN} x {B_MAIN} envs raster_backend=portal_jnp",
        sim, state, acts, TEX_WINDOWS, TEX_TICKS,
        ("player_move", "classify_alpha", "shade_portal"))
    del sim, state
    fsim, fstate, facts = fallback_sim(raster_backend="portal_jnp")
    segments["oracle_fallback"] = fallback_segment(
        "oracle_fallback", fsim, fstate, facts, "depth_peel")
    del fsim, fstate

    # The same two fallbacks on a maze's triangles (:texstress:).
    for seg, backend, needed in (("texstress_fallback", "portal", "peel_resolve"),
                                 ("texstress_oracle_fallback", "portal_jnp",
                                  "depth_peel")):
        fsim, fstate, facts = fallback_sim(wad_file=TEX_WAD, raster_backend=backend)
        segments[seg] = fallback_segment(seg, fsim, fstate, facts, needed)
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
        segments[seg] = timed_segment(
            seg, f"{TEX_WAD} {W_MAIN}x{H_MAIN} x {B_MAIN} envs"
            f" {extra or 'shipped defaults'}", sim, state, acts, TEX_WINDOWS,
            TEX_TICKS, needed)
        del sim, state

    for seg, c in segments.items():  # B2's global-table, B3's and B9's launches on :texstress:
        maze = seg.startswith("texstress")
        c["render_portal_fused_texstress"] = (
            c["render_portal_fused"] - c["render_portal_fused_per_env"] if maze else 0)
        c["peel_resolve_maze"] = c["peel_resolve"] if maze else 0
        c["depth_peel_maze"] = c["depth_peel"] if maze else 0
    totals = {k: sum(c[k] for c in segments.values()) for k in results}
    for name, r in results.items():
        require(name in TOOL_KERNELS or totals[name] > 0,
                f"{name} never launched on the main path")
        r.update(launches=totals[name],
                 **{f"{seg}_launches": c[name] for seg, c in segments.items()})
    return list(segments)


def main():
    phase_device()
    phase_build()
    results = {name: dict(name=name, route="cuda", **meta)
               for name, meta in KERNELS.items()}
    phase_kernels(results)
    phase_kernels_maze(results)
    phase_kernels_texstress(results)
    phase_tools(results)
    phase_goldens()
    segments = phase_main(results)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "ms_b2b", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_ms_b2b", *(f"{seg}_launches" for seg in segments))
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
