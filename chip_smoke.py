#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`tpu_doom_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: nvcc builds csrc/*.cu for sm_90a from the checkout (one nvcc
     per source, in parallel).
  3. kernels: each kernel against its plain PyTorch version on the card at
     main-path shapes, with error ceilings, and both timed. On :test:
     (B1: 256 envs; B2: 256 envs at 320x200; B3: 8 envs at 320x200, 3
     layers); on :texstress: at 320x200 x 256 envs after 8 bench ticks,
     from the port's own walk: B4 at shipped defaults, B6, B5 and B2's
     per-env mode with portal_global_segs_max=1024 (all bitwise).
  4. goldens: the triangle path (B3) against tests/golden/frames.npz at
     160x100, the portal path (B2) on the 8 verify poses at 320x200
     against tests/golden/verify_ref.npz, and the 8 :texstress: states of
     tests/golden/verify_texstress_ref.npz at 320x200 in both configs
     (both made by the JAX package).
  5. main path: every segment runs with the launch counts set to 0 just
     before it and read just after:
     bench: DoomSim on :test: at 320x200 x 256 envs, bench actions, 8
       warm-up ticks, then 5 windows of 32 timed ticks of step + render;
       env*frames/s per window, their median and spread, and the
       process's CPU ms per tick beside the wall ms;
     fallback: 4 ticks with portal_pitch="triangle" and half the envs
       pitched, so the triangle path (B3) runs inside the main path (the
       bench trajectory never overflows the crossing budget);
     texstress, texstress_act: DoomSim on :texstress: at 320x200 x 256
       envs, bench actions, at shipped defaults (the big-level walk with
       B4) and with portal_global_segs_max=1024 (the active-set path: B6,
       B5, B2 per env); 4 warm-up ticks, then 3 windows of 8 ticks, with
       the share of envs that fell back to the triangle path per tick.
The last two lines: the kernels' JSON summary (launches summed over the
main-path segments, and per segment), then the device JSON.
Imports no JAX: the GPU machine has none.
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
PX_CEILING = 16  # per-frame mismatch ceiling of the verify legs (bench.py:90)
B3_REL_TOL = 1e-6

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
    # B2 reading per-env active tables (raster_pallas.py:854, per_env_tex).
    "render_portal_fused_per_env": dict(
        source="tpu_doom_torch/csrc/render_portal.cu",
        replaces="tpu_doom/ops/raster_pallas.py:854"),
}


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


def time_ms(fn):
    """Median milliseconds of TIMING_CALLS calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    from tpu_doom.utils.config import GameConfig, PlayerConfig

    from tpu_doom_torch.models import DoomSim

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
        peel_resolve,
        peel_resolve_ref,
        player_move,
        player_move_ref,
        render_portal_fused,
        render_portal_fused_ref,
    )
    from tpu_doom_torch.render import portal as P
    from tpu_doom_torch.render import raster as R
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
    ms = time_ms(lambda: player_move(rows, st8, **kw))
    plain = time_ms(lambda: player_move_ref(rows, st8, **kw))
    print(f"[kernel] B1 player_move rows {tuple(rows.shape)}: max_abs_err {err}"
          f" (ceiling 0); {ms:.4f} ms vs plain {plain:.4f} ms")
    require(err == 0.0, f"B1 disagrees with its plain version: {err}")
    results["player_move"].update(max_abs_err=err, ms=ms, plain_ms=plain)

    # B2 on the port's own walk output, 256 envs at 320x200.
    args, kw, _ = P.fused_inputs(sim.portal_scene(), sim.scene, sim.config,
                                 W_MAIN, H_MAIN, state)
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc, wc))
    ms = time_ms(lambda: render_portal_fused(*args, **kw))
    plain = time_ms(lambda: render_portal_fused_ref(*args, **kw))
    print(f"[kernel] B2 render_portal_fused records {tuple(args[0].shape)}: "
          f"{mism} mismatched idx/cov px (ceiling 0), max_abs_err {err};"
          f" {ms:.4f} ms vs plain {plain:.4f} ms")
    require(mism == 0, f"B2 disagrees with its plain version on {mism} px")
    results["render_portal_fused"].update(max_abs_err=err, ms=ms, plain_ms=plain)
    del args, gi, gc, wi, wc

    # B3 on the 8 verify poses at 320x200, 3 layers.
    ref = verify_ref()
    vsim = make_sim(batch_size=8, portal_crossings=12, raster_backend="auto")
    tcfg = vsim.config
    trows, tattrs, grid, yb, _ = R.peel_inputs(
        vsim.scene, tcfg, W_MAIN, H_MAIN, verify_state(vsim, ref))
    pk = dict(tile_p=tcfg.raster_tile_p, chunk_t=tcfg.raster_chunk_t)
    n_layers = tcfg.depth_layers
    got = peel_resolve(trows, tattrs, grid, yb, n_layers, **pk)
    want = peel_resolve_ref(trows, tattrs, grid, yb, n_layers, **pk)
    torch.cuda.synchronize()
    cat_ok = all(torch.equal(got[:, :, c], want[:, :, c]) for c in (11, 12, 13))
    fl = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    g, w = got[:, :, fl].double(), want[:, :, fl].double()
    fin = torch.isfinite(w)
    fin_ok = torch.equal(torch.isfinite(g), fin) and torch.equal(g[~fin], w[~fin])
    rel = float(((g - w).abs() / w.abs().clamp_min(1e-30))[fin].max())
    err = max_abs_err(got, want)
    ms = time_ms(lambda: peel_resolve(trows, tattrs, grid, yb, n_layers, **pk))
    plain = time_ms(lambda: peel_resolve_ref(trows, tattrs, grid, yb, n_layers, **pk))
    print(f"[kernel] B3 peel_resolve rows {tuple(trows.shape)} P={grid.shape[1]}"
          f" K={n_layers}: has/pass/transparent equal {cat_ok}, float max rel err"
          f" {rel} (ceiling {B3_REL_TOL}), max_abs_err {err}; {ms:.4f} ms vs"
          f" plain {plain:.4f} ms")
    require(cat_ok and fin_ok and rel <= B3_REL_TOL,
            "B3 disagrees with its plain version")
    results["peel_resolve"].update(max_abs_err=err, ms=ms, plain_ms=plain)


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
    with captured(P, "select_rows") as calls:
        P.fused_inputs(sim.portal_scene(), sim.scene, sim.config, W_MAIN, H_MAIN, state)
    require(len(calls) == 1, f"the :texstress: walk called B4 {len(calls)} times, not once")
    idx, tab = calls[0]
    got, want = select_rows(idx, tab), select_rows_ref(idx, tab)
    torch.cuda.synchronize()
    same = bitwise_equal(got, want)
    err = max_abs_err(got, want)
    ms = time_ms(lambda: select_rows(idx, tab))
    plain = time_ms(lambda: select_rows_ref(idx, tab))
    print(f"[kernel] B4 select_rows idx {tuple(idx.shape)} table {tuple(tab.shape)}"
          f" -> {tuple(got.shape)}: bitwise equal {same} (ceiling 0), max_abs_err"
          f" {err}; {ms:.4f} ms vs plain {plain:.4f} ms")
    require(same, "B4 disagrees with its plain version")
    results["select_rows"].update(max_abs_err=err, ms=ms, plain_ms=plain)
    del calls, idx, tab, got, want, sim

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
    ms = time_ms(lambda: scatter_live(sidx, live, n_rows))
    plain = time_ms(lambda: scatter_live_ref(sidx, live, n_rows))
    print(f"[kernel] B6 scatter_live idx {tuple(sidx.shape)} -> ({sidx.shape[0]},"
          f" {n_rows}): bitwise equal {same} (ceiling 0), max_abs_err {err},"
          f" {int(want.sum())} live crossings; {ms:.4f} ms vs plain {plain:.4f} ms")
    require(same, "B6 disagrees with its plain version")
    results["scatter_live"].update(max_abs_err=err, ms=ms, plain_ms=plain)

    meta, tex_full, act = gc[0]
    got, want = gather_cells(meta, tex_full, act), gather_cells_ref(meta, tex_full, act)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = max_abs_err(got, want)
    ms = time_ms(lambda: gather_cells(meta, tex_full, act))
    plain = time_ms(lambda: gather_cells_ref(meta, tex_full, act))
    print(f"[kernel] B5 gather_cells meta {tuple(meta.shape)} table"
          f" {tuple(tex_full.shape)} -> {tuple(got.shape)}: equal {same} (ceiling 0),"
          f" max_abs_err {err}, {int(meta[..., 2].sum()) * 8} rows copied,"
          f" {int(overflow.sum())} envs over the active budget; {ms:.4f} ms vs"
          f" plain {plain:.4f} ms")
    require(same, "B5 disagrees with its plain version")
    results["gather_cells"].update(max_abs_err=err, ms=ms, plain_ms=plain)
    del sl, gc, sidx, live, meta, tex_full, got, want

    require(args[6].dim() == 3, "B2 is not in its per-env mode on the active set")
    gi, gc_ = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    mism = int((gi != wi).sum()) + int((gc_ != wc).sum())
    err = max(max_abs_err(gi, wi), max_abs_err(gc_, wc))
    ms = time_ms(lambda: render_portal_fused(*args, **kw))
    plain = time_ms(lambda: render_portal_fused_ref(*args, **kw))
    print(f"[kernel] B2 render_portal_fused per-env tables {tuple(args[6].shape)}"
          f" records {tuple(args[0].shape)}: {mism} mismatched idx/cov px"
          f" (ceiling 0), max_abs_err {err}; {ms:.4f} ms vs plain {plain:.4f} ms")
    require(mism == 0, f"B2 per-env disagrees with its plain version on {mism} px")
    results["render_portal_fused_per_env"].update(max_abs_err=err, ms=ms, plain_ms=plain)


GOLDEN_SCENARIOS = {
    # tests/golden/regen.py:22-36: pos, yaw, pitch, time, door offset.
    "start": (None, None, None, None, 0.0),
    "big_room": ([-2.2, 0.2, -8.8], 0.9, 0.3, 1.25, 0.0),
    "door_half_open": ([-2.56, 0.33, -5.4], None, None, None, 0.5),
    "grate": ([-3.5, 1.0, -9.0], None, None, 0.4, 0.0),
}


def phase_goldens():
    sim = make_sim(batch_size=1, raster_backend="auto")
    with np.load("tests/golden/frames.npz") as z:
        golden = {k: z[k] for k in z.files}
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
        print(f"[golden] triangle path {name} 160x100: {n} px differ, "
              f"coverage equal {cov_eq} (ceiling {PX_CEILING})")
        require(cov_eq and n <= PX_CEILING, f"golden {name} failed")

    ref = verify_ref()
    vsim = make_sim(batch_size=8, portal_crossings=12)
    idx, cov = vsim.render(verify_state(vsim, ref))
    idx, cov = idx.cpu().numpy(), cov.cpu().numpy()
    for i in range(idx.shape[0]):
        n = int((idx[i] != ref["idx"][i]).sum())
        nc = int((cov[i] != ref["cov"][i]).sum())
        print(f"[golden] portal path verify pose {i} 320x200: {n} px, {nc} cov"
              f" differ from JAX portal_jnp (ceiling {PX_CEILING})")
        require(n <= PX_CEILING and nc <= PX_CEILING, f"verify pose {i} failed")

    # :texstress: (the big-level walk), 8 states, both texel-table paths.
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
                         dict(portal_global_segs_max=TEX_CAP))):
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


def fallback_sim():
    """The same DoomSim with portal_pitch="triangle" and half the envs
    pitched 0.3: every pitched env takes the triangle fallback (B3)."""
    sim = make_sim(portal_pitch="triangle")
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
    from tpu_doom_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
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
    counts = launch_counts()
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


def phase_main(results):
    from tpu_doom_torch.ops import launch_counts, reset_launch_counts

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

    reset_launch_counts()
    fstate, _, fcov = run_ticks(fsim, fstate, facts, FALLBACK_TICKS)
    torch.cuda.synchronize()
    fallback = segments["fallback"] = launch_counts()
    fcoverage = float(fcov) / (FALLBACK_TICKS * B_MAIN * W_MAIN * H_MAIN)
    print(f"[fallback] portal_pitch=triangle, {B_MAIN // 2} envs pitched 0.3,"
          f" {FALLBACK_TICKS} ticks: launches {fallback}, coverage"
          f" {fcoverage:.4f}")
    require(fallback["peel_resolve"] > 0, "B3 did not run in the fallback")
    require(fcoverage > 0.5, f"fallback coverage {fcoverage} <= 0.5")
    del sim, state, fsim, fstate

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

    totals = {k: sum(c[k] for c in segments.values()) for k in results}
    for name, r in results.items():
        require(totals[name] > 0, f"{name} never launched on the main path")
        r.update(launches=totals[name],
                 **{f"{seg}_launches": c[name] for seg, c in segments.items()})
    return list(segments)


def main():
    phase_device()
    phase_build()
    results = {name: dict(name=name, route="cuda", **meta)
               for name, meta in KERNELS.items()}
    phase_kernels(results)
    phase_kernels_texstress(results)
    phase_goldens()
    segments = phase_main(results)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", *(f"{seg}_launches" for seg in segments))
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
