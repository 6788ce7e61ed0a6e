#!/usr/bin/env python3
"""Where a tick of the PyTorch port's main path spends its time.

    python3 tools/profile_tick.py                # the main cell, on CUDA
    python3 tools/profile_tick.py --wad :texstress: [--global-segs-max 1024]
    python3 tools/profile_tick.py --backend portal_jnp
    python3 tools/profile_tick.py --device cpu --batch 2 --width 64 --height 40
    python3 tools/profile_tick.py --rollout      # also the captured tick, replayed

Runs `DoomSim` of `tpu_doom_torch` on `--wad` (default `:test:`, 320x200
x 256 envs, bench actions, clip_substeps=4; `--global-segs-max` lowers
portal_global_segs_max, so that a big level takes the active-set path;
`--backend portal_jnp` renders through B7 and B8 instead of B2) and
prints:
  * host-clock ms per tick of step + render, step alone, render alone and
    the walk alone (`render.portal.walk`), each the mean of --ticks calls
    that end in a synchronize;
  * a `torch.profiler` pass over --ticks ticks of step + render: device
    kernels launched and device-busy ms per tick, the idle share against
    the unprofiled step + render time, the device ms per tick of each
    hand-written kernel, of the walk's sort and of the captured tick's
    fallback flag (`set_if_kernel`), and the host ms per tick
    spent blocked in the per-frame fallback flag read (`aten::item`);
  * the profiler's table of the ops with the most device time;
  * with --rollout, the same over --ticks ticks of `DoomSim.rollout` (the
    tick captured as CUDA graphs and replayed; the capture made first):
    kernels and device-busy ms per tick and the idle share, beside the
    eager tick's, from this one process.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import action_seq, bench_actions, make_sim  # noqa: E402
from tpu_doom_torch.render import portal as P  # noqa: E402

# Substrings of the profiler's kernel names. "render_portal_kernel" also
# names B2's stage-budget instantiations (render_portal_kernel<mask>), but
# only the production one, <0>, runs on the main path: the others are
# launched by tpu_doom_torch/tools/kernelbudget.py alone. "set_if_kernel"
# sets the captured tick's fallback flag (csrc/graph_if.cu).
KERNEL_NAMES = ("player_move_kernel", "render_portal_kernel",
                "peel_resolve_kernel", "select_rows_kernel",
                "scatter_live", "gather_cells_kernel", "classify_alpha_kernel",
                "shade_portal_kernel", "depth_peel_kernel", "radixSort",
                "set_if_kernel")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def ms_per_call(fn, device, n):
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--wad", default=":test:")
    ap.add_argument("--global-segs-max", type=int, default=None)
    ap.add_argument("--backend", default="portal", choices=("portal", "portal_jnp"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--rollout", action="store_true",
                    help="also profile --ticks ticks of DoomSim.rollout (captured, replayed)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    extra = {}
    if args.global_segs_max is not None:
        extra["portal_global_segs_max"] = args.global_segs_max
    sim = make_sim(dev, wad_file=args.wad, batch_size=args.batch,
                   width=args.width, height=args.height,
                   raster_backend=args.backend, **extra)
    state = sim.reset()
    acts = bench_actions(sim, args.batch)
    with torch.no_grad():
        for _ in range(args.warmup):
            state, _, _ = sim.step_render(state, acts)
        sync(dev)

        box = [state]

        def tick():
            box[0], _, _ = sim.step_render(box[0], acts)

        pscene, cfg = sim.portal_scene(), sim.config
        n = args.ticks
        t_tick = ms_per_call(tick, dev, n)
        t_step = ms_per_call(lambda: sim.step(state, acts), dev, n)
        t_render = ms_per_call(lambda: sim.render(state), dev, n)
        act = P.active_segs(pscene, cfg)
        t_walk = ms_per_call(
            lambda: P.walk(pscene, sim.scene, cfg, args.width, args.height,
                           int(cfg.portal_crossings), state, act), dev, n)
        print(f"[split] {args.wad} {args.backend} active_segs {act}: ms/tick: step+render"
              f" {t_tick:.4f}, step {t_step:.4f}, render {t_render:.4f}, of"
              f" which walk {t_walk:.4f} (host clock, mean of {n})")

        prof = profile(tick, n, dev)
    busy_ms = report("profile", prof, n, t_tick)
    avg = {e.key: e for e in prof.key_averages()}
    item = avg.get("aten::item")
    blocked = item.cpu_time_total / 1e3 / n if item else 0.0
    print(f"[profile] host blocked in aten::item (fallback flag read):"
          f" {blocked:.4f} ms/tick over {item.count if item else 0} calls")
    print(prof.key_averages().table(sort_by="self_device_time_total"
                                    if dev.type == "cuda" else
                                    "self_cpu_time_total", row_limit=20))
    if args.rollout:
        with torch.no_grad():
            seq = action_seq(acts, n)
            sim.rollout(box[0], seq, n)  # captures the graphs
            sync(dev)
            t_roll = ms_per_call(lambda: sim.rollout(box[0], seq, n), dev, 3) / n
            prof = profile(lambda: sim.rollout(box[0], seq, n), 1, dev)
        roll_busy = report("rollout", prof, n, t_roll)
        print(f"[rollout] graph against eager, {n} ticks each: ms/tick {t_roll:.4f} vs"
              f" {t_tick:.4f} ({t_tick / t_roll:.3f}x); device busy {roll_busy:.4f} vs"
              f" {busy_ms:.4f} ms/tick; idle share {1.0 - roll_busy / t_roll:.4f} vs"
              f" {1.0 - busy_ms / t_tick:.4f}")
    return 0


def device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile(fn, calls, dev):
    """torch.profiler over `calls` calls of fn, ending in a synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        sync(dev)
    return prof


def report(tag, prof, n, t_tick):
    """Print kernels and device-busy ms per tick over n ticks, and the idle
    share against the unprofiled t_tick; returns the busy ms per tick."""
    kernels = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    print(f"[{tag}] {len(kernels) / n:.1f} device kernels per tick,"
          f" device busy {busy_ms:.4f} ms/tick, idle share"
          f" {1.0 - busy_ms / t_tick:.4f} of the unprofiled {t_tick:.4f} ms")
    for name in KERNEL_NAMES:
        ev = [e for e in kernels if name in e.name]
        ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n
        print(f"[{tag}] {name}: {len(ev) / n:.2f} launches, {ms:.4f} device"
              f" ms per tick")
    return busy_ms

if __name__ == "__main__":
    sys.exit(main())
