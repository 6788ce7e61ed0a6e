#!/usr/bin/env python3
"""Where a tick of the PyTorch port's main path spends its time.

    python3 tools/profile_tick.py                # the main cell, on CUDA
    python3 tools/profile_tick.py --wad :texstress: [--global-segs-max 1024]
    python3 tools/profile_tick.py --device cpu --batch 2 --width 64 --height 40

Runs `DoomSim` of `tpu_doom_torch` on `--wad` (default `:test:`, 320x200
x 256 envs, bench actions, clip_substeps=4; `--global-segs-max` lowers
portal_global_segs_max, so that a big level takes the active-set path)
and prints:
  * host-clock ms per tick of step + render, step alone, render alone and
    the walk alone (`render.portal.walk`), each the mean of --ticks calls
    that end in a synchronize;
  * a `torch.profiler` pass over --ticks ticks of step + render: device
    kernels launched and device-busy ms per tick, the idle share against
    the unprofiled step + render time, the device ms per tick of each
    hand-written kernel and of the walk's sort, and the host ms per tick
    spent blocked in the per-frame fallback flag read (`aten::item`);
  * the profiler's table of the ops with the most device time.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import bench_actions, make_sim  # noqa: E402
from tpu_doom_torch.render import portal as P  # noqa: E402

KERNEL_NAMES = ("player_move_kernel", "render_portal_kernel",
                "peel_resolve_kernel", "select_rows_kernel",
                "scatter_live", "gather_cells_kernel", "radixSort")


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
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=8)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    extra = {}
    if args.global_segs_max is not None:
        extra["portal_global_segs_max"] = args.global_segs_max
    sim = make_sim(dev, wad_file=args.wad, batch_size=args.batch,
                   width=args.width, height=args.height, **extra)
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
        print(f"[split] {args.wad} active_segs {act}: ms/tick: step+render"
              f" {t_tick:.4f}, step {t_step:.4f}, render {t_render:.4f}, of"
              f" which walk {t_walk:.4f} (host clock, mean of {n})")

        acts_ = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts_.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts_) as prof:
            for _ in range(n):
                tick()
            sync(dev)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    print(f"[profile] {len(kernels) / n:.1f} device kernels per tick,"
          f" device busy {busy_ms:.4f} ms/tick, idle share"
          f" {1.0 - busy_ms / t_tick:.4f} of the unprofiled {t_tick:.4f} ms")
    for name in KERNEL_NAMES:
        ev = [e for e in kernels if name in e.name]
        ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n
        print(f"[profile] {name}: {len(ev) / n:.2f} launches, {ms:.4f} device"
              f" ms per tick")
    avg = {e.key: e for e in prof.key_averages()}
    item = avg.get("aten::item")
    blocked = item.cpu_time_total / 1e3 / n if item else 0.0
    print(f"[profile] host blocked in aten::item (fallback flag read):"
          f" {blocked:.4f} ms/tick over {item.count if item else 0} calls")
    print(prof.key_averages().table(sort_by="self_device_time_total"
                                    if dev.type == "cuda" else
                                    "self_cpu_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
