#!/usr/bin/env python3
"""Where a tick of the PyTorch port's main path spends its time.

    python3 tools/profile_tick.py                # the main cell, on CUDA
    python3 tools/profile_tick.py --wad :texstress: [--global-segs-max 1024]
    python3 tools/profile_tick.py --backend portal_jnp
    python3 tools/profile_tick.py --device cpu --batch 2 --width 64 --height 40
    python3 tools/profile_tick.py --rollout      # also the captured tick, replayed
    python3 tools/profile_tick.py --bank 5 --batch 1024 --width 640 --height 400 [--padding]
    python3 tools/profile_tick.py --bank 5 --batch 1024 --width 640 --height 400 \
        --chunks 0,128,256,512,-1

Runs `DoomSim` of `tpu_doom_torch` on `--wad` (default `:test:`, 320x200
x 256 envs, bench actions, clip_substeps=4; `--global-segs-max` lowers
portal_global_segs_max, so that a big level takes the active-set path;
`--backend portal_jnp` renders through B7 and B8 instead of B2) and
prints:
  * host-clock ms per tick of step + render, step alone, render alone and
    the walk alone (`render.portal.walk`), each the mean of --ticks calls
    that end in a synchronize;
  * a `torch.profiler` pass over --ticks ticks of step + render: device
    kernels launched and device-busy ms per tick, the device ms per tick
    of each hand-written kernel, of the walk's sort and of the captured
    tick's fallback flag (`set_condition_kernel`), then the launches and
    device ms per tick of all other kernels (PyTorch's own) and of the 15
    of them with the most device ms, and the host ms per tick spent
    blocked in the per-frame fallback flag read (`aten::item`);
  * the profiler's table of the ops with the most device time;
  * the port's spans (`tpu_doom_torch.trace`, no profiler attached) over
    --ticks more ticks: the device idle share of that one run, each
    layer's ms per tick (step, walk, raster, fallback, ...), the idle
    gaps by the host span open at their start and the counters
    (`overflow_envs`, `migrated_envs`) per tick;
  * with --rollout, the same over --ticks ticks of `DoomSim.rollout` (the
    tick captured as CUDA graphs and replayed; the capture made first):
    kernels and device-busy ms per tick, and its spans.
With --bank 5 (BASELINE config 5: E1M1, E1M2, MAP01, MAP02) or --bank 8
(bench.py's L=8 bank), --batch envs per level: the bank tick of
`tpu_doom_torch.tools.banks` (`LevelBank.step_with_exits`, then every level's render;
bank_main's actions), eager and captured as one CUDA graph, both over
the same ticks from the same state: host-clock
ms per tick, kernels and device-busy ms per tick, the hand-written
kernels' device ms, the spans of each (idle share, layers), and the
peak device memory
(`torch.cuda.max_memory_allocated`) eager and after the capture; with
--padding also each level's render in the bank against the same envs
rendered by a DoomSim of that level alone (device-busy ms). With
--chunks, for each `render_env_chunk` value (0 = one piece, -1 = AUTO),
in a process of its own (a capture that runs out of memory leaves the
allocator unusable): the device-busy ms and peak memory of one level's
render (MAP01), eager, and the device ms per replayed bank tick
(CUDA events) and the peak memory with the tick captured; then the
table of them all.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_doom_torch.tools.fixtures import action_seq, capture_bank_tick, make_sim  # noqa: E402
from tpu_doom_torch.bench import bank_actions, bank_tick, bench_actions  # noqa: E402
from tpu_doom_torch.tools.banks import BANK5, BANK8, make_bank  # noqa: E402
from tpu_doom_torch.render import portal as P  # noqa: E402
from tpu_doom_torch import trace  # noqa: E402

# Substrings of the profiler's kernel names. "render_portal_kernel" also
# names B2's stage-budget instantiations (render_portal_kernel<mask>), but
# only the production one, <0>, runs on the main path: the others are
# launched by tpu_doom_torch/tools/kernelbudget.py alone. "set_condition_kernel"
# sets the captured tick's fallback flag (csrc/graph_while.cu).
KERNEL_NAMES = ("player_move_kernel", "render_portal_kernel",
                "peel_resolve_kernel", "select_rows_kernel",
                "scatter_live", "gather_cells_kernel", "classify_alpha_kernel",
                "shade_portal_kernel", "depth_peel_kernel", "walk_table_kernel",
                "walk_cross_kernel", "walk_records_kernel", "radixSort",
                "set_condition_kernel")
TOP_OTHERS = 15  # the other kernels `report` lists, by device ms per tick
# The spans `span_report` prints, outermost first (tpu_doom_torch/trace.py).
LAYERS = ("tick", "actions", "step", "effects", "player", "triggers", "migrate", "render",
          "walk", "raster", "fallback", "frames")


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
    ap.add_argument("--bank", type=int, choices=(5, 8), default=None,
                    help="profile the bank tick of config 5 or of the L=8 bank instead")
    ap.add_argument("--chunk", type=int, default=-1, help="render_env_chunk of --bank")
    ap.add_argument("--chunks", default=None,
                    help="with --bank: comma-separated render_env_chunk values to sweep")
    ap.add_argument("--padding", action="store_true",
                    help="with --bank: also each level's render in the bank against alone")
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.bank and args.chunks:
        return sweep_chunks(args, argv if argv is not None else sys.argv[1:])
    if args.bank and args.probe:
        return probe_chunk(args, dev)
    if args.bank:
        return profile_bank(args, dev)

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
    busy_ms = report("profile", prof, n)
    avg = {e.key: e for e in prof.key_averages()}
    item = avg.get("aten::item")
    blocked = item.cpu_time_total / 1e3 / n if item else 0.0
    print(f"[profile] host blocked in aten::item (fallback flag read):"
          f" {blocked:.4f} ms/tick over {item.count if item else 0} calls")
    print(prof.key_averages().table(sort_by="self_device_time_total"
                                    if dev.type == "cuda" else
                                    "self_cpu_time_total", row_limit=20))

    def traced_tick():
        with trace.span("tick"):
            tick()

    span_report("profile", traced_tick, n, n, dev)
    if args.rollout:
        with torch.no_grad():
            seq = action_seq(acts, n)
            sim.rollout(box[0], seq, n)  # captures the graphs
            sync(dev)
            t_roll = ms_per_call(lambda: sim.rollout(box[0], seq, n), dev, 3) / n
            prof = profile(lambda: sim.rollout(box[0], seq, n), 1, dev)
            roll_busy = report("rollout", prof, n)
            span_report("rollout", lambda: sim.rollout(box[0], seq, n), 1, n, dev)
        print(f"[rollout] graph against eager, {n} ticks each: ms/tick {t_roll:.4f} vs"
              f" {t_tick:.4f} ({t_tick / t_roll:.3f}x); device busy {roll_busy:.4f} vs"
              f" {busy_ms:.4f} ms/tick")
    return 0


def _bank(args, dev):
    bank = make_bank(BANK5 if args.bank == 5 else BANK8, dev, width=args.width,
                     height=args.height, render_env_chunk=args.chunk)
    L, E = bank.num_levels, args.batch
    state = bank.reset(E)
    active = torch.ones((L, E), dtype=torch.bool, device=dev)
    return bank, state, active, bank_actions(L, E, dev)


def _gib(n):
    return n / 2**30


def profile_bank(args, dev):
    """Eager and replayed bank ticks: time, kernels, busy ms, memory."""
    bank, state, active, acts = _bank(args, dev)
    L, E, n = bank.num_levels, args.batch, args.ticks
    tick = bank_tick(bank, args.width, args.height)
    box = [(state, active)]

    def eager():
        box[0], _ = tick(box[0], acts)

    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.warmup):
        eager()
    # Every timing and profile starts from the same state, so that all
    # cover the same ticks (the fallback's load changes along them).
    start = (type(box[0][0])(*(x.clone() for x in box[0][0])), box[0][1].clone())

    def restart():
        box[0] = (type(start[0])(*(x.clone() for x in start[0])), start[1].clone())

    t_eager = ms_per_call(eager, dev, n)
    eager_peak = torch.cuda.max_memory_allocated()
    restart()
    prof = profile(eager, n, dev)
    label = f"bank{args.bank} {L}x{E} {args.width}x{args.height} chunk {args.chunk}"
    busy = report(f"{label} eager", prof, n)
    restart()
    span_report(f"{label} eager", eager, n, n, dev)
    graph = capture_bank_tick(bank, *start, acts, args.width, args.height)
    leaves = [*graph.state_buf[0], graph.state_buf[1]]
    t_graph = ms_per_call(graph.replay, dev, n)
    torch._foreach_copy_(leaves, [*start[0], start[1]])
    prof = profile(graph.replay, n, dev)
    gbusy = report(f"{label} graph", prof, n)
    torch._foreach_copy_(leaves, [*start[0], start[1]])
    span_report(f"{label} graph", graph.replay, n, n, dev)
    print(f"[bank] {label}: ms/tick eager {t_eager:.4f}, replayed {t_graph:.4f}"
          f" ({t_eager / t_graph:.3f}x); env*frames/s {L * E * 1e3 / t_eager:.1f} eager,"
          f" {L * E * 1e3 / t_graph:.1f} replayed; device busy {busy:.4f} vs {gbusy:.4f}"
          f" ms/tick; peak device memory {_gib(eager_peak):.2f} GiB eager,"
          f" {_gib(torch.cuda.max_memory_allocated()):.2f} GiB with the graph")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    del graph
    if args.padding:
        padding_cost(bank, box[0][0], args, dev)
    return 0


def padding_cost(bank, state, args, dev):
    """What the bank's padding costs: each level's render in the bank
    against the same envs rendered by a DoomSim of that level alone,
    device-busy ms each (eager, torch.profiler)."""
    from tpu_doom_torch.render import render_dispatch
    from tpu_doom_torch.sim.state import SimState

    specs = BANK5 if args.bank == 5 else BANK8
    n = args.ticks
    for lv, (wad, level) in enumerate(specs):
        one = SimState(*(x[lv] for x in state))
        scene, pscene = bank._at(bank.scenes, lv), bank._at(bank.pscenes, lv)
        sim = make_sim(dev, wad_file=wad, initial_level_index=level, batch_size=args.batch,
                       width=args.width, height=args.height, render_env_chunk=args.chunk)
        busy = []
        for fn in (lambda: render_dispatch(scene, pscene, bank.cfg, one, args.width,
                                           args.height),
                   lambda: sim.render(one)):
            fn()
            prof = profile(fn, n, dev)
            busy.append(sum(e.time_range.elapsed_us() for e in device_events(prof)) / 1e3 / n)
        rows = sim.portal_scene()["has_back"].shape[0]
        print(f"[pad] {wad} level {level}: render in the bank ({bank.pscenes['has_back'].shape[1]}"
              f" walk rows) {busy[0]:.4f} device-busy ms, alone ({rows} rows) {busy[1]:.4f}:"
              f" {busy[0] / busy[1]:.3f}x")
        del sim


def probe_chunk(args, dev):
    """One chunk value: one level's render eager, then the captured bank
    tick; prints one JSON line (an out-of-memory stage says so)."""
    from tpu_doom_torch.render import env_chunk

    bank, state, active, acts = _bank(args, dev)
    out = dict(chunk=args.chunk, resolved=env_chunk(bank.cfg, args.batch, args.width,
                                                    args.height))
    lv = min(2, bank.num_levels - 1)  # MAP01: the most walk rows of config 5
    one = bank._at(state, lv)
    scene, pscene = bank._at(bank.scenes, lv), bank._at(bank.pscenes, lv)
    from tpu_doom_torch.render import render_dispatch

    def render():
        render_dispatch(scene, pscene, bank.cfg, one, args.width, args.height)

    try:
        sync(dev)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        render()
        sync(dev)
        out["render_peak_gib"] = _gib(torch.cuda.max_memory_allocated() - base)
        out["render_ms_wall"] = ms_per_call(render, dev, args.ticks)
        prof = profile(render, args.ticks, dev)
        out["render_busy_ms"] = sum(e.time_range.elapsed_us() for e in
                                    device_events(prof)) / 1e3 / args.ticks
        del prof
    except torch.cuda.OutOfMemoryError as exc:
        out["render_oom"] = str(exc).splitlines()[0]
        print(json.dumps(out))
        return 0
    try:
        sync(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        graph = capture_bank_tick(bank, state, active, acts, args.width, args.height)
        sync(dev)
        out["graph_peak_gib"] = _gib(torch.cuda.max_memory_allocated() - base)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.ticks):
            graph.replay()
        end.record()
        sync(dev)
        out["tick_ms"] = start.elapsed_time(end) / args.ticks
    except (torch.cuda.OutOfMemoryError, RuntimeError) as exc:
        out["graph_oom"] = str(exc).splitlines()[0]
    print(json.dumps(out))
    return 0


def sweep_chunks(args, argv):
    """Run probe_chunk for each --chunks value in a process of its own."""
    base, skip = [], False
    for a in argv:  # argv without --chunks VALUE and --chunk VALUE
        if skip:
            skip = False
            continue
        if a in ("--chunks", "--chunk"):
            skip = True
            continue
        if a.startswith(("--chunks=", "--chunk=")):
            continue
        base.append(a)
    rows = []
    for c in (int(x) for x in args.chunks.split(",")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *base,
                               "--chunk", str(c), "--probe"],
                              capture_output=True, text=True, timeout=1800)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        row = json.loads(lines[-1]) if lines else dict(
            chunk=c, error=(proc.stderr.strip().splitlines() or ["no output"])[-1])
        print(f"[chunks] {json.dumps(row)}")
        rows.append(row)
    L = 4 if args.bank == 5 else 8
    print(f"[chunks] bank{args.bank} {L} x {args.batch} envs at {args.width}x{args.height}:"
          " chunk (resolved) | one level's render: busy ms, wall ms, peak GiB |"
          " replayed bank tick: device ms, peak GiB")
    for r in rows:
        print(f"[chunks] {r.get('chunk')} ({r.get('resolved')}) | {r.get('render_busy_ms')},"
              f" {r.get('render_ms_wall')}, {r.get('render_peak_gib')} | {r.get('tick_ms')},"
              f" {r.get('graph_peak_gib')} {r.get('render_oom') or r.get('graph_oom') or r.get('error') or ''}")
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


def span_report(tag, fn, calls, ticks, dev):
    """The port's spans over `calls` calls of fn (`ticks` ticks in all),
    after one call that captures the traced twins of any graph: the device
    idle share of that one run, each layer's ms per tick, the idle gaps
    by the host span open at their start and the counters per tick."""
    trace.enable(dev)
    try:
        with torch.no_grad():
            fn()
            sync(dev)
            trace.reset()
            for _ in range(calls):
                fn()
            rec = trace.spans()
            counts = trace.counts()
    finally:
        trace.disable()
    idle = rec.idle_share()
    print(f"[{tag}] spans: {rec.last_tick - rec.first_tick + 1} ticks, device idle share"
          f" {'none' if idle is None else f'{idle:.3f} %'} (clock error bound"
          f" {rec.error_ns} ns)")
    for name in LAYERS:
        ms = rec.total_ms(name)
        if ms:
            print(f"[{tag}] span {name}: {ms / ticks:.4f} ms per tick")
    gaps = ", ".join(f"{k} {v / ticks:.4f}" for k, v in sorted(rec.gaps().items(),
                                                             key=lambda kv: -kv[1]))
    print(f"[{tag}] idle gaps by the host span open at their start, ms per tick:"
          f" {gaps or 'none'}")
    print(f"[{tag}] counts per tick: " + ", ".join(f"{k} {v / ticks:.4f}"
                                                 for k, v in counts.items()))


def report(tag, prof, n):
    """Print kernels and device-busy ms per tick over n ticks; returns the
    busy ms per tick."""
    kernels = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    print(f"[{tag}] {len(kernels) / n:.1f} device kernels per tick,"
          f" device busy {busy_ms:.4f} ms/tick")
    for name in KERNEL_NAMES:
        ev = [e for e in kernels if name in e.name]
        ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n
        print(f"[{tag}] {name}: {len(ev) / n:.2f} launches, {ms:.4f} device"
              f" ms per tick")
    # The rest: PyTorch's own kernels (and the library's), by name.
    others: dict = {}
    for e in kernels:
        if not any(name in e.name for name in KERNEL_NAMES):
            n_us = others.setdefault(e.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
    rest_ms = sum(us for _, us in others.values()) / 1e3 / n
    print(f"[{tag}] other kernels: {sum(c for c, _ in others.values()) / n:.1f} launches,"
          f" {rest_ms:.4f} device ms per tick; the {TOP_OTHERS} with the most:")
    for name, (count, us) in sorted(others.items(), key=lambda kv: -kv[1][1])[:TOP_OTHERS]:
        print(f"[{tag}]   {count / n:8.2f} launches, {us / 1e3 / n:.4f} ms per tick:"
              f" {name[:140]}")
    return busy_ms

if __name__ == "__main__":
    sys.exit(main())
