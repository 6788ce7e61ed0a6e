"""The span window of a traced run: agent steps with the port's own
tracing on (`tpu_doom_torch.trace`: device-clock stamps inside the
captured ticks, no profiler attached), run once, after the readers of the
metrics before it, and cached on the context for the span metrics.

The window: `trace.enable()`; two agent steps through the program, which
capture the traced twins of its graphs; the spans and counters reset;
max(the traced window's agent steps, MIN_STEPS) agent steps (CPU_STEPS on
the CPU, none but in the CPU rehearsal), nothing else issued between them; a synchronize; the spans,
the counters and the fallback's block runs (`ops.launch_counts`, zeroed
after the timed window's were read) read; `trace.disable()`. A program without `trace` gives nothing
(each span metric is then left out of the line).

What the window reads (`window`), each from the spans of its agent steps:
  device_idle_share   100 x the time inside none of the program's
                      outermost spans (on the card `tick`, `actions`,
                      `frames`) over the first start to the last end
                      (`Spans.idle_share`)
  <name>_span_ms      `step`, `migrate`: summed, per tic; `walk`, `raster`,
                      `fallback`, `frames`: summed, per agent step
  overflow_envs       the program's counter per agent step; migrated_envs
                      per tic
"""

from __future__ import annotations

import sys
import time

MIN_STEPS = 32
# Agent steps of the span window on the CPU: none, so that a CPU run writes
# no number under these metrics' names; the CPU rehearsal sets some.
CPU_STEPS = 0
CAPTURE_STEPS = 2
PER_TIC = ("step", "migrate")
PER_STEP = ("walk", "raster", "fallback", "frames", "actions")
FALLBACK_KERNEL = "peel_resolve"  # one launch a run of the fallback's WHILE body


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def window(ctx):
    """The span window's readings (a dict), run at the first call and
    cached on `ctx`; None where the program has no `trace`."""
    if hasattr(ctx, "span_window"):
        return ctx.span_window
    ctx.span_window = None
    steps = max(ctx.traced_steps, MIN_STEPS) if ctx.device.type == "cuda" else CPU_STEPS
    if not steps:
        return None
    try:
        from tpu_doom_torch import trace
    except ImportError:
        return None
    from harness.cell import sync

    prog, k = ctx.program, ctx.step_index
    trace.enable(ctx.device)
    try:
        for _ in range(CAPTURE_STEPS):
            prog.step(k)
            k += 1
        sync(ctx.device)
        trace.reset()
        prog.reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            prog.step(k)
            k += 1
        sync(ctx.device)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        rec, counts = trace.spans(), trace.counts()
        blocks = prog.counts().get(FALLBACK_KERNEL, 0)
    finally:
        trace.disable()
    ctx.step_index = k
    idle = rec.idle_share()
    if idle is None:
        return None
    tics = steps * int(ctx.mix["frame_skip"])
    out = {"device_idle_share": idle,
           "overflow_envs": counts["overflow_envs"] / steps,
           "migrated_envs": counts["migrated_envs"] / tics}
    for name in PER_TIC:
        out[f"{name}_span_ms"] = rec.total_ms(name) / tics
    for name in PER_STEP:
        out[f"{name}_span_ms"] = rec.total_ms(name) / steps
    ctx.span_window = out

    win_ms = rec.window_ns() / 1e6 / steps
    layers = sum(out[f"{n}_span_ms"] * (int(ctx.mix["frame_skip"]) if n in PER_TIC else 1)
                 for n in PER_TIC + PER_STEP)
    idle_ms = win_ms * out["device_idle_share"] / 100.0
    timed_ms = ctx.wall_s * 1e3 / ctx.steps if ctx.steps else float("nan")
    _log(f"span window: {steps} agent steps, ticks {rec.first_tick}-{rec.last_tick},"
         f" {rec.dropped_ticks} dropped, {rec.unrecorded} unrecorded; clock error bound"
         f" {rec.error_ns} ns, resolution {rec.resolution_ns} ns")
    _log(f"span window ms per agent step: spans {win_ms:.4f}, host clock {host_ms:.4f},"
         f" timed window (tracing off) {timed_ms:.4f}: the span window takes"
         f" {100.0 * (host_ms / timed_ms - 1.0):+.2f} % (tracing's cost, and the two"
         " windows' different steps)")
    _log(f"span window per agent step: layers {layers:.4f} + idle {idle_ms:.4f} ="
         f" {layers + idle_ms:.4f} ms of {win_ms:.4f}"
         f" ({100.0 * (layers + idle_ms) / win_ms:.2f} %); "
         + ", ".join(f"{k} {v:.6g}" for k, v in out.items()))
    _log(f"span window fallback: {blocks} blocks (WHILE body runs), {counts['overflow_envs']}"
         f" envs, {rec.total_ms('fallback') / max(blocks, 1):.4f} ms a block")
    gaps = sorted(rec.gaps().items(), key=lambda kv: -kv[1])
    _log("span window device gaps by host span open at their start (ms per agent step): "
         + (", ".join(f"{k} {v / steps:.4f}" for k, v in gaps) or "none"))
    return out


def reading(ctx, name: str):
    """One reading of the span window, or None."""
    w = window(ctx)
    return None if w is None else w.get(name)
