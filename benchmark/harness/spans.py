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

The window keeps its `Spans` record, every counter `trace.counts()`
returns, its agent steps and its tics. A metric file reads them by name:
  span_ms(ctx, name, per)   the spans named `name`, summed, in ms per tic
                            or per agent step (`per` "tic" or "step")
  counter(ctx, name, per)   the program's counter `name`, per tic or step
  idle_share(ctx)           100 x the time inside none of the program's
                            outermost spans (on the card `tick`, `actions`,
                            `frames`) over the first start to the last end
                            (`Spans.idle_share`)
A name the window never saw reads None, and the metric is left out of
the line.
"""

from __future__ import annotations

import dataclasses
import sys
import time

MIN_STEPS = 32
# Agent steps of the span window on the CPU: none, so that a CPU run writes
# no number under these metrics' names; the CPU rehearsal sets some.
CPU_STEPS = 0
CAPTURE_STEPS = 2
# The layers the log lines print, each with the unit it is printed per;
# what a metric file can read is not limited to them.
LOGGED = (("step", "tic"), ("migrate", "tic"), ("walk", "step"), ("raster", "step"),
          ("fallback", "step"), ("frames", "step"), ("actions", "step"))
FALLBACK_KERNEL = "peel_resolve"  # one launch a run of the fallback's WHILE body


@dataclasses.dataclass
class Window:
    """What the span window read: the port's `Spans` record, every counter
    `trace.counts()` returned, and the window's agent steps and tics."""

    spans: object
    counts: dict
    steps: int
    tics: int

    def per(self, per: str) -> int:
        """The window's tics (`per` "tic") or agent steps ("step")."""
        if per == "tic":
            return self.tics
        if per == "step":
            return self.steps
        raise ValueError(f"per is 'tic' or 'step', not {per!r}")


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def window(ctx):
    """The span window (a `Window`), run at the first call and cached on
    `ctx`; None where the program has no `trace`."""
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
    fs = int(ctx.mix["frame_skip"])
    win = ctx.span_window = Window(rec, counts, steps, steps * fs)

    win_ms = rec.window_ns() / 1e6 / steps
    layers = [(name, per, span_ms(ctx, name, per)) for name, per in LOGGED]
    layers_ms = sum(v * (fs if per == "tic" else 1) for _, per, v in layers if v is not None)
    idle_ms = win_ms * idle / 100.0
    timed_ms = ctx.wall_s * 1e3 / ctx.steps if ctx.steps else float("nan")
    _log(f"span window: {steps} agent steps, ticks {rec.first_tick}-{rec.last_tick},"
         f" {rec.dropped_ticks} dropped, {rec.unrecorded} unrecorded; clock error bound"
         f" {rec.error_ns} ns, resolution {rec.resolution_ns} ns")
    _log(f"span window ms per agent step: spans {win_ms:.4f}, host clock {host_ms:.4f},"
         f" timed window (tracing off) {timed_ms:.4f}: the span window takes"
         f" {100.0 * (host_ms / timed_ms - 1.0):+.2f} % (tracing's cost, and the two"
         " windows' different steps)")
    _log(f"span window per agent step: layers {layers_ms:.4f} + idle {idle_ms:.4f} ="
         f" {layers_ms + idle_ms:.4f} ms of {win_ms:.4f}"
         f" ({100.0 * (layers_ms + idle_ms) / win_ms:.2f} %); idle share {idle:.6g} %, "
         + ", ".join(f"{name} {v:.6g} ms/{per}" for name, per, v in layers if v is not None)
         + "; counters " + ", ".join(f"{name} {v}" for name, v in counts.items()))
    _log(f"span window fallback: {blocks} blocks (WHILE body runs), "
         f"{counts.get('overflow_envs')} envs, "
         f"{rec.total_ms('fallback') / max(blocks, 1):.4f} ms a block")
    gaps = sorted(rec.gaps().items(), key=lambda kv: -kv[1])
    _log("span window device gaps by host span open at their start (ms per agent step): "
         + (", ".join(f"{k} {v / steps:.4f}" for k, v in gaps) or "none"))
    return win


def span_ms(ctx, name: str, per: str):
    """The spans named `name` summed over the span window, in ms per tic
    (`per` "tic") or per agent step ("step"); None where the window has
    none of that name, or there is no window."""
    w = window(ctx)
    if w is None or not any(s.name == name for s in w.spans.spans):
        return None
    return w.spans.total_ms(name) / w.per(per)


def counter(ctx, name: str, per: str):
    """The program's counter `name` over the span window, per tic or per
    agent step; None where the program has no counter of that name, or
    there is no window."""
    w = window(ctx)
    if w is None or name not in w.counts:
        return None
    return w.counts[name] / w.per(per)


def idle_share(ctx):
    """100 x the span window's device time inside none of the program's
    outermost spans over its first start to its last end; None without a
    window."""
    w = window(ctx)
    return None if w is None else w.spans.idle_share()
