"""fallback_blocks (layer: triangle fallback): the triangle fallback's
runs per agent step over the timed window of the traced run. Each run of
the fallback's WHILE node renders a block of up to 32 envs through the
triangle path (one B3 peel_resolve launch), in a frame where an env's
column holds more crossings than the walk keeps; each adds ~2.6 ms to
its step. Read from the port's launch counts, the conditional bodies'
counted on the device (`ops.launch_counts`), zeroed before the window and
read after it; the profiler's trace does not show the bodies' kernels."""

KERNEL = "peel_resolve"


def read(ctx):
    if ctx.counts is None or not ctx.steps:
        return None
    return ctx.counts.get(KERNEL, 0) / ctx.steps
