"""agent_step_ms_p95: the 95th percentile over every agent step of the
timed window (frame_skip tics and one render) of the time between the
CUDA events recorded after it and after the step before; no host sync
inside the window."""

from harness.cell import p95


def read(ctx):
    return p95(ctx.step_ms)
