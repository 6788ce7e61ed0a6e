"""overflow_envs (layer: triangle fallback): envs sent to the triangle
fallback per agent step (per rendered frame) of the span window, counted
on the device by the port (`trace.counts()`, `harness/spans.py`)."""

from harness.spans import counter


def read(ctx):
    return counter(ctx, "overflow_envs", "step")
