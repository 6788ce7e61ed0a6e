"""walk_span_ms (layer: walk): the `walk` spans (W0-W2 and their PyTorch
glue) summed over levels, per agent step of the span window
(`harness/spans.py`)."""

from harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "walk", "step")
