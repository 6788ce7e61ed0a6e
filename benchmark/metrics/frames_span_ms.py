"""frames_span_ms (layer: frames): the `frames` spans per agent step of
the span window (`harness/spans.py`): a bank's stack of its levels'
frames inside the graph, or `DoomSim.rollout`'s copy of the graph's frame
out."""

from harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "frames", "step")
