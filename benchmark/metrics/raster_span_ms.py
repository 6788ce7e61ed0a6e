"""raster_span_ms (layer: portal raster): the `raster` spans (B2 and its
glue: the sky's coordinates, the arguments) summed over levels, per agent
step of the span window (`harness/spans.py`)."""

from harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "raster", "step")
