"""fallback_span_ms (layer: triangle fallback): the `fallback` spans, each
the fallback's WHILE node as a whole (bodies included, which the
profiler's trace does not show) and its glue, stamped on the main stream
before and after it, per agent step of the span window
(`harness/spans.py`)."""

from harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "fallback", "step")
