"""step_span_ms (layer: step): the `step` spans (sim/step.py: effects,
player, triggers; a bank's one per level) summed, per tic of the span
window (`harness/spans.py`): the step timed inside the tick that runs."""

from harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "step", "tic")
