"""migrate_span_ms (layer: bank migration): the `migrate` span
(`LevelBank.step_with_exits` after the step: exit flags, slot migration,
the fresh states) per tic of the span window (`harness/spans.py`)."""

from harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "migrate", "tic")
