"""migrated_envs (layer: bank migration): envs that changed level per tic
of the span window, counted on the device by the port (`trace.counts()`,
`harness/spans.py`)."""

from harness.spans import counter


def read(ctx):
    return counter(ctx, "migrated_envs", "tic")
