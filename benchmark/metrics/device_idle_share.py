"""device_idle_share (layer: captured tick): 100 x the device time inside
none of the program's outermost spans (`tick`, `actions`, `frames`) over
the span window's first start to last end, read from the port's
device-clock stamps with no profiler attached (`harness/spans.py`)."""

from harness.spans import idle_share


def read(ctx):
    return idle_share(ctx)
