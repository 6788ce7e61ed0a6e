"""walk_ms (layer: walk): device ms of the walk's three kernels (W0
walk_table, W1 walk_cross, W2 walk_records) per rendered frame of the
batch (one per agent step), by kernel name in the traced window."""

KERNELS = ("walk_table_kernel", "walk_cross_kernel", "walk_records_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    seconds = ctx.trace.op_seconds(*KERNELS)
    return seconds * 1e3 / ctx.traced_steps if seconds > 0 else None
