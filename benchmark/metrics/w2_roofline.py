"""w2_roofline (layer: walk): the share of its roofline that W2
(walk_records_kernel) reaches: its least time over its device time in the
traced window.

Its least time per rendered frame of the batch, from the cell's shapes:
the larger of its bytes over the card's bandwidth and its f32 operations
over the card's f32 rate (`harness/peaks.py`). Bytes: what it writes,
once: the records ((B, kc * 5, 16, W) f32) and the masked family's alpha
words ((B, kc, n_words, W) i32, n_words = ceil(hc / 32) for the level's
tallest masked texture hc, from the benchmark's own level compiler); and
the W1 outputs of the kept crossings it reads, once (t, u, top, bot f32,
row id i32, live bool: 21 bytes per kept crossing and column).
Operations: RECORD_OPS per kept crossing and column. Left out, since
which of them it reads depends on the view: the attribute table's rows.
"""

from harness.peaks import least_seconds

KERNEL = "walk_records_kernel"
RECORDS_PER_CROSSING, CHANNELS = 5, 16
CROSSING_BYTES = 21
RECORD_OPS = 64  # one kept crossing's five records and alpha word in one column


def counts(envs: int, width: int, kept: int, n_words: int) -> tuple[float, float]:
    """(bytes, f32 operations) of W2 for one frame of `envs` envs of a
    level whose alpha columns have n_words words."""
    n_bytes = (envs * kept * RECORDS_PER_CROSSING * CHANNELS * width * 4
               + envs * kept * n_words * width * 4
               + envs * kept * width * CROSSING_BYTES)
    return float(n_bytes), float(envs * kept * width * RECORD_OPS)


def alpha_words(ctx) -> list:
    """n_words of each level of the cell, from the benchmark's compiler."""
    from harness.inputs import METADATA
    from reference.levels import compile_levels

    out = []
    for arrays in compile_levels(ctx.wads.levels(ctx.config["levels"]), METADATA):
        dims = arrays.combo_dims
        hc = max(int(dims[1, 0]), int(dims[2, 0]), 1)
        out.append(max(-(-hc // 32), 1))
    return out


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    seconds = ctx.trace.op_seconds(KERNEL)
    if seconds <= 0:
        return None
    envs = int(ctx.config["envs_per_level"])
    kept = int(ctx.config["game"]["portal_compact_crossings"])
    least = sum(least_seconds(*counts(envs, int(ctx.config["width"]), kept, n))
                for n in alpha_words(ctx))
    return 100.0 * least * ctx.traced_steps / seconds
