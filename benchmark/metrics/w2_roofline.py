"""w2_roofline (layer: walk): the share of its roofline that W2
(walk_records_kernel) reaches: its least time over its device time in the
traced window.

Its least time per rendered frame of the batch, from the cell's shapes,
level by level: the larger of its bytes over the card's bandwidth and its
f32 operations over the card's f32 rate (`harness/peaks.py`). W2 builds
the records of the kept crossings: the level's compaction budget where
the walk compacts (portal_compact_crossings; AUTO resolved by the level's
walk rows, as the reference's `render/portal.py:compact_crossings` does),
else all K crossings W1 keeps (K = portal_crossings, at most the rows
left after the visible-row cull). Bytes: what it writes, once: the
records ((B, kept * 5, 16, W) f32) and the masked family's alpha words
((B, kept, n_words, W) i32, n_words = ceil(hc / 32) for the level's
tallest masked texture hc, from the benchmark's own level compiler); and
what it reads of each kept crossing and column, once: W1's outputs (t, u,
top, bot f32, live bool, and the row id i32 where it reads the table at
that row: 21 bytes), or, on a big level without compaction, where W2
reads B4's selection (B, C, K * W) in place of the table
(`walk_records_kernel<true>`), W1's outputs but the row id (17 bytes) and
the SELECTED_COLUMNS columns of the selection that every call loads.
Operations: RECORD_OPS per kept crossing and column. Left out, since
which of them it reads depends on the view: the attribute table's rows;
and the selection's cell-id columns, which only the active-set path's
remap reads.
"""

from harness.peaks import least_seconds

KERNEL = "walk_records_kernel"
RECORDS_PER_CROSSING, CHANNELS = 5, 16
CROSSING_BYTES = 21  # t, u, top, bot f32, row id i32, live bool
SELECTED_CROSSING_BYTES = 17  # the same but the row id, which W2 does not read from B4's selection
# The attribute columns walk_records_kernel loads from B4's selection
# (csrc/walk.cu): 22 of the row's (hb, fc, ff, the four sky flags,
# ceiling and floor rows, flat light, the two flats' four atlas columns,
# solid, sprite, the two flats' cell bases) and 14 of each of the three
# wall pieces' 16 (exists, low, high, a, b, t1, t2, light, the four atlas
# columns, the masked flag, the cell base); the masked piece's columns
# that the alpha words read again are counted once.
SELECTED_COLUMNS = 22 + 3 * 14
RECORD_OPS = 64  # one kept crossing's five records and alpha word in one column


def counts(envs: int, width: int, kept: int, n_words: int,
           selected: bool = False) -> tuple[float, float]:
    """(bytes, f32 operations) of W2 for one frame of `envs` envs of a
    level whose alpha columns have n_words words; `selected`: W2 reads B4's
    selection rather than the attribute table."""
    read = (SELECTED_CROSSING_BYTES + 4 * SELECTED_COLUMNS) if selected else CROSSING_BYTES
    n_bytes = (envs * kept * RECORDS_PER_CROSSING * CHANNELS * width * 4
               + envs * kept * n_words * width * 4
               + envs * kept * width * read)
    return float(n_bytes), float(envs * kept * width * RECORD_OPS)


def walks(ctx) -> list:
    """(kept crossings, n_words, whether W2 reads B4's selection) of each
    level of the cell, from the benchmark's compiler and the reference's
    GameConfig of the configuration."""
    from harness.inputs import METADATA, game_fields
    from reference.levels import compile_levels
    from reference.ops.walk import SMALL_LEVEL_ROWS
    from reference.render.portal import compact_crossings, visible_segs
    from reference.utils.config import GameConfig

    cfg = GameConfig(**game_fields(ctx.config))
    levels = compile_levels(ctx.wads.levels(ctx.config["levels"]), METADATA)
    # A bank walks every level at its members' padded seg and sprite rows.
    rows = (max(a.portal.p1.shape[0] for a in levels)
            + max(a.portal.sprite_center.shape[0] for a in levels))
    n_cross = int(cfg.portal_crossings)
    sv = visible_segs(cfg, rows)
    k = min(n_cross, sv if 0 < sv < rows else rows)
    kc = compact_crossings(cfg, rows)
    kept = min(kc, k) if 0 < kc < n_cross else k
    selected = cfg.portal_select_rows != "off" and kc == 0 and rows > SMALL_LEVEL_ROWS
    out = []
    for arrays in levels:
        dims = arrays.combo_dims
        hc = max(int(dims[1, 0]), int(dims[2, 0]), 1)
        out.append((kept, max(-(-hc // 32), 1), selected))
    return out


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    seconds = ctx.trace.op_seconds(KERNEL)
    if seconds <= 0:
        return None
    envs, width = int(ctx.config["envs_per_level"]), int(ctx.config["width"])
    least = sum(least_seconds(*counts(envs, width, kept, n_words, selected))
                for kept, n_words, selected in walks(ctx))
    return 100.0 * least * ctx.traced_steps / seconds
