"""The rooflines' counts at small shapes, by hand."""

import pytest

from harness.cell import load_module
from harness.peaks import F32_OPS_PER_S, HBM_BYTES_PER_S, least_seconds


def test_w2_counts():
    w2 = load_module("metrics", "w2_roofline")
    n_bytes, ops = w2.counts(envs=2, width=3, kept=8, n_words=4)
    # records 2 x 40 x 16 x 3 f32, alpha words 2 x 8 x 4 x 3 i32, kept
    # crossings 2 x 8 x 3 x 21 bytes
    assert n_bytes == 2 * 40 * 16 * 3 * 4 + 2 * 8 * 4 * 3 * 4 + 2 * 8 * 3 * 21
    assert ops == 2 * 8 * 3 * 64


def test_w2_counts_on_an_uncompacted_level():
    w2 = load_module("metrics", "w2_roofline")
    n_bytes, ops = w2.counts(envs=2, width=3, kept=24, n_words=4, selected=True)
    # K = 24 crossings' records and alpha words; of each crossing and column
    # W1's t, u, top, bot and live (no row id) and 64 f32 columns of B4's
    # selection
    assert n_bytes == (2 * 24 * 5 * 16 * 3 * 4 + 2 * 24 * 4 * 3 * 4
                       + 2 * 24 * 3 * (17 + 64 * 4))
    assert ops == 2 * 24 * 3 * 64
    # Read from the table (portal_select_rows "off"): W1's outputs with the row id.
    assert w2.counts(envs=2, width=3, kept=24, n_words=4)[0] == (
        2 * 24 * 5 * 16 * 3 * 4 + 2 * 24 * 4 * 3 * 4 + 2 * 24 * 3 * 21)


def _walks(config):
    from harness.cell import Context
    from harness.inputs import WadFiles

    wads = WadFiles(config["levels"])
    try:
        return load_module("metrics", "w2_roofline").walks(Context(config=config, wads=wads))
    finally:
        wads.close()


def test_w2_alpha_words_of_the_synthetic_levels():
    from harness.cell import Cell

    for name, levels in (("synth_b1024.fs1", 1), ("synthbank4_b4096.fs1", 4)):
        walks = _walks(Cell(name).config)
        assert len(walks) == levels and all(1 <= n <= 8 for _, n, _ in walks)
        # Compacted to 8 crossings, the table read at each crossing's row.
        assert all(kept == 8 and not selected for kept, _, selected in walks)


@pytest.mark.parametrize("game, kept, selected", [
    ({}, 24, True),  # AUTO: no compaction on 257 rows, B4's selection
    ({"portal_compact_crossings": 0}, 24, True),
    ({"portal_compact_crossings": 8}, 8, False),
    ({"portal_select_rows": "off"}, 24, False),
    ({"portal_crossings": 16}, 16, True),
])
def test_w2_walks_of_a_big_level(game, kept, selected):
    config = {"name": "texstress_small", "levels": [[":texstress:10x16", 0]], "width": 64,
              "height": 40, "game": dict(game, raster_backend="portal", clip_substeps=4)}
    (k, n_words, sel), = _walks(config)
    assert (k, sel) == (kept, selected) and n_words >= 1


def test_b2_counts():
    b2 = load_module("metrics", "b2_roofline")
    n_bytes, ops = b2.counts(envs=2, width=3, height=5)
    # u8 + bool frames, and one record's span and 11 shade channels a column
    assert n_bytes == 2 * 3 * 5 * 2 + 2 * 3 * 13 * 4
    assert ops == 2 * 3 * 5 * 60


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(HBM_BYTES_PER_S, 0) == pytest.approx(1.0)
    assert least_seconds(0, F32_OPS_PER_S) == pytest.approx(1.0)
    assert least_seconds(HBM_BYTES_PER_S, 2 * F32_OPS_PER_S) == pytest.approx(2.0)
