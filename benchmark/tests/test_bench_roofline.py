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


def test_w2_alpha_words_of_the_synthetic_levels():
    from harness.cell import Cell, Context
    from harness.inputs import WadFiles

    for name, levels in (("synth_b1024.fs1", 1), ("synthbank4_b4096.fs1", 4)):
        config = Cell(name).config
        wads = WadFiles(config["levels"])
        try:
            words = load_module("metrics", "w2_roofline").alpha_words(
                Context(config=config, wads=wads))
        finally:
            wads.close()
        assert len(words) == levels and all(1 <= n <= 8 for n in words)


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
