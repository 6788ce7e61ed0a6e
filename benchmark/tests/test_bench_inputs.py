"""The GameConfig fields a configuration sets (`harness/inputs.py:
game_fields`): every key of its `game` reaches both sides' GameConfig
under its own name; a key that is not a field of both, or that the
harness sets itself, is refused by name."""

import pytest

from harness.cell import Cell
from harness.inputs import METADATA, game_fields


def _configs():
    from reference.utils.config import GameConfig as ReferenceConfig
    from tpu_doom_torch.utils.config import GameConfig as PortConfig

    return PortConfig, ReferenceConfig


@pytest.mark.parametrize("cell", ["synth_b1024.fs1", "synthbank4_b4096.fs1"])
def test_existing_configurations_give_the_same_game_configs(cell):
    config = Cell(cell).config
    g = config["game"]
    # What the three fields the harness passed before gave.
    before = dict(width=int(config["width"]), height=int(config["height"]),
                  raster_backend=g["raster_backend"],
                  portal_crossings=int(g["portal_crossings"]),
                  portal_compact_crossings=int(g["portal_compact_crossings"]),
                  metadata_file=METADATA)
    assert game_fields(config) == before
    for GameConfig in _configs():
        assert GameConfig(**game_fields(config)) == GameConfig(**before)


def test_any_game_config_field_reaches_both_sides():
    config = Cell("synth_b1024.fs1").config
    config["game"] = dict(config["game"], portal_global_segs_max=1024,
                          portal_select_rows="off")
    for GameConfig in _configs():
        cfg = GameConfig(**game_fields(config))
        assert cfg.portal_global_segs_max == 1024 and cfg.portal_select_rows == "off"
        assert cfg.portal_crossings == 24 and cfg.width == 320


@pytest.mark.parametrize("key", ["portal_global_seg_max", "batch_size", "width", "player"])
def test_a_key_that_is_not_a_settable_field_is_refused(key):
    config = Cell("synth_b1024.fs1").config
    config["game"] = dict(config["game"], **{key: 1})
    with pytest.raises(ValueError, match=key):
        game_fields(config)
