"""The level banks the port is measured on, built from (wad, level) specs.

`BANK5` is BASELINE config 5 (E1M1, E1M2, MAP01, MAP02), `BANK8`
bench.py's L=8 bank (the four plus two stress and two texstress mazes),
both at 640x400 as bench.py's `bank_main` runs them. `make_bank` compiles
the specs' levels and stacks them into a `LevelBank` with bank_main's
config (`bank_config`); bank_main's actions and ticks are in
`tpu_doom_torch.bench`.
chip_smoke.py, tools/profile_tick.py and the tests build their banks here.
"""

from __future__ import annotations

BANK_W, BANK_H = 640, 400
BANK5 = ((":test:", 0), (":test:", 1), (":doom2:", 0), (":doom2:", 1))
BANK8 = BANK5 + ((":stress:4", 0), (":stress:6", 0), (":texstress:4x16", 0),
                 (":texstress:6x24", 0))


def bank_levels(specs, cfg):
    """The LevelArrays of (wad, level) specs, compiled by the port."""
    from ..geom.builder import compile_level
    from ..models.doom_sim import open_wad
    from ..wad.meta import WadMetadata
    from ..wad.tex import TextureDirectory

    meta = WadMetadata.from_file(cfg.metadata_file)
    wads, out = {}, []
    for wad_file, level in specs:
        if wad_file not in wads:
            wad = open_wad(wad_file)
            wads[wad_file] = (wad, TextureDirectory(wad, meta))
        out.append(compile_level(*wads[wad_file], meta, level))
    return out


def bank_config(**kw):
    """bank_main's GameConfig (bench.py:268-273) at 640x400; `kw`
    overrides its fields."""
    from ..utils.config import GameConfig, PlayerConfig

    base = dict(wad_file=":test:", width=BANK_W, height=BANK_H, raster_backend="portal",
                player=PlayerConfig(clip_substeps=4))
    base.update(kw)
    return GameConfig(**base)


def make_bank(specs, device="cuda", **kw):
    """A LevelBank of `specs` with `bank_config(**kw)`."""
    from ..models import LevelBank

    cfg = bank_config(**kw)
    return LevelBank(bank_levels(specs, cfg), cfg, device)

