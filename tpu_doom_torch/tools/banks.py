"""The level banks the port is measured on, built from (wad, level) specs.

`BANK5` is BASELINE config 5 (E1M1, E1M2, MAP01, MAP02), `BANK8`
bench.py's L=8 bank (the four plus two stress and two texstress mazes),
both at 640x400 as bench.py's `bank_main` runs them. `make_bank` compiles
the specs' levels and stacks them into a `LevelBank` with bank_main's
config; `bank_actions` and `bank_tick` are bank_main's actions and tick.
chip_smoke.py, tools/profile_tick.py and the tests build their banks here.
"""

from __future__ import annotations

import numpy as np
import torch

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


def make_bank(specs, device="cuda", **kw):
    """A LevelBank of `specs` at 640x400 with bank_main's config
    (bench.py:268-273); `kw` overrides GameConfig fields."""
    from ..models import LevelBank
    from ..utils.config import GameConfig, PlayerConfig

    base = dict(wad_file=":test:", width=BANK_W, height=BANK_H, raster_backend="portal",
                player=PlayerConfig(clip_substeps=4))
    base.update(kw)
    cfg = GameConfig(**base)
    return LevelBank(bank_levels(specs, cfg), cfg, device)


def bank_actions(L, E, device="cuda"):
    """bank_main's ACTIVE actions (bench.py:303-314): walk forward, per-env
    yaw rate and a 5 % push from numpy's default_rng(0), as (L, E, ...)."""
    from ..sim.state import Actions, null_actions

    rng = np.random.default_rng(0)
    look = np.stack([rng.uniform(-0.05, 0.05, L * E).astype(np.float32),
                     np.zeros(L * E, np.float32)], axis=1)
    acts = null_actions(L * E, device)._replace(
        movement=torch.as_tensor(np.tile(np.array([[0.0, 1.0]], np.float32), (L * E, 1)),
                                 device=device),
        look=torch.as_tensor(look, device=device),
        push=torch.as_tensor(rng.random(L * E) < 0.05, device=device))
    return Actions(*(x.reshape((L, E) + x.shape[1:]) for x in acts))


def bank_tick(bank, width, height):
    """bank_main's tick (bench.py:324-342): step_with_exits, then every
    level's render -> ((state, active), frames (L, E, H, W) u8)."""
    def tick(carry, acts):
        state, active = carry
        state, active, _ = bank.step_with_exits(state, active, acts)
        return (state, active), bank.render(state, width, height)[0]
    return tick
