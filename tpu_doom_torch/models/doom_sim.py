"""DoomSim: the user-facing simulator on PyTorch.

Port of `tpu_doom/models/doom_sim.py` (reset / null_actions / step /
render / step_render / render_rgb) on a `device`, the card unless the
caller asks for the CPU. The portal
backend renders every level, big ones (more than 192 walk rows, such as
`:stress:` and `:texstress:`) through the big-level walk and, when the
level's texel table exceeds `portal_global_segs_max`, the active-set
path. `rollout`, `step_n`, `LevelBank`, checkpoints and the CLI are not
ported yet (ROADMAP A).
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional

import numpy as np
import torch

from ..geom.builder import compile_level
from ..render import frames_to_rgb, render_dispatch
from ..render.raster import check_raster_backend
from ..sim.scene import scene_from_arrays
from ..sim.state import Actions, SimState, initial_state, null_actions
from ..sim.step import check_collision_config
from ..sim.step import step as sim_step
from ..utils.config import GameConfig
from ..wad.archive import Archive
from ..wad.meta import WadMetadata
from ..wad.tex import TextureDirectory

log = logging.getLogger(__name__)


def open_wad(wad_file: str) -> Archive:
    """The synthetic fixtures (':test:', ':doom2:', ':stress:[cells]',
    ':texstress:[cells]x[textures]') or a WAD file on disk."""
    from ..wad import wadgen

    if wad_file == ":test:":
        return Archive(wadgen.build_test_wad(), source=":test:")
    if wad_file == ":doom2:":
        return Archive(wadgen.build_doom2_wad(), source=":doom2:")
    if wad_file.startswith(":stress:"):
        spec = wad_file[len(":stress:"):]
        return Archive(wadgen.build_stress_wad(0, int(spec) if spec else 20),
                       source=wad_file)
    if wad_file.startswith(":texstress:"):
        spec = wad_file[len(":texstress:"):]
        cells, ntex = 16, 128
        if spec:
            c, _, t = spec.partition("x")
            cells, ntex = int(c or cells), int(t or ntex)
        return Archive(wadgen.build_stress_wad(0, cells, n_textures=ntex),
                       source=wad_file)
    return Archive.open(wad_file)


class DoomSim:
    """One loaded level, batched lockstep simulation + rendering on
    `device`: the card by default, where the kernels run; `device="cpu"`
    runs their plain versions."""

    def __init__(self, config: GameConfig, device="cuda"):
        check_raster_backend(config.raster_backend)
        check_collision_config(config.player)
        self.config = config
        self.device = torch.device(device)
        t0 = _time.time()
        self.wad = open_wad(config.wad_file)
        self.metadata = WadMetadata.from_file(config.metadata_file)
        self.textures = TextureDirectory(self.wad, self.metadata)
        log.info("assets loaded in %.2fs", _time.time() - t0)
        self.level_index = -1
        self.load_level(config.initial_level_index)

    def load_level(self, index: int):
        """Compile + upload a level; call reset() for fresh states."""
        index = index % max(self.wad.num_levels, 1)
        if index == self.level_index:
            return
        self.arrays = compile_level(self.wad, self.textures, self.metadata, index)
        self.scene, self.num_objects = scene_from_arrays(self.arrays, self.device)
        self.level_index = index
        self._portal_scene = None

    def reset(self, batch: Optional[int] = None) -> SimState:
        return initial_state(self.scene, self.num_objects,
                             batch or self.config.batch_size)

    def null_actions(self, batch: Optional[int] = None) -> Actions:
        return null_actions(batch or self.config.batch_size, self.device)

    @torch.no_grad()
    def step(self, state: SimState, actions: Actions) -> SimState:
        return sim_step(self.scene, self.config, state, actions)

    def portal_scene(self):
        """Portal tables for the current level (None on the triangle path)."""
        if not self.config.raster_backend.startswith("portal"):
            return None
        if self._portal_scene is None:
            from ..render.portal import portal_scene_from_table

            self._portal_scene = portal_scene_from_table(
                self.arrays.portal, self.arrays, self.device)
        return self._portal_scene

    @torch.no_grad()
    def render(self, state: SimState, width=None, height=None):
        """(indices (B, H, W) u8, covered (B, H, W) bool)."""
        return render_dispatch(
            self.scene, self.portal_scene(), self.config, state,
            width or self.config.width, height or self.config.height)

    def step_render(self, state: SimState, actions: Actions, width=None,
                    height=None):
        """One tick: step, then render -> (state, idx, cov)."""
        state = self.step(state, actions)
        idx, cov = self.render(state, width, height)
        return state, idx, cov

    def render_rgb(self, state: SimState, width=None, height=None) -> np.ndarray:
        idx, cov = self.render(state, width, height)
        return frames_to_rgb(self.scene.palette, idx, cov).cpu().numpy()
