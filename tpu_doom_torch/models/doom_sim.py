"""DoomSim: the user-facing simulator on PyTorch.

Port of `tpu_doom/models/doom_sim.py` on a `device`, the card unless the
caller asks for the CPU: level management (`num_levels`, `list_levels`,
`load_level` with its level cache, `check`), `reset` / `null_actions` /
`step` / `render` / `step_render` / `render_rgb`, the multi-tick
`step_n` and `rollout`, and the exit handling (`reset_exited` on the
device, `handle_exits` on the host). On the card `step_n` and `rollout`
replay captured CUDA graphs of the tick (`tpu_doom_torch/graphs.py`): one
launch per tick and no host read inside the n ticks; on the CPU they
loop eagerly. The portal backend renders every level, big ones (more
than 192 walk rows, such as `:stress:` and `:texstress:`) through the
big-level walk and, when the level's texel table exceeds
`portal_global_segs_max`, the active-set path. Mixed-level batches are
`models.level_bank.LevelBank`'s. Checkpoints are `utils/checkpoint.py`,
the CLI `tpu_doom_torch.cli`.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..geom.builder import compile_level
from ..render import frames_to_rgb, render_dispatch
from ..render.raster import check_raster_backend
from ..sim.scene import scene_from_arrays
from ..graphs import TickGraphs
from ..sim.state import Actions, SimState, initial_state, null_actions
from ..sim.step import check_collision_config
from ..sim.step import step as sim_step
from ..sim.step import step_n as sim_step_n
from ..utils.config import GameConfig
from ..wad.archive import Archive
from ..wad.meta import WadMetadata
from ..wad.tex import TextureDirectory

log = logging.getLogger(__name__)


def checked_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    rather than falling back to the CPU (the CPU must be asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch sees no CUDA card;"
                           " pass device='cpu' to run the kernels' plain versions")
    return dev


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
        self.device = checked_device(device)
        t0 = _time.time()
        self.wad = open_wad(config.wad_file)
        self.metadata = WadMetadata.from_file(config.metadata_file)
        self.textures = TextureDirectory(self.wad, self.metadata)
        log.info("assets loaded in %.2fs", _time.time() - t0)
        self.level_index = -1
        self._level_cache: dict = {}  # index -> (arrays, scene, num_objects)
        self._graphs: Optional[TickGraphs] = None
        self._graphs_config = None
        self.load_level(config.initial_level_index)

    # -- level management ----------------------------------------------

    @property
    def num_levels(self) -> int:
        return self.wad.num_levels

    def list_levels(self) -> list[bytes]:
        return [self.wad.level_name(i) for i in range(self.wad.num_levels)]

    def load_level(self, index: int):
        """Compile + upload a level (cached per index); call reset() for
        fresh states. Drops the captured ticks, as the JAX package drops
        its jits."""
        index = index % max(self.num_levels, 1)
        if index == self.level_index:
            return
        if index not in self._level_cache:
            t0 = _time.time()
            arrays = compile_level(self.wad, self.textures, self.metadata, index)
            scene, num_objects = scene_from_arrays(arrays, self.device)
            self._level_cache[index] = (arrays, scene, num_objects)
            log.info("level %r compiled+uploaded in %.2fs", arrays.name,
                     _time.time() - t0)
        self.arrays, self.scene, self.num_objects = self._level_cache[index]
        self.level_index = index
        self._portal_scene = None
        self._graphs = None

    def check(self) -> float:
        """Load + compile every level, then the current one again; returns
        elapsed seconds (the reference's `check` subcommand)."""
        t0 = _time.time()
        current = self.level_index
        for i in range(self.num_levels):
            self.load_level(i)
        self.load_level(current)
        return _time.time() - t0

    # -- simulation ------------------------------------------------------

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

    # -- multi-tick ------------------------------------------------------

    def tick_graphs(self) -> TickGraphs:
        """The captured ticks of this level and config (made anew when
        either changes). Its tick functions hold the level and config, not
        the sim, so that dropping the sim frees the graphs at once."""
        if self._graphs is None or self._graphs_config != self.config:
            cfg, scene, pscene = self.config, self.scene, self.portal_scene()
            self._graphs = TickGraphs(
                lambda s, a: sim_step(scene, cfg, s, a),
                lambda s, w, h: render_dispatch(scene, pscene, cfg, s, w, h)[0])
            self._graphs_config = cfg
        return self._graphs

    def step_n(self, state: SimState, action_seq, n: int) -> SimState:
        """n ticks with an (n, B, ...) Actions sequence, or idle ticks for
        None."""
        return sim_step_n(self.scene, self.config, state, action_seq, n,
                          graphs=self.tick_graphs())

    def rollout(self, state: SimState, action_seq, n: int, *, width=None,
                height=None, render_every: int = 1):
        """n ticks rendering every `render_every`-th frame: the scripted
        flythrough / RL trajectory mode. With render_every > 1 each chunk
        of render_every ticks renders one frame after its last tick, and
        the n % render_every trailing ticks step unrendered. Returns
        (final_state, frames (F, B, H, W) u8). On the card every tick is
        a replayed CUDA graph, and nothing inside the n ticks reads
        back to the host.

        action_seq: (n, B, ...) Actions, or None for idle ticks."""
        if render_every < 1:
            raise ValueError(f"render_every must be at least 1, not {render_every}")
        with trace.host_span("rollout", ahead=1):
            return self.tick_graphs().run(
                state, action_seq, n, render_every, width or self.config.width,
                height or self.config.height)

    # -- exits -----------------------------------------------------------

    @torch.no_grad()
    def reset_exited(self, state: SimState) -> SimState:
        """Envs whose exit fired restart this level in place (ref
        level.rs:194-199, player.rs:119-133); the others are untouched. On
        the device, with no host read: the batched-RL form of
        `handle_exits`."""
        exited = state.exit_triggered > 0
        init = initial_state(self.scene, self.num_objects, state.pos.shape[0])
        return SimState(*(
            torch.where(exited.view((-1,) + (1,) * (s.dim() - 1)), i, s)
            for i, s in zip(init, state)))

    def handle_exits(self, state: SimState) -> SimState:
        """Host-side exit handling for interactive, single-env flows: if
        any env's exit fired, the whole batch moves to the next level and
        resets (ref level.rs:194-199). Reads the exit flags to the host."""
        exits = state.exit_triggered.cpu().numpy()
        if exits.any():
            self.load_level(self.level_index + 1)
            state = self.reset(exits.shape[0])
        return state
