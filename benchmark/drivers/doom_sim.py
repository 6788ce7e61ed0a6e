"""Configurations of kind "doom_sim": every env on one level in the
port's `DoomSim`, one `DoomSim.rollout(state, actions, n=frame_skip,
render_every=frame_skip)` call per agent step (on the card each tic a
replayed CUDA graph, the frame rendered after the last tic); and the
reference's plain step and render of the same level.

Only the port's public API is called: `DoomSim` (`reset`, `rollout`,
`step_n`), `GameConfig` / `PlayerConfig`, the `Actions` tuple and the
launch counts of `ops`.
"""

from __future__ import annotations

import gc
import time

import torch

from harness.cell import sync
from harness.inputs import METADATA, game_fields


class Program:
    """The port's DoomSim on the cell's level, its state advanced by
    `step`."""

    def __init__(self, config, mix, wads, stream, device):
        from tpu_doom_torch.models import DoomSim
        from tpu_doom_torch.sim.state import Actions
        from tpu_doom_torch.utils.config import GameConfig, PlayerConfig

        (spec, level), = config["levels"]
        self.device = torch.device(device)
        self.envs = int(config["envs_per_level"])
        self.width, self.height = int(config["width"]), int(config["height"])
        self.fs = int(mix["frame_skip"])
        self.stream = stream
        self.Actions = Actions
        self.sim = DoomSim(GameConfig(
            wad_file=wads.paths[spec], initial_level_index=int(level),
            batch_size=self.envs,
            player=PlayerConfig(clip_substeps=int(config["game"]["clip_substeps"])),
            **game_fields(config)), self.device)
        reset = self.sim.reset(self.envs)
        self.start = dict(zip(reset._fields, (x.clone() for x in reset)))
        self.state = reset._replace(yaw=stream.spawn_yaw.clone())

    def actions(self, k: int, n: int):
        """Stream row k's actions held for n tics: (n, B, ...) views."""
        s, r, B = self.stream, self.stream.row(k), self.envs
        z = s.zero.expand(n, B)
        return self.Actions(movement=s.movement[r].expand(n, B, 2),
                            look=s.look[r].expand(n, B, 2), jump=z, fly_toggle=z,
                            clip_toggle=z, push=s.use[r].expand(n, B), shoot=z)

    def step(self, k: int) -> torch.Tensor:
        """Agent step k -> its frames (1, B, H, W) u8."""
        self.state, frames = self.sim.rollout(self.state, self.actions(k, self.fs), self.fs,
                                              render_every=self.fs)
        return frames

    def capture(self) -> dict:
        """The state now: rollout returns new tensors each call, so these
        stay as they are."""
        return dict(zip(self.state._fields, self.state))

    def take_frames(self, frames, flat) -> torch.Tensor:
        return frames.reshape(-1, self.height, self.width)[flat]

    def reset_counts(self) -> None:
        """Zero the port's kernel launch counts (`ops.reset_launch_counts`)."""
        from tpu_doom_torch import ops

        ops.reset_launch_counts()

    def counts(self) -> dict:
        """{kernel: launches} since `reset_counts`, the conditional nodes'
        bodies counted on the device (`ops.launch_counts`; synchronises)."""
        from tpu_doom_torch import ops

        return ops.launch_counts()

    def time_step(self, k: int, min_seconds: float) -> float:
        """Device ms per tic of the step alone (`DoomSim.step_n`, replayed),
        host clock ending in a synchronize, over at least min_seconds."""
        n = 16
        state = self.sim.step_n(self.state, self.actions(k, n), n)  # capture, warm
        sync(self.device)
        tics, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < min_seconds:
            state = self.sim.step_n(state, self.actions(k, n), n)
            tics += n
            sync(self.device)
        return (time.perf_counter() - t0) * 1e3 / tics

    def free(self) -> None:
        del self.sim, self.state, self.stream
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Reference:
    """The reference's plain step and render of the cell's level,
    compiled by its own level compiler from the same WAD file."""

    def __init__(self, config, mix, wads, device):
        from reference.levels import compile_levels
        from reference.render.portal import portal_scene_from_table
        from reference.sim.scene import scene_from_arrays
        from reference.utils.config import GameConfig, PlayerConfig

        self.device = torch.device(device)
        self.envs = int(config["envs_per_level"])
        self.width, self.height = int(config["width"]), int(config["height"])
        self.fs = int(mix["frame_skip"])
        arrays, = compile_levels(wads.levels(config["levels"]), METADATA)
        self.scene, self.num_objects = scene_from_arrays(arrays, self.device)
        self.pscene = portal_scene_from_table(arrays.portal, arrays, self.device)
        self.game = GameConfig(
            wad_file="", batch_size=self.envs,
            player=PlayerConfig(clip_substeps=int(config["game"]["clip_substeps"])),
            **game_fields(config))

    def start(self) -> dict:
        from reference.sim.state import initial_state

        s = initial_state(self.scene, self.num_objects, self.envs)
        return dict(zip(s._fields, s))

    def agent_step(self, pre: dict, stream, k: int, lower=None) -> dict:
        """frame_skip tics of the plain step from `pre` with stream row k's
        actions. `lower`: a dtype every float of the state is rounded to
        after each tic (the control)."""
        from reference.sim.state import Actions, SimState
        from reference.sim.step import step

        r = stream.row(k)
        z = stream.zero
        acts = Actions(movement=stream.movement[r], look=stream.look[r], jump=z,
                       fly_toggle=z, clip_toggle=z, push=stream.use[r], shoot=z)
        s = SimState(**pre)
        for _ in range(self.fs):
            s = step(self.scene, self.game, s, acts)
            if lower is not None:
                s = SimState(*(x.to(lower).to(x.dtype) if x.is_floating_point() else x
                               for x in s))
        return dict(zip(s._fields, s))

    def render(self, post: dict, flat) -> torch.Tensor:
        """The plain render of the envs `flat` of `post` -> (n, H, W) u8."""
        from reference.render import render_dispatch
        from reference.sim.state import SimState

        sub = SimState(*(post[f][flat] for f in SimState._fields))
        return render_dispatch(self.scene, self.pscene, self.game, sub, self.width,
                               self.height)[0]
