"""Configurations of kind "level_bank": L levels of E envs each in the
port's `LevelBank`, with exit migration every tic. On the card the tic is
`LevelBank.step_with_exits` captured as one CUDA graph
(`graphs.CapturedTick`), and the rendered tic that followed by
`LevelBank.render`, whose frames (L, E, H, W) u8 are the graph's output;
an agent step is frame_skip - 1 step-only replays and one rendered one,
after one device-to-device copy of the step's actions into the graphs'
action buffer. On the CPU the same ticks run eagerly. The reference is
the frozen plain bank (`reference/models/level_bank.py`).

Only the port's public API is called: `LevelBank`, `compile_level`, the
`wad` loaders, `graphs.CapturedTick`, `GameConfig` / `PlayerConfig`, the
state tuples and the launch counts of `ops`.
"""

from __future__ import annotations

import gc
import time

import torch

from harness.cell import sync
from harness.inputs import METADATA, game_fields


class Program:
    """The port's LevelBank of the cell's levels, its (state, active)
    advanced by `step`."""

    def __init__(self, config, mix, wads, stream, device):
        from tpu_doom_torch.geom import compile_level
        from tpu_doom_torch.models import LevelBank
        from tpu_doom_torch.sim.state import Actions, SimState
        from tpu_doom_torch.utils.config import GameConfig, PlayerConfig
        from tpu_doom_torch.wad import Archive, TextureDirectory, WadMetadata

        self.device = torch.device(device)
        self.L, self.E = len(config["levels"]), int(config["envs_per_level"])
        self.width, self.height = int(config["width"]), int(config["height"])
        self.fs = int(mix["frame_skip"])
        self.stream = stream
        self.Actions, self.SimState = Actions, SimState
        cfg = GameConfig(wad_file="", batch_size=self.L * self.E,
                         player=PlayerConfig(clip_substeps=int(config["game"]["clip_substeps"])),
                         **game_fields(config))
        meta = WadMetadata.from_file(METADATA)
        opened, levels = {}, []
        for path, index in wads.levels(config["levels"]):
            if path not in opened:
                wad = Archive.open(path)
                opened[path] = (wad, TextureDirectory(wad, meta))
            levels.append(compile_level(*opened[path], meta, index))
        self.bank = LevelBank(levels, cfg, self.device)
        reset = self.bank.reset(self.E)
        self.start = dict(zip(reset._fields, (x.clone() for x in reset)))
        self.start["active"] = torch.ones((self.L, self.E), dtype=torch.bool,
                                          device=self.device)
        state = reset._replace(yaw=stream.spawn_yaw.reshape(self.L, self.E).clone())
        self.carry = (state, self.start["active"].clone())
        self.acts = self._row(0)
        bank, W, H = self.bank, self.width, self.height

        def step_tick(carry, acts):
            s, a, _ = bank.step_with_exits(carry[0], carry[1], acts)
            return ((s, a),)

        def render_tick(carry, acts):
            s, a, _ = bank.step_with_exits(carry[0], carry[1], acts)
            return (s, a), bank.render(s, W, H)[0]

        self.step_tick, self.render_tick = step_tick, render_tick
        self.graphs = None
        if self.device.type == "cuda":
            from tpu_doom_torch.graphs import CapturedTick

            pool = torch.cuda.graph_pool_handle()
            self.graphs = {"render": CapturedTick(render_tick, self.carry, self.acts, pool)}
            if self.fs > 1:
                self.graphs["step"] = CapturedTick(step_tick, self.carry, self.acts, pool)

    def _row(self, k: int):
        """Stream row k's actions, (L, E, ...) views."""
        s, r, LE = self.stream, self.stream.row(k), (self.L, self.E)
        z = s.zero.reshape(LE)
        return self.Actions(movement=s.movement[r].reshape(LE + (2,)),
                            look=s.look[r].reshape(LE + (2,)), jump=z, fly_toggle=z,
                            clip_toggle=z, push=s.use[r].reshape(LE), shoot=z)

    def _tic(self, render: bool):
        if self.graphs is not None:
            g = self.graphs["render" if render else "step"]
            g.replay()
            return g.outs[0] if render else None
        if render:
            self.carry, frames = self.render_tick(self.carry, self.acts)
            return frames
        self.carry = self.step_tick(self.carry, self.acts)[0]
        return None

    def step(self, k: int) -> torch.Tensor:
        """Agent step k -> its frames (L, E, H, W) u8."""
        if self.graphs is not None:
            torch._foreach_copy_(list(self.acts), list(self._row(k)))
        else:
            self.acts = self._row(k)
        for _ in range(self.fs - 1):
            self._tic(False)
        return self._tic(True)

    def capture(self) -> dict:
        """A copy of (state, active) now: the graphs overwrite theirs."""
        s, a = self.carry
        out = {f: x.clone() for f, x in zip(s._fields, s)}
        out["active"] = a.clone()
        return out

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
        """Device ms per tic of `step_with_exits` alone, replayed, host
        clock ending in a synchronize, over at least min_seconds."""
        if self.graphs is not None and "step" not in self.graphs:
            from tpu_doom_torch.graphs import CapturedTick

            self.graphs["step"] = CapturedTick(self.step_tick, self.carry, self.acts)
        self._tic(False)
        sync(self.device)
        tics, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < min_seconds:
            for _ in range(8):
                self._tic(False)
            tics += 8
            sync(self.device)
        return (time.perf_counter() - t0) * 1e3 / tics

    def free(self) -> None:
        del self.bank, self.carry, self.acts, self.graphs, self.stream
        del self.step_tick, self.render_tick
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Reference:
    """The frozen plain bank of the cell's levels, compiled by the
    reference's own level compiler from the same WAD files."""

    def __init__(self, config, mix, wads, device):
        from reference.levels import compile_levels
        from reference.models import LevelBank
        from reference.utils.config import GameConfig, PlayerConfig

        self.device = torch.device(device)
        self.L, self.E = len(config["levels"]), int(config["envs_per_level"])
        self.width, self.height = int(config["width"]), int(config["height"])
        self.fs = int(mix["frame_skip"])
        cfg = GameConfig(wad_file="", batch_size=self.L * self.E,
                         player=PlayerConfig(clip_substeps=int(config["game"]["clip_substeps"])),
                         **game_fields(config))
        self.bank = LevelBank(compile_levels(wads.levels(config["levels"]), METADATA), cfg,
                              self.device)

    def start(self) -> dict:
        s = self.bank.reset(self.E)
        out = dict(zip(s._fields, s))
        out["active"] = torch.ones((self.L, self.E), dtype=torch.bool, device=self.device)
        return out

    def agent_step(self, pre: dict, stream, k: int, lower=None) -> dict:
        """frame_skip tics of the plain bank step, exits migrated, from
        `pre` with stream row k's actions; `lower` as for doom_sim."""
        from reference.sim.state import Actions, SimState

        r, LE = stream.row(k), (self.L, self.E)
        z = stream.zero.reshape(LE)
        acts = Actions(movement=stream.movement[r].reshape(LE + (2,)),
                       look=stream.look[r].reshape(LE + (2,)), jump=z, fly_toggle=z,
                       clip_toggle=z, push=stream.use[r].reshape(LE), shoot=z)
        s = SimState(*(pre[f] for f in SimState._fields))
        active = pre["active"]
        for _ in range(self.fs):
            s, active, _ = self.bank.step_with_exits(s, active, acts)
            if lower is not None:
                s = SimState(*(x.to(lower).to(x.dtype) if x.is_floating_point() else x
                               for x in s))
        out = dict(zip(s._fields, s))
        out["active"] = active
        return out

    def render(self, post: dict, flat) -> torch.Tensor:
        """The plain render of the flat (level * E + env) indices `flat` of
        `post` -> (n, H, W) u8, level by level."""
        from reference.render import render_dispatch
        from reference.sim.state import SimState

        bank = self.bank
        flat = flat.tolist()
        out = torch.empty((len(flat), self.height, self.width), dtype=torch.uint8,
                          device=self.device)
        for lv in range(self.L):
            rows = [i for i, f in enumerate(flat) if f // self.E == lv]
            if not rows:
                continue
            envs = torch.tensor([flat[i] % self.E for i in rows], device=self.device)
            sub = SimState(*(post[f][lv][envs] for f in SimState._fields))
            idx = render_dispatch(bank._at(bank.scenes, lv), bank._at(bank.pscenes, lv),
                                  bank.cfg, sub, self.width, self.height)[0]
            out[torch.tensor(rows, device=self.device)] = idx
        return out
