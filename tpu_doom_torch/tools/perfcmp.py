"""A/B timer of the bench's captured tick under GameConfig overrides: the
twin of tools/perfcmp.py, which times the JAX package's step + render.

    python3 -m tpu_doom_torch.tools.perfcmp [group ...]

e.g. `python3 -m tpu_doom_torch.tools.perfcmp portal_compact_crossings=8
portal_compact_crossings=4`. Each group is `field=value[,field=value...]`
(True / False, an int, a float or a string), applied on top of the bench
defaults (`:test:`, 256 envs at 320x200, clip_substeps=4, the bench's
active actions); PlayerConfig fields go to the player. With no group, one
run at the defaults. One line per group: "<group>: <N> env-fps".

Each group's tick is `bench.sim_tick` under that group's own GameConfig,
timed by `bench.time_ticks`: captured as one CUDA graph
(`graphs.CapturedTick`) and replayed, one warm-up replay, then BENCH_REPS
windows of max(BENCH_TICKS // BENCH_CHUNK, 1) * BENCH_CHUNK replays, each
between two host clock reads ending in a synchronize; the best window
counts. BENCH_CHUNK only sizes the window:
the JAX tool's scan chunk (ticks per compiled program) has no meaning for
a replayed graph. BENCH_UNROLL is read by nothing. Groups share their
level's scene tensors (a sim per wad, level and metadata file), never its
config.

Two captures of the same tick can run ~9 % apart (on an H100, 40,800
against 44,400 env*frames/s at the defaults; PERF.md §5): give each side
of an A/B several groups and compare their spreads, not single lines.

`ENV.KEY=VAL` items set KEY in the environment for that group's run,
whose sim is built anew, and put the environment back after. The JAX
tool's hooks were read at trace time; nothing in the port reads such a
hook today.

Environment: BENCH_WAD (:test:), BENCH_BATCH (256), BENCH_W (320),
BENCH_H (200), BENCH_TICKS (32), BENCH_CHUNK (8), BENCH_REPS (3). Runs on
the card; BENCH_DEVICE=cpu asks for the CPU (the kernels' plain versions,
eager ticks: a check of the tool, no device time).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import NamedTuple

import torch

from ..bench import bench_actions, bench_device, sim_tick, time_ticks
from . import device_label
from .fixtures import METADATA


class Point(NamedTuple):
    """The bench point a tool times: level, batch, image, and the replays
    per window (`ticks`) of `reps` windows."""

    wad: str = ":test:"
    batch: int = 256
    width: int = 320
    height: int = 200
    ticks: int = 32
    reps: int = 3

    @classmethod
    def from_env(cls) -> "Point":
        """BENCH_WAD / BATCH / W / H / REPS; BENCH_TICKS rounded down to
        whole BENCH_CHUNKs (at least one), as the JAX tools count ticks."""
        chunk = int(os.environ.get("BENCH_CHUNK", "8"))
        ticks = max(int(os.environ.get("BENCH_TICKS", "32")) // chunk, 1) * chunk
        return cls(os.environ.get("BENCH_WAD", ":test:"),
                   int(os.environ.get("BENCH_BATCH", "256")),
                   int(os.environ.get("BENCH_W", "320")),
                   int(os.environ.get("BENCH_H", "200")),
                   ticks, int(os.environ.get("BENCH_REPS", "3")))


def parse(group: str) -> dict:
    """`key=value[,key=value...]` -> {key: True / False, int, float or
    str} (tools/perfcmp.py:119-137); SystemExit on an item without `=`."""
    out = {}
    for kv in group.split(","):
        parts = kv.split("=", 1)
        if len(parts) != 2:
            raise SystemExit(
                f"bad override {kv!r}; usage: key=value[,key=value...]")
        k, v = parts
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def split_overrides(ov: dict) -> tuple[dict, dict]:
    """(PlayerConfig fields, GameConfig fields) of the overrides
    (tools/perfcmp.py:65-68)."""
    from ..utils.config import PlayerConfig

    pfields = {f.name for f in dataclasses.fields(PlayerConfig)}
    pkw, gkw = {}, {}
    for k, v in ov.items():
        (pkw if k in pfields else gkw)[k] = v
    return pkw, gkw


def bench_config(point: Point, overrides: dict):
    """The JAX tools' GameConfig at `point` (portal, clip_substeps=4) with
    the overrides applied; an override of one of those fields wins, where
    the JAX tools raise."""
    from ..utils.config import GameConfig, PlayerConfig

    pkw, gkw = split_overrides(overrides)
    base = dict(wad_file=point.wad, width=point.width, height=point.height,
                batch_size=point.batch, raster_backend="portal", metadata_file=METADATA)
    return GameConfig(**{**base, **gkw},
                      player=PlayerConfig(**{"clip_substeps": 4, **pkw}))


def make_sim(cfg, device, sims=None):
    """A DoomSim running `cfg`. With a dict `sims`, one sim per level
    (wad, metadata file, level index: what its scene tensors depend on)
    is kept there and reused with `cfg` set as its config, after the
    checks DoomSim makes of a new config."""
    from ..models import DoomSim
    from ..render.raster import check_raster_backend
    from ..sim.step import check_collision_config

    key = (cfg.wad_file, cfg.metadata_file, cfg.initial_level_index, str(device))
    if sims is None or key not in sims:
        sim = DoomSim(cfg, device)
        if sims is not None:
            sims[key] = sim
        return sim
    check_raster_backend(cfg.raster_backend)
    check_collision_config(cfg.player)
    sim = sims[key]
    sim.config = cfg
    return sim


def run_one(overrides: dict, device="cuda", sims=None, point: Point | None = None) -> float:
    """env*frames/s of the bench's tick (`bench.sim_tick`: step + render +
    checksum) under the overrides, best of `point.reps` windows of
    `point.ticks` replays (`point` defaults to the BENCH_* environment);
    `sims` as `make_sim`'s."""
    from ..models.doom_sim import checked_device

    point = point or Point.from_env()
    dev = checked_device(device)
    cfg = bench_config(point, overrides)
    sim = make_sim(cfg, dev, sims)
    check = torch.zeros((), dtype=torch.int64, device=dev)
    timing = time_ticks(sim_tick(sim, point.width, point.height),
                        (sim.reset(point.batch), check),
                        bench_actions(sim, point.batch), point.ticks, reps=point.reps)
    return point.batch * point.ticks / timing.seconds


def main(argv=None) -> int:
    groups = (sys.argv[1:] if argv is None else list(argv)) or [""]
    dev = bench_device()
    point = Point.from_env()
    print(f"[perfcmp] {point.wad} {point.width}x{point.height} x {point.batch} envs on"
          f" {device_label(dev)}; best of {point.reps} windows of {point.ticks}"
          " replayed ticks", flush=True)
    sims: dict = {}
    for g in groups:
        ov = parse(g) if g else {}
        envs = {k[4:]: str(v) for k, v in ov.items() if k.startswith("ENV.")}
        ov = {k: v for k, v in ov.items() if not k.startswith("ENV.")}
        saved = {k: os.environ.get(k) for k in envs}
        os.environ.update(envs)
        try:
            fps = run_one(ov, dev, None if envs else sims, point)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print(f"{g or '(default)'}: {fps:.1f} env-fps", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
