"""The share of envs that leave the portal path for the triangle fallback
over the bench trajectory, at shipped defaults: the twin of
tools/fallbackrate.py.

    python3 -m tpu_doom_torch.tools.fallbackrate

Steps BENCH_BATCH envs (64) of BENCH_WAD (`:texstress:`) for BENCH_TICKS
ticks (32) with the bench's active actions (`bench.bench_actions`: walk
forward, a per-env yaw rate from default_rng(0) in +-0.05) and, before
each step, walks every env at 320x200 and reads the walk's `overflow`
(render/portal.py:walk's aux) on the host. The JAX tool's setup:
raster_backend="portal", clip_substeps=1 (the bench steps with 4), the
active set engaged where the level's compact table exceeds
portal_global_segs_max (tools/fallbackrate.py:42-43). Prints one JSON
line with the JAX tool's keys (wad, envs, ticks, fallback_rate,
portal_rate), and the device and the overflowing envs per tick on
stderr. An instrument: the host reads every tick. Runs on the card;
BENCH_DEVICE=cpu asks for the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..bench import bench_actions, bench_device
from . import device_label
from .fixtures import METADATA

JSON_KEYS = ("wad", "envs", "ticks", "fallback_rate", "portal_rate")


def rate_sim(wad: str, batch: int, width: int, height: int, device):
    """The JAX tool's DoomSim: portal, clip_substeps=1."""
    from ..models import DoomSim
    from ..utils.config import GameConfig, PlayerConfig

    return DoomSim(GameConfig(wad_file=wad, width=width, height=height, batch_size=batch,
                              raster_backend="portal", metadata_file=METADATA,
                              player=PlayerConfig(clip_substeps=1)), device)


def rate_walk(pscene, scene, cfg, width: int, height: int, state):
    """The walk this tool reads, with the active set where the level needs
    it -> (records, words, overflow (B,) bool: the envs that overflow the
    portal path's budgets)."""
    from ..render.portal import active_segs, walk

    records, words, aux = walk(pscene, scene, cfg, width, height, int(cfg.portal_crossings),
                               state, active_segs=active_segs(pscene, cfg))
    return records, words, aux["overflow"]


@torch.no_grad()
def overflow_ticks(sim, ticks: int, width: int, height: int):
    """Yield (state, overflow (B,) bool) for each of `ticks` ticks from
    reset, stepping with the bench's actions after each."""
    batch = sim.config.batch_size
    acts = bench_actions(sim, batch)
    state = sim.reset(batch)
    pscene = sim.portal_scene()
    for _ in range(ticks):
        yield state, rate_walk(pscene, sim.scene, sim.config, width, height, state)[2]
        state = sim.step(state, acts)


def fallback_rate(wad: str = ":texstress:", batch: int = 64, ticks: int = 32,
                  width: int = 320, height: int = 200, device="cuda") -> dict:
    """The JAX tool's result (`JSON_KEYS`, rates rounded to 4 places)
    plus `overflow_per_tick`, the overflowing envs of each tick."""
    sim = rate_sim(wad, batch, width, height, device)
    per_tick = [int(ov.sum()) for _, ov in overflow_ticks(sim, ticks, width, height)]
    over, total = sum(per_tick), batch * ticks
    return {"wad": wad, "envs": batch, "ticks": ticks,
            "fallback_rate": round(over / max(total, 1), 4),
            "portal_rate": round(1 - over / max(total, 1), 4),
            "overflow_per_tick": per_tick}


def main() -> int:
    dev = bench_device()
    r = fallback_rate(os.environ.get("BENCH_WAD", ":texstress:"),
                      int(os.environ.get("BENCH_BATCH", "64")),
                      int(os.environ.get("BENCH_TICKS", "32")), device=dev)
    print(f"fallbackrate on {device_label(dev)}: overflowing envs per tick"
          f" {r['overflow_per_tick']}", file=sys.stderr)
    print(json.dumps({k: r[k] for k in JSON_KEYS}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
