"""The bench tick's time by stage, each stage its own captured tick: the
twin of tools/stagebudget.py.

    python3 -m tpu_doom_torch.tools.stagebudget [stage ...]

Stages (default: all four), each a tick of (state, checksum):
  full    the bench's tick, `bench.sim_tick` (step, render, checksum of
          the frame's palette indices);
  step    `sim/step.py:step`, checksum over state.tick;
  render  `render_dispatch` with time advanced by 1/60 per tick
          (tools/stagebudget.py:103), checksum of the frame;
  walk    `render/portal.py:walk` over the whole batch, the active set and
          the select kernel engaged as `render_portal_zero_pitch` engages
          them, time advanced by 1/60, checksum of WALK_SAMPLE elements of
          its records and of its words, spread over each: a fixed cost
          that keeps the outputs live (a replayed graph drops no kernel)
          and moves with no change to the walk or its layout.
The JAX tool's usage line also names `kernel`, which has no body there;
an unknown stage exits with a message.

Each stage's tick is captured as one CUDA graph and timed by
`bench.time_ticks`, as `perfcmp.run_one` times the bench's: one warm-up
replay, then the best of BENCH_REPS windows of max(BENCH_TICKS //
BENCH_CHUNK, 1) * BENCH_CHUNK replays. Prints per stage "<stage>: <ms> ms/tick (B=<batch>)  [<N>
env-fps]", then step + render - full when all three ran. Environment as
`perfcmp`'s, plus CFG="key=val,..." GameConfig overrides parsed by
`perfcmp.parse`. Runs on the card; BENCH_DEVICE=cpu asks for the CPU.
"""

from __future__ import annotations

import os
import sys

import torch

from ..bench import bench_actions, bench_device, sim_tick, time_ticks
from . import device_label
from .perfcmp import Point, bench_config, make_sim, parse

STAGES = ("full", "step", "render", "walk")
FRAME_DT = 1.0 / 60.0  # the render and walk stages' time step
WALK_SAMPLE = 4096  # elements of each walk output its checksum reads


def sample_sum(x: torch.Tensor) -> torch.Tensor:
    """int64 sum of the bits of WALK_SAMPLE elements of the 4-byte tensor
    `x`, evenly strided over it: a read of fixed size whatever `x`'s."""
    flat = x.view(-1).view(torch.int32)  # a view: raises rather than copy
    return flat[::max(flat.numel() // WALK_SAMPLE, 1)][:WALK_SAMPLE].sum(dtype=torch.int64)


def stage_tick(name: str, sim, width: int, height: int):
    """The tick of stage `name` on `sim`'s level and config: (state,
    checksum) -> ((state, checksum),)."""
    from ..render import render_dispatch
    from ..render.portal import active_segs, walk
    from ..sim.step import step as sim_step

    if name == "full":
        return sim_tick(sim, width, height)
    scene, cfg, pscene = sim.scene, sim.config, sim.portal_scene()
    if name == "step":
        def tick(carry, acts):
            state, check = carry
            state = sim_step(scene, cfg, state, acts)
            return ((state, check + state.tick.sum(dtype=torch.int64)),)
    elif name == "render":
        def tick(carry, acts):
            state, check = carry
            state = state._replace(time=state.time + FRAME_DT)
            idx, _ = render_dispatch(scene, pscene, cfg, state, width, height)
            return ((state, check + idx.sum(dtype=torch.int64)),)
    elif name == "walk":
        if pscene is None:
            raise SystemExit("stagebudget: the walk stage needs a portal backend")
        act = 0 if cfg.raster_backend == "portal_jnp" else active_segs(pscene, cfg)
        n_cross = int(cfg.portal_crossings)

        def tick(carry, acts):
            state, check = carry
            state = state._replace(time=state.time + FRAME_DT)
            records, words, _ = walk(pscene, scene, cfg, width, height, n_cross, state,
                                     active_segs=act)
            check = check + sample_sum(records) + sample_sum(words)
            return ((state, check),)
    else:
        raise SystemExit(f"stagebudget: unknown stage {name!r}; stages: {' '.join(STAGES)}")
    return tick


def run_stage(name: str, sim, point: Point):
    """Stage `name` at `point` from `sim`'s reset state -> (best window's
    ms per tick, final (state, checksum))."""
    dev = sim.device
    tick = stage_tick(name, sim, point.width, point.height)
    state = (sim.reset(point.batch), torch.zeros((), dtype=torch.int64, device=dev))
    timing = time_ticks(tick, state, bench_actions(sim, point.batch), point.ticks,
                        reps=point.reps)
    return timing.seconds / point.ticks * 1e3, timing.state


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    stages = [a for a in args if not a.startswith("-")] or list(STAGES)
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        raise SystemExit(f"stagebudget: unknown stage(s) {' '.join(unknown)};"
                         f" stages: {' '.join(STAGES)}")
    overrides = parse(os.environ["CFG"]) if os.environ.get("CFG") else {}
    dev = bench_device()
    point = Point.from_env()
    sim = make_sim(bench_config(point, overrides), dev)
    print(f"[stagebudget] {point.wad} {point.width}x{point.height} x {point.batch} envs"
          f" on {device_label(dev)}; best of {point.reps} windows of {point.ticks}"
          " replayed ticks", flush=True)
    results = {}
    for name in stages:
        ms, _ = run_stage(name, sim, point)
        results[name] = ms
        print(f"{name:>8}: {ms:8.2f} ms/tick (B={point.batch})  "
              f"[{point.batch * 1e3 / ms:.1f} env-fps]", flush=True)
    if all(s in results for s in ("full", "step", "render")):
        print(f"  (step+render - full overlap: "
              f"{results['step'] + results['render'] - results['full']:.2f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
