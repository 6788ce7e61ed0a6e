"""Command-line interface of the port: `python -m tpu_doom_torch.cli`.

The twin of the JAX package's `tpu_doom/cli.py`, with its flags and
subcommands (reference: src/main.rs, flags -i/--iwad, -m/--metadata,
-r/--resolution, -l/--level, -f/--fov; subcommands `check` and
`list-levels`), plus `--device`: the card by default, `--device cpu`
runs the kernels' plain versions, and without a card the default raises.
Batch subcommands: `bench` (the captured step + render + checksum tick
of `tpu_doom_torch.bench`, null actions), `demo` (PNG screenshots),
`run` (headless scripted ticks with the FrameTimers 1 Hz summary),
`dump-frames` (PARITY.md's reference-parity kit) and `play` (the ANSI
terminal viewer); no subcommand runs 600 headless ticks. Use `--iwad
:test:` for the synthetic fixture IWAD (no WAD ships with this repo).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import struct
import sys
import zlib

import numpy as np
import torch

log = logging.getLogger("tpu_doom_torch")


def parse_resolution(text: str) -> tuple[int, int]:
    """WIDTHxHEIGHT (ref main.rs:141-162)."""
    try:
        w, h = text.split("x", 1)
        return int(w), int(h)
    except ValueError:
        raise argparse.ArgumentTypeError("resolution format must be WIDTHxHEIGHT")


def write_png(path: str, rgb: np.ndarray):
    """Minimal PNG writer (no imaging deps in the environment)."""
    h, w, _ = rgb.shape

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    rows = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(
            b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows))
            + chunk(b"IEND", b"")
        )


def build_parser() -> argparse.ArgumentParser:
    from . import __version__
    from .render.raster import RASTER_BACKENDS

    p = argparse.ArgumentParser(prog="tpu-doom-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--version", action="version", version=f"tpu-doom-torch {__version__}")
    p.add_argument("-i", "--iwad", default="doom1.wad", help="IWAD file (':test:' = synthetic)")
    p.add_argument("-m", "--metadata", default="assets/meta/doom.toml")
    p.add_argument(
        "-r", "--resolution", type=parse_resolution, default=(1280, 720),
        metavar="WIDTHxHEIGHT",
    )
    p.add_argument("-l", "--level", type=int, default=0)
    p.add_argument("-f", "--fov", type=float, default=65.0)
    p.add_argument("-b", "--batch", type=int, default=1)
    p.add_argument(
        "--backend", default="auto", choices=RASTER_BACKENDS,
        help="rasterizer backend (GameConfig.raster_backend); the JAX package's "
             "pallas, pallas_interpret and portal_interpret are TPU and interpret "
             "modes the port does not have",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the sim runs: the card, or the CPU with the kernels' "
                        "plain versions")
    sub = p.add_subparsers(dest="command")
    sub.add_parser("check", help="load metadata and all levels, then exit")
    sub.add_parser("list-levels", help="list level names and indices")
    demo = sub.add_parser("demo", help="render a short scripted flythrough to PNGs")
    demo.add_argument("--ticks", type=int, default=120)
    demo.add_argument("--every", type=int, default=30)
    demo.add_argument("--out", default="/tmp/tpu_doom_demo")
    runp = sub.add_parser("run", help="headless scripted ticks with timers")
    runp.add_argument("--ticks", type=int, default=600)
    playp = sub.add_parser("play", help="interactive ANSI terminal viewer")
    playp.add_argument("--fps", type=float, default=15.0)
    bench = sub.add_parser("bench", help="step+render throughput benchmark")
    bench.add_argument("--ticks", type=int, default=64)
    bench.add_argument("--warmup", type=int, default=8)
    bench.add_argument("--json", action="store_true")
    dump = sub.add_parser(
        "dump-frames",
        help="reference-parity kit: palette-index frames along a fixed "
        "deterministic camera path (see PARITY.md for the recipe to "
        "capture the same path from the reference build)",
    )
    dump.add_argument("--ticks", type=int, default=300)
    dump.add_argument("--every", type=int, default=10)
    dump.add_argument("--out", default="/tmp/tpu_doom_frames")
    dump.add_argument("--png", action="store_true",
                      help="also write RGB PNGs next to the .npy frames")
    return p


def make_sim(args):
    from .models import DoomSim
    from .utils.config import GameConfig

    cfg = GameConfig(
        wad_file=args.iwad,
        metadata_file=args.metadata,
        fov=args.fov,
        width=args.resolution[0],
        height=args.resolution[1],
        initial_level_index=args.level,
        batch_size=args.batch,
        raster_backend=args.backend,
    )
    return DoomSim(cfg, args.device)


def scripted_actions(sim, state, t):
    """A simple deterministic pilot: walk forward, sweep the view, push.
    Built on the state's device from Python scalars (fills, no copy from
    the host)."""
    b, dev = state.pos.shape[0], state.pos.device
    phase = (t // 90) % 4
    fwd = -1.0 if phase in (0, 2) else 0.0
    turn = 0.02 if phase in (1, 3) else 0.0

    def pair(x, y):
        return torch.stack([torch.full((b,), x, dtype=torch.float32, device=dev),
                            torch.full((b,), y, dtype=torch.float32, device=dev)], 1)

    return sim.null_actions(b)._replace(
        movement=pair(0.0, fwd),
        look=pair(turn, 0.0),
        push=torch.full((b,), t % 35 == 0, dtype=torch.bool, device=dev),
    )


def _sync(sim) -> None:
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


def cmd_check(args) -> int:
    sim = make_sim(args)
    elapsed = sim.check()
    log.info("done loading all %d levels in %.4fs", sim.num_levels, elapsed)
    return 0


def cmd_list_levels(args) -> int:
    from .models.doom_sim import open_wad

    wad = open_wad(args.iwad)
    for i in range(wad.num_levels):
        name = wad.level_name(i).rstrip(b"\0").decode("ascii", "replace")
        print(f"{i:3} {name:8}")
    return 0


def cmd_demo(args) -> int:
    sim = make_sim(args)
    os.makedirs(args.out, exist_ok=True)
    state = sim.reset(args.batch)
    for t in range(args.ticks):
        state = sim.step(state, scripted_actions(sim, state, t))
        if t % args.every == 0:
            rgb = sim.render_rgb(state)
            write_png(f"{args.out}/frame_{t:05d}.png", rgb[0])
            log.info("wrote %s/frame_%05d.png", args.out, t)
    return 0


def cmd_run(args) -> int:
    from .utils.timers import FrameTimers

    sim = make_sim(args)
    state = sim.reset(args.batch)
    timers = FrameTimers()
    for t in range(args.ticks):
        with timers.time("tick"):
            state = sim.step(state, scripted_actions(sim, state, t))
        with timers.time("frame"):
            idx, cov = sim.render(state)
            _sync(sim)
        timers.maybe_log()
    pos = state.pos[0].cpu().numpy()
    log.info("final player pos env0: %s", pos)
    return 0


def cmd_play(args) -> int:
    from .utils.viewer import play

    sim = make_sim(args)
    w = min(args.resolution[0], 200)
    h = min(args.resolution[1], 120)
    play(sim, fps=args.fps, width=w, height=h)
    return 0


def cmd_bench(args) -> int:
    """`args.warmup` + `args.ticks` ticks of step + render with null
    actions, timed as `tpu_doom_torch.bench` times its tick: on the card
    the tick captured as a CUDA graph and replayed."""
    from .bench import result_line, sim_tick, time_ticks

    sim = make_sim(args)
    b = args.batch
    w, h = sim.config.width, sim.config.height
    check = torch.zeros((), dtype=torch.int64, device=sim.device)
    timing = time_ticks(sim_tick(sim, w, h), (sim.reset(b), check), sim.null_actions(b),
                        args.ticks, warmup=args.warmup)
    fps = b * args.ticks / timing.seconds
    print(json.dumps(result_line("step+render FPS/chip", fps, batch=b,
                                 resolution=f"{w}x{h}")))
    return 0


def cmd_dump_frames(args) -> int:
    """Reference-parity kit (PARITY.md): run the deterministic scripted
    pilot from the level start and dump palette-index frames + the exact
    camera state per dump, so the same path can be replayed against the
    reference renderer when a real WAD/GL environment exists."""
    sim = make_sim(args)
    os.makedirs(args.out, exist_ok=True)
    state = sim.reset(args.batch)
    manifest = {
        "iwad": args.iwad,
        "level": args.level,
        "resolution": list(args.resolution),
        "fov": args.fov,
        "ticks": args.ticks,
        "every": args.every,
        "pilot": "scripted_actions (cli.py): phase = (t//90)%4; "
                 "fwd=-1 in phases 0/2, turn +0.02 rad/tick in 1/3, "
                 "push every 35 ticks",
        "frames": [],
    }
    for t in range(args.ticks):
        state = sim.step(state, scripted_actions(sim, state, t))
        if t % args.every != 0:
            continue
        idx, cov = sim.render(state)
        frame = idx[0].cpu().numpy()
        np.save(f"{args.out}/frame_{t:05d}.npy", frame)
        if args.png:
            rgb = sim.render_rgb(state)
            write_png(f"{args.out}/frame_{t:05d}.png", rgb[0])
        manifest["frames"].append(
            {
                "tick": t + 1,
                "file": f"frame_{t:05d}.npy",
                "pos": [float(x) for x in state.pos[0].cpu().numpy()],
                "yaw": float(state.yaw[0]),
                "pitch": float(state.pitch[0]),
                "time": float(state.time[0]),
            }
        )
    with open(f"{args.out}/manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    log.info("wrote %d frames + manifest.json to %s", len(manifest["frames"]), args.out)
    return 0


COMMANDS = {
    "check": cmd_check,
    "list-levels": cmd_list_levels,
    "demo": cmd_demo,
    "run": cmd_run,
    "play": cmd_play,
    "bench": cmd_bench,
    "dump-frames": cmd_dump_frames,
}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.command is None:
        # Default (no subcommand): headless run (no display in this environment).
        return cmd_run(argparse.Namespace(**{**vars(args), "ticks": 600}))
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
