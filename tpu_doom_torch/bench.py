"""The port's benchmark and verify leg: the twin of the repo's `bench.py`
(which drives the JAX package), on one CUDA card.

    python3 -m tpu_doom_torch.bench               # DoomSim step + render
    BENCH_BANK=1 python3 -m tpu_doom_torch.bench  # a LevelBank (config 5)
    python3 -m tpu_doom_torch.bench --verify      # portal vs portal_jnp

The benchmarks print ONE JSON line on stdout with bench.py's keys and
`metric` strings: {"metric": ..., "value": N, "unit": "env*frames/s",
"vs_baseline": N}, vs_baseline against BASELINE.json's 10k env*frames/s
per chip. On stderr they print the set-up times, the frames' checksum and
the kernel launches of the timed window (`launches {...}`).

The tick is step + render + checksum: the sum of each frame's palette
indices goes into a device accumulator, so no frame is dead. On the card
the tick is captured once as a CUDA graph (`graphs.CapturedTick`, its
state the (SimState, checksum) pair, a bank's (state, active, checksum))
and replayed: the kernels' build, an eager warm-up tick, the capture and
one warm-up replay come before the timed window, which is BENCH_TICKS
replays between two host clock reads, ending in torch.cuda.synchronize().

Runs on the card. BENCH_DEVICE=cpu asks for the CPU, where the kernels'
plain versions run eagerly (bench.py's smaller CPU defaults apply);
without a card and without it, the benchmark raises.

Knobs (environment variables), as bench.py reads them:
  BENCH_BATCH, BENCH_W, BENCH_H, BENCH_TICKS, BENCH_WAD, BENCH_BACKEND
    (the port's four names; bench.py turns "portal" into "portal_jnp" on
    the CPU, where its kernels would run in interpret mode; the port keeps
    "portal", whose plain versions run there), BENCH_RENDER_CHUNK,
    BENCH_LOOKY (1: a per-env pitch rate too);
  BENCH_ACTIVE_SEGS, BENCH_CROSSINGS, BENCH_COMPACT, BENCH_GLOBAL_MAX,
    BENCH_SELECT, BENCH_VISIBLE: the GameConfig fields bench.py sets;
  BENCH_BANK=1 and BENCH_LEVELS (4: BASELINE config 5; 8 adds two
    :stress: and two :texstress: mazes);
  BENCH_VERIFY_LEGS: the --verify legs, comma-separated (default all
    seven; bench.py's default leaves out texstress24).
BENCH_CHUNK, BENCH_UNROLL, BENCH_SCENE_CONST and BENCH_GROUP_UNROLL are
bench.py's TPU dispatch knobs (ticks chained per compiled program, scan
unroll, scene constants). They are no-ops here and not read: each tick is
one replay of the captured graph, which leaves the card idle ~0 of the
time between ticks, so chaining ticks per launch has nothing to remove.
The timed window is BENCH_TICKS ticks (bench.py times whole chunks,
max(ticks // chunk, 1) * chunk).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .sim.state import Actions, SimState

BASELINE_FPS = 10000.0  # BASELINE.json: env*frames/s per chip
WARMUP_TICKS = 1  # replays (eager ticks on the CPU) before the timed window
VERIFY_CEILING = 16  # px and cov per verify leg (bench.py:88-90)
# The texstress8 leg against its op-by-op JAX golden, px per pose: the
# card's reading, the CPU's too. An ill-conditioned floor strip there
# turned a 1-ulp difference of cos(yaw) between CUDA's libm and the CPU's
# into 23 px until the camera's trig was rounded once from float64 on both
# devices (`_numerics.cos_sin`); JAX's own jitted render moves the strip
# by 382 (ROADMAP C).
TEXSTRESS8_POSE_CEILING = 2
VERIFY_LEGS = ("test", "640x400", "texstress", "texstress_act", "texstress8",
               "texstress24", "bank")
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tests", "golden")
# BENCH_* variable -> (GameConfig field, type), as bench.py:405-424 sets them.
CONFIG_KNOBS = {
    "BENCH_ACTIVE_SEGS": ("portal_active_segs", int),
    "BENCH_CROSSINGS": ("portal_crossings", int),
    "BENCH_COMPACT": ("portal_compact_crossings", int),
    "BENCH_GLOBAL_MAX": ("portal_global_segs_max", int),
    "BENCH_SELECT": ("portal_select_rows", str),
    "BENCH_VISIBLE": ("portal_visible_segs", int),
}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def bench_device() -> torch.device:
    """BENCH_DEVICE (default the card); raises without a card unless the
    CPU is asked for."""
    from .models.doom_sim import checked_device

    return checked_device(os.environ.get("BENCH_DEVICE", "cuda"))


def bench_actions(sim, batch: int, looky: bool = False) -> Actions:
    """bench.py's ACTIVE actions (bench.py:430-455): every env walks
    forward while turning at a per-env yaw rate from numpy's
    default_rng(0); `looky` draws a per-env pitch rate first, as
    BENCH_LOOKY=1 does."""
    rng = np.random.default_rng(0)
    pitch_rate = (rng.uniform(-0.03, 0.03, batch).astype(np.float32) if looky
                  else np.zeros(batch, np.float32))
    look = np.stack([rng.uniform(-0.05, 0.05, batch).astype(np.float32), pitch_rate],
                    axis=1)
    return sim.null_actions(batch)._replace(
        movement=torch.as_tensor(np.tile(np.array([[0.0, 1.0]], np.float32), (batch, 1)),
                                 device=sim.device),
        look=torch.as_tensor(look, device=sim.device))


def bank_actions(L: int, E: int, device="cuda") -> Actions:
    """bank_main's ACTIVE actions (bench.py:303-314): walk forward, per-env
    yaw rate and a 5 % push from numpy's default_rng(0), as (L, E, ...)."""
    from .sim.state import null_actions

    rng = np.random.default_rng(0)
    look = np.stack([rng.uniform(-0.05, 0.05, L * E).astype(np.float32),
                     np.zeros(L * E, np.float32)], axis=1)
    acts = null_actions(L * E, device)._replace(
        movement=torch.as_tensor(np.tile(np.array([[0.0, 1.0]], np.float32), (L * E, 1)),
                                 device=device),
        look=torch.as_tensor(look, device=device),
        push=torch.as_tensor(rng.random(L * E) < 0.05, device=device))
    return Actions(*(x.reshape((L, E) + x.shape[1:]) for x in acts))


def sim_tick(sim, width: int, height: int):
    """bench.py's tick (bench.py:483-488) on `sim`'s level and config:
    (state, checksum) -> ((state, checksum + the frame's index sum),)."""
    from .render import render_dispatch
    from .sim.step import step as sim_step

    scene, cfg, pscene = sim.scene, sim.config, sim.portal_scene()

    def tick(carry, acts):
        state, check = carry
        state = sim_step(scene, cfg, state, acts)
        idx, _ = render_dispatch(scene, pscene, cfg, state, width, height)
        return ((state, check + idx.sum(dtype=torch.int64)),)
    return tick


def bank_check_tick(bank, width: int, height: int):
    """bank_main's tick (bench.py:324-342): step_with_exits, then each
    level's render reduced into the checksum as it is made, so that no
    more than one level's frames are live: (state, active, checksum) ->
    ((state, active, checksum),)."""
    def tick(carry, acts):
        state, active, check = carry
        state, active, _ = bank.step_with_exits(state, active, acts)
        for lv in range(bank.num_levels):
            idx, _ = bank.render_level(state, lv, width, height)
            check = check + idx.sum(dtype=torch.int64)
        return ((state, active, check),)
    return tick


def bank_tick(bank, width: int, height: int):
    """`bank_check_tick`'s frame-keeping variant: the same step and
    renders, with every level's frames stacked as the tick's output, for
    the callers that compare frames (chip_smoke.py's replays against
    eager ticks, tools/profile_tick.py): ((state, active), frames
    (L, E, H, W) u8)."""
    def tick(carry, acts):
        state, active = carry
        state, active, _ = bank.step_with_exits(state, active, acts)
        return (state, active), bank.render(state, width, height)[0]
    return tick


class Timing(NamedTuple):
    seconds: float  # the fastest timed window, host clock, ending in a synchronize
    setup_seconds: float  # build, warm-up and capture before it
    state: tuple  # the final (..., checksum)
    launches: dict  # kernel launches of the timed windows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def time_ticks(tick, state: tuple, acts: Actions, ticks: int,
               warmup: int = WARMUP_TICKS, reps: int = 1) -> Timing:
    """Time `reps` windows of `ticks` ticks of `tick(state, acts) ->
    ((state,),)`, whose state ends in its 0-d checksum, run on from one
    state; `seconds` is the fastest window's. On the card: the tick
    captured as one CUDA graph (an eager warm-up tick first), `warmup`
    replays, then the timed replays; on the CPU the same ticks eagerly.
    The launch counts are set to 0 just before the first timed window and
    read just after the last."""
    from .graphs import CapturedTick
    from .ops import launch_counts, reset_launch_counts

    dev = state[-1].device
    t0 = time.perf_counter()
    if dev.type == "cuda":
        graph = CapturedTick(tick, state, acts)
        advance = graph.replay
    else:
        carry = [state]

        def advance():
            carry[0] = tick(carry[0], acts)[0]
    for _ in range(warmup):
        advance()
    _sync(dev)
    setup = time.perf_counter() - t0
    reset_launch_counts()
    seconds = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(ticks):
            advance()
        _sync(dev)
        seconds = min(seconds, time.perf_counter() - t0)
    final = graph.state_buf if dev.type == "cuda" else carry[0]
    return Timing(seconds, setup, final, launch_counts())


def result_line(metric: str, fps: float, **extra) -> dict:
    """bench.py's JSON line."""
    return {"metric": metric, "value": round(fps, 1), "unit": "env*frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 4), **extra}


def _report(timing: Timing, label: str) -> None:
    print(f"{label}: set-up {timing.setup_seconds:.1f}s (on the card the kernels' build, the"
          f" warm-up tick, the capture and a replay), timed"
          f" {timing.seconds:.4f}s, checksum {int(timing.state[-1])}", file=sys.stderr)
    print(f"launches {json.dumps(timing.launches)}", file=sys.stderr)


def main() -> int:
    """DoomSim at bench.py's defaults (bench.py:379-533)."""
    from .models import DoomSim
    from .utils.config import GameConfig, PlayerConfig

    dev = bench_device()
    on_card = dev.type == "cuda"
    batch = _env_int("BENCH_BATCH", 256 if on_card else 4)
    width, height = _env_int("BENCH_W", 320), _env_int("BENCH_H", 200)
    ticks = _env_int("BENCH_TICKS", 32 if on_card else 4)
    wad = os.environ.get("BENCH_WAD", ":test:")
    extra = {field: kind(os.environ[name]) for name, (field, kind) in CONFIG_KNOBS.items()
             if name in os.environ}
    sim = DoomSim(GameConfig(
        wad_file=wad, width=width, height=height, batch_size=batch,
        raster_backend=os.environ.get("BENCH_BACKEND", "portal"),
        render_env_chunk=_env_int("BENCH_RENDER_CHUNK", -1),
        player=PlayerConfig(clip_substeps=4), **extra), dev)
    acts = bench_actions(sim, batch, looky=os.environ.get("BENCH_LOOKY", "0") == "1")
    check = torch.zeros((), dtype=torch.int64, device=dev)
    timing = time_ticks(sim_tick(sim, width, height), (sim.reset(batch), check), acts, ticks)
    fps = batch * ticks / timing.seconds
    _report(timing, f"bench {batch} envs x {ticks} ticks")
    print(json.dumps(result_line(
        "step+render FPS/chip (320x200, batched synthetic E1M1)"
        if (wad, width, height) == (":test:", 320, 200)
        else f"step+render FPS/chip ({width}x{height}, batched {wad})", fps)))
    return 0


def bank_main() -> int:
    """BENCH_BANK=1: BASELINE.json config 5, envs spread over mixed
    Doom1/Doom2 levels at 640x400 through the LevelBank (L, E) path with
    device-side exit migration every tick (bench.py:234-376)."""
    from .models import LevelBank
    from .tools.banks import BANK8, bank_config, bank_levels

    dev = bench_device()
    on_card = dev.type == "cuda"
    batch = _env_int("BENCH_BATCH", 4096 if on_card else 8)
    width, height = _env_int("BENCH_W", 640), _env_int("BENCH_H", 400)
    ticks = _env_int("BENCH_TICKS", 16 if on_card else 2)
    n_levels = _env_int("BENCH_LEVELS", 4)
    cfg = bank_config(width=width, height=height,
                      raster_backend=os.environ.get("BENCH_BACKEND", "portal"),
                      render_env_chunk=_env_int("BENCH_RENDER_CHUNK", -1))
    # E1M1, E1M2, MAP01, MAP02; more than 4 adds the mazes in bench.py's order.
    specs = BANK8[:min(max(n_levels, 4), len(BANK8))]
    t0 = time.perf_counter()
    levels = bank_levels(specs, cfg)
    level_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank = LevelBank(levels, cfg, dev)
    bank_stack_s = time.perf_counter() - t0
    L = bank.num_levels
    E = max(batch // L, 1)
    state = (bank.reset(E), torch.ones((L, E), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    timing = time_ticks(bank_check_tick(bank, width, height), state,
                        bank_actions(L, E, dev), ticks)
    fps = L * E * ticks / timing.seconds
    print(f"bank timings: level_build {level_build_s:.1f}s, stack {bank_stack_s:.1f}s,"
          f" trace+compile+warmup {timing.setup_seconds:.1f}s (L={L})", file=sys.stderr)
    _report(timing, f"bank {L} x {E} envs x {ticks} ticks")
    print(json.dumps(result_line(
        f"step+render FPS/chip ({width}x{height}, {L}x{E} mixed-level LevelBank)", fps)))
    return 0


# -- verify ---------------------------------------------------------------


def _golden(name: str) -> dict:
    with np.load(os.path.join(GOLDEN_DIR, name)) as z:
        return {k: z[k] for k in z.files}


def _leg(frames: dict, ref_idx, ref_cov, golden_per: str, ok: bool = True,
         golden_ceiling: int = VERIFY_CEILING) -> dict:
    """A leg's result from {backend: (idx, cov)} numpy frames (N, H, W):
    portal against portal_jnp summed over the leg (bench.py's check), and
    each backend against the JAX golden, the largest count per pose
    (`golden_per` "pose") or summed over the leg ("leg"), as chip_smoke.py
    holds it; every count held within VERIFY_CEILING, the golden's px
    within `golden_ceiling`."""
    (ik, ck), (ij, cj) = frames["portal"], frames["portal_jnp"]
    mism, cmism = int((ik != ij).sum()), int((ck != cj).sum())
    gpx = gcov = 0
    for idx, cov in frames.values():
        n = (idx != ref_idx).reshape(len(idx), -1).sum(1)
        nc = (cov != ref_cov).reshape(len(cov), -1).sum(1)
        gpx = max(gpx, int(n.max() if golden_per == "pose" else n.sum()))
        gcov = max(gcov, int(nc.max() if golden_per == "pose" else nc.sum()))
    return {"poses": len(ik), "mismatch_px": mism, "mismatch_cov": cmism,
            "golden_px": gpx, "golden_cov": gcov, "golden_per": golden_per,
            "golden_ceiling": golden_ceiling,
            "pass": bool(ok and max(mism, cmism, gcov) <= VERIFY_CEILING
                         and gpx <= golden_ceiling)}


class _Verifier:
    """The verify legs on one device. One DoomSim per fixture, its config
    swapped per leg and backend (render reads `sim.config`), so that each
    level compiles once."""

    def __init__(self, device: torch.device):
        self.device = device
        self.sims: dict = {}

    def _render(self, wad: str, state_of, width: int, height: int, **cfg) -> dict:
        """{backend: (idx, cov)} of the state `state_of(sim)` through
        portal and portal_jnp, with bench.py's verify config."""
        from .models import DoomSim
        from .utils.config import GameConfig, PlayerConfig

        base = GameConfig(wad_file=wad, width=width, height=height, batch_size=8,
                          render_env_chunk=0, player=PlayerConfig(clip_substeps=1), **cfg)
        if wad not in self.sims:
            self.sims[wad] = DoomSim(base, self.device)
        sim = self.sims[wad]
        out = {}
        for backend in ("portal", "portal_jnp"):
            sim.config = dataclasses.replace(base, raster_backend=backend)
            out[backend] = tuple(x.cpu().numpy() for x in sim.render(state_of(sim)))
        return out

    def test_leg(self, width=320, height=200, golden="verify_ref.npz") -> dict:
        """The 8 feature-covering poses on :test: (bench.py:37-93), their
        state fields from the JAX golden made at the same size."""
        ref = _golden(golden)

        def state_of(sim):
            return sim.reset(len(ref["pos"]))._replace(**{
                k: torch.as_tensor(ref[k], device=self.device)
                for k in ("pos", "yaw", "time", "pitch", "object_offset")})
        frames = self._render(":test:", state_of, width, height, portal_crossings=12)
        return _leg(frames, ref["idx"], ref["cov"], "pose")

    def texstress_leg(self, kc=0, cap=None) -> dict:
        """:texstress: (bench.py:96-145): the 8 states of the JAX golden
        (24 ticks into the maze, env 1 pitched), loaded rather than
        re-stepped; `kc` sets the crossing-compaction budget, `cap`
        portal_global_segs_max (1024: the active-set path). The golden was
        rendered with compaction off. At kc = 8 envs leave the portal path
        for the triangle path, env 1 (pitched) among them, so that leg is
        held to verify_texstress8_ref.npz, the JAX package's render of the
        same states at kc = 8 run op by op, per pose within
        TEXSTRESS8_POSE_CEILING (ROADMAP C)."""
        ref = _golden("verify_texstress_ref.npz")
        golden = _golden("verify_texstress8_ref.npz") if kc == 8 else ref
        extra = {"portal_compact_crossings": kc} if kc else {}
        if cap is not None:
            extra["portal_global_segs_max"] = cap
        state = SimState(*(torch.as_tensor(ref[k], device=self.device)
                           for k in SimState._fields))
        frames = self._render(":texstress:", lambda sim: state, 320, 200, **extra)
        if kc == 8:
            return _leg(frames, golden["idx"], golden["cov"], "pose",
                        golden_ceiling=TEXSTRESS8_POSE_CEILING)
        return _leg(frames, golden["idx"], golden["cov"], "leg")

    def bank_leg(self) -> dict:
        """The bank (bench.py:148-187): E1M1 and MAP01 on padded stacked
        tables, 4 envs each at reset with the golden's yaws. Run at 640x400,
        the size of its JAX golden (bench.py renders this leg at 320x200)."""
        from .tools.banks import BANK5, make_bank
        from .utils.config import PlayerConfig

        ref = _golden("verify_bank_ref.npz")
        frames, same_start = {}, True
        for backend in ("portal", "portal_jnp"):
            bank = make_bank(BANK5[0:1] + BANK5[2:3], self.device, raster_backend=backend,
                             render_env_chunk=0, player=PlayerConfig(clip_substeps=1))
            s = bank.reset(ref["yaw"].shape[1])
            same_start &= bool(np.array_equal(s.pos.cpu().numpy(), ref["pos"]))
            idx, cov = bank.render(s._replace(yaw=torch.as_tensor(ref["yaw"],
                                                                  device=self.device)))
            frames[backend] = (idx.flatten(0, 1).cpu().numpy(), cov.flatten(0, 1).cpu().numpy())
        h, w = ref["idx"].shape[-2:]
        return _leg(frames, ref["idx"].reshape(-1, h, w), ref["cov"].reshape(-1, h, w),
                    "pose", ok=same_start)

    def run(self, leg: str) -> dict:
        return {
            "test": self.test_leg,
            "640x400": lambda: self.test_leg(640, 400, "verify_640x400_ref.npz"),
            "texstress": self.texstress_leg,
            "texstress_act": lambda: self.texstress_leg(cap=1024),
            "texstress8": lambda: self.texstress_leg(8),
            "texstress24": lambda: self.texstress_leg(24),
            "bank": self.bank_leg,
        }[leg]()


def verify() -> int:
    """Every kernel configuration of the port, through portal (B2, and B3
    in its fallback) against portal_jnp (B7, B8; B9) on the same device,
    within VERIFY_CEILING px and cov per leg (bench.py:190-231), and both
    against the JAX package's golden frames of the same states. Prints
    one JSON line with each leg's counts; exit 1 if any leg fails."""
    from .ops import launch_counts, reset_launch_counts

    dev = bench_device()
    legs = [x.strip() for x in os.environ.get("BENCH_VERIFY_LEGS",
                                              ",".join(VERIFY_LEGS)).split(",")]
    out = {"metric": "on-device kernel verification",
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "legs": {}}
    verifier = _Verifier(dev)
    reset_launch_counts()
    for leg in legs:
        out["legs"][leg] = verifier.run(leg)
    out["pass"] = all(r["pass"] for r in out["legs"].values())
    print(f"launches {json.dumps(launch_counts())}", file=sys.stderr)
    print(json.dumps(out))
    return 0 if out["pass"] else 1


def run(argv) -> int:
    if "--verify" in argv:
        return verify()
    if os.environ.get("BENCH_BANK", "0") == "1":
        return bank_main()
    return main()


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
