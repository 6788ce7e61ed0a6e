"""The sims, states and ticks the card is measured on, shared by
chip_smoke.py, tools/profile_tick.py and `peelbench`:

* `make_sim`: DoomSim on :test: at the main path's shape (256 envs at
  320x200 through portal, clip_substeps=4), any field overridden;
* `verify_ref` / `verify_state`: the 8 verify poses of
  tests/golden/verify_ref.npz as a state of a sim;
* `fallback_sim`: `make_sim` with portal_pitch="triangle" and half the
  envs pitched, so that they take the triangle fallback;
* `action_seq`: a tick's actions repeated into an (n, B, ...) sequence;
* `capture_bank_tick`: a bank's tick (`bench.bank_tick`) captured as one
  CUDA graph.

Paths are the checkout's, wherever the caller runs from.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bench import GOLDEN_DIR, bank_tick, bench_actions

B_MAIN, W_MAIN, H_MAIN = 256, 320, 200
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
METADATA = os.path.join(ROOT, "assets", "meta", "doom.toml")


def make_sim(device="cuda", **kw):
    """DoomSim on :test: at 256 envs x 320x200 through portal
    (clip_substeps=4); `kw` overrides GameConfig fields."""
    from ..models import DoomSim
    from ..utils.config import GameConfig, PlayerConfig

    base = dict(wad_file=":test:", width=W_MAIN, height=H_MAIN, batch_size=B_MAIN,
                raster_backend="portal", player=PlayerConfig(clip_substeps=4),
                metadata_file=METADATA)
    base.update(kw)
    return DoomSim(GameConfig(**base), device)


def verify_ref() -> dict:
    """tests/golden/verify_ref.npz: the 8 verify poses and their frames."""
    with np.load(os.path.join(GOLDEN_DIR, "verify_ref.npz")) as z:
        return {k: z[k] for k in z.files}


def verify_state(sim, ref):
    """`sim`'s reset state with the poses of `ref` (`verify_ref()`)."""
    s = sim.reset(ref["pos"].shape[0])
    dev = sim.device
    return s._replace(
        pos=torch.as_tensor(ref["pos"], device=dev),
        yaw=torch.as_tensor(ref["yaw"], device=dev),
        time=torch.as_tensor(ref["time"], device=dev),
        pitch=torch.as_tensor(ref["pitch"], device=dev),
        object_offset=torch.as_tensor(ref["object_offset"], device=dev),
    )


def fallback_sim(**kw):
    """(sim, state, actions): `make_sim(**kw)` with
    portal_pitch="triangle" and half the envs pitched 0.3, so that every
    pitched env takes the triangle fallback (B3, or B9 under
    portal_jnp); bench.py's actions."""
    sim = make_sim(portal_pitch="triangle", **kw)
    state = sim.reset()
    pitch = state.pitch.clone()
    pitch[: B_MAIN // 2] = 0.3
    return sim, state._replace(pitch=pitch), bench_actions(sim, B_MAIN)


def action_seq(acts, n):
    """The (n, B, ...) sequence of `acts` repeated n times, on their
    device."""
    from ..sim.state import Actions

    return Actions(*(x.expand((n,) + x.shape).contiguous() for x in acts))


def capture_bank_tick(bank, state, active, acts, width, height):
    """The bank tick captured as one CUDA graph (graphs.CapturedTick: the
    state and the active mask written back into its buffers `state_buf`,
    the actions read from `actions_buf`, every level's triangle fallback
    a WHILE node)."""
    from ..graphs import CapturedTick
    from ..sim.state import Actions, SimState

    return CapturedTick(bank_tick(bank, width, height),
                        (SimState(*(x.clone() for x in state)), active.clone()),
                        Actions(*(x.clone() for x in acts)))
