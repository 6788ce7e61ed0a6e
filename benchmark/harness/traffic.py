"""The one traffic generator: ViZDoom-style discrete action streams.

A mix (`benchmark/traffic/<mix>.json`) gives the frame skip (the tics an
agent's action is held, one frame rendered after the last of them), the
weight of each of the nine actions (normalised to shares), the turn a tic
of a turning action, and the warm-up agent steps. From the mix a pool of
trajectories is drawn, in a few large calls on the device: each env's
spawn yaw (uniform) and each (row, env)'s action, independently, from
POOL_SEED. The run's seed deals the pool's envs to the slots, in an order
of its own within each group of slots (a level of a bank). Envs interact
only through the bank's migration, so every seed runs the same set of
trajectories, and the same work: which env falls on the triangle
fallback, and for how long, sets the cost of whole steps (PERF.md, §4),
and trajectories drawn per seed moved a window's rate by 10 %. The seed
moves which slot runs which, and so which envs and steps the check
samples. Step k of a run uses row k % STREAM_STEPS of the stream; the
warm-up uses rows 0 .. warmup_steps - 1 and the windows the rows after.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Action -> (strafe, forward, turn sign, use): movement is (strafe,
# forward) in [-1, 1], look[0] the turn of a tic in radians (the step
# subtracts it from the yaw).
ACTIONS = {
    "forward": (0.0, 1.0, 0.0, False),
    "forward_left": (0.0, 1.0, 1.0, False),
    "forward_right": (0.0, 1.0, -1.0, False),
    "turn_left": (0.0, 0.0, 1.0, False),
    "turn_right": (0.0, 0.0, -1.0, False),
    "strafe_left": (-1.0, 0.0, 0.0, False),
    "strafe_right": (1.0, 0.0, 0.0, False),
    "backward": (0.0, -1.0, 0.0, False),
    "use": (0.0, 0.0, 0.0, True),
}
SEED_BITS = 63  # the seed is reduced mod 2**63 for torch.Generator
STREAM_STEPS = 1024  # rows of the stream; longer windows wrap around
POOL_SEED = 0  # the pool of trajectories every run deals out
KEYS = ("why", "frame_skip", "actions", "turn_rad", "warmup_steps")


class Stream(NamedTuple):
    """The inputs of a run, on one device: `spawn_yaw` (envs,) and per
    stream row `movement` (N, envs, 2) f32, `look` (N, envs, 2) f32 (yaw,
    pitch 0) and `use` (N, envs) bool; `zero` (envs,) bool for the action
    fields the mix never sets."""
    spawn_yaw: torch.Tensor
    movement: torch.Tensor
    look: torch.Tensor
    use: torch.Tensor
    zero: torch.Tensor

    def row(self, step: int) -> int:
        return step % self.movement.shape[0]


def check_mix(mix: dict) -> None:
    """Raise on a mix the generator cannot read."""
    missing, extra = set(KEYS) - set(mix), set(mix) - set(KEYS)
    if missing or extra:
        raise ValueError(f"traffic: keys missing {sorted(missing)}, unknown {sorted(extra)}")
    weights = mix["actions"]
    unknown = set(weights) - set(ACTIONS)
    if unknown:
        raise ValueError(f"traffic: unknown actions {sorted(unknown)}")
    if min(weights.values()) < 0 or sum(weights.values()) <= 0:
        raise ValueError("traffic: action weights must be non-negative, and one positive")
    if int(mix["frame_skip"]) < 1:
        raise ValueError("traffic: frame_skip must be at least 1")
    if int(mix["warmup_steps"]) < 0 or float(mix["turn_rad"]) < 0:
        raise ValueError("traffic: warmup_steps and turn_rad must be non-negative")


def make_stream(mix: dict, envs: int, seed: int, device, groups: int = 1) -> Stream:
    """The spawn yaws and STREAM_STEPS rows of actions of `envs` envs in `groups`
    equal groups of slots: the mix's pool, dealt to the slots by `seed`."""
    check_mix(mix)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(POOL_SEED)
    names = list(ACTIONS)
    weights = torch.tensor([float(mix["actions"].get(a, 0.0)) for a in names],
                           dtype=torch.float64, device=device)
    cdf = torch.cumsum(weights / weights.sum(), 0)
    cdf[-1] = 1.0
    table = torch.tensor([ACTIONS[a][:3] + (float(ACTIONS[a][3]),) for a in names],
                         dtype=torch.float32, device=device)
    spawn_yaw = (torch.rand(envs, generator=gen, device=device, dtype=torch.float64)
                 * (2 * math.pi) - math.pi).to(torch.float32)
    u = torch.rand((STREAM_STEPS, envs), generator=gen, device=device, dtype=torch.float64)
    code = torch.searchsorted(cdf, u, right=True).clamp_(max=len(names) - 1)
    act = table[code]  # (STREAM_STEPS, envs, 4)
    turn = act[..., 2] * float(mix["turn_rad"])
    look = torch.stack([turn, torch.zeros_like(turn)], dim=-1)
    deal = torch.Generator(device="cpu")
    deal.manual_seed(int(seed) % (1 << SEED_BITS))
    size = envs // groups
    order = torch.cat([g * size + torch.randperm(size, generator=deal)
                       for g in range(groups)]).to(device)
    return Stream(spawn_yaw[order], act[:, order, 0:2].contiguous(), look[:, order].contiguous(),
                  act[:, order, 3] > 0, torch.zeros(envs, dtype=torch.bool, device=device))
