"""Move-effect animation: doors/lifts sliding between height offsets.

Port of `tpu_doom/sim/effects.py` (3 unrolled masked phase passes; see
its docstring for why three cover the reference's inner loop).
"""

from __future__ import annotations

import torch

from .._numerics import f32


def animate_effects(state, timestep: float) -> dict:
    """Advance all active effects by one tick; returns the updated
    (object_offset, eff_*) fields as a dict of (B, O) tensors."""
    offset = state.object_offset
    active = state.eff_active
    first = state.eff_first
    second = state.eff_second
    has_second = state.eff_has_second
    wait = state.eff_wait
    speed = state.eff_speed
    budget = torch.where(active, f32(timestep), 0.0)

    done = torch.zeros_like(active)
    for _ in range(3):
        run = active & ~done
        needs_move = run & (first != offset)
        diff = first - offset
        sign = torch.sign(diff)
        time_to_target = torch.abs(diff) / torch.clamp_min(speed, 1e-30)
        partial = needs_move & (time_to_target > budget)
        offset = torch.where(
            needs_move,
            torch.where(partial, offset + sign * speed * budget, first),
            offset,
        )
        budget = torch.where(needs_move & ~partial, budget - time_to_target, budget)
        stalled = partial
        run = run & ~stalled

        wait_blocks = run & (wait > budget)
        wait = torch.where(wait_blocks, wait - budget, wait)
        budget = torch.where(run & ~wait_blocks, budget - wait, budget)
        wait = torch.where(run & ~wait_blocks, 0.0, wait)
        run = run & ~wait_blocks

        promote = run & has_second
        first = torch.where(promote, second, first)
        has_second = torch.where(promote, False, has_second)
        finished = run & ~promote
        active = torch.where(finished, False, active)
        done = done | stalled | wait_blocks | finished

    return dict(
        object_offset=offset,
        eff_active=active,
        eff_first=first,
        eff_second=second,
        eff_has_second=has_second,
        eff_wait=wait,
        eff_speed=speed,
    )
