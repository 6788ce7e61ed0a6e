"""How `correct` is decided: what the window produced against the plain
reference (`benchmark/reference/`), step by step from the program's own
state.

The port's envs keep their state on the device from tic to tic, and the
reference cannot follow every tic of a window in the time a run allows.
So the check takes, at a few agent steps drawn from the seed and at the
window's last step, the program's state before and after the step and
the frames it rendered for a sample of envs drawn from the seed; the
reference steps every env from the same state with the same actions
(exit migration included) and renders the sampled envs from its own
result. The program's reset state is checked against the reference's by
itself (the start). Two numbers are compared, each with its limit from
the configuration's `limits`:

* state_err: the largest |program - reference| / max(1, |reference|)
  over every float of every env's state (NaN against NaN counts 0), and
  1 for any integer or bool entry that differs (exit flags, triggers,
  doors, ticks, the bank's active slots);
* frame_px: the most palette indices that differ in one sampled frame.
"""

from __future__ import annotations

import torch

NUMBERS = ("state_err", "frame_px")


def state_err(prog: dict, ref: dict) -> float:
    """state_err of two states with the same fields."""
    err = 0.0
    for name, want in ref.items():
        got = prog[name].to(want.device)
        if got.shape != want.shape:
            return float("inf")
        if want.is_floating_point():
            g, w = got.double(), want.double()
            both_nan = torch.isnan(g) & torch.isnan(w)
            d = torch.where(both_nan, torch.zeros_like(w),
                            (g - w).abs() / torch.clamp(w.abs(), min=1.0))
            d = torch.nan_to_num(d, nan=float("inf"))
            if d.numel():
                err = max(err, float(d.max()))
        elif bool((got != want).any()):
            err = max(err, 1.0)
    return err


def frame_px(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """The most differing pixels in one of the frames (n, H, W)."""
    prog = prog.to(ref.device)
    if prog.shape != ref.shape:
        return ref[0].numel()
    return int((prog != ref).reshape(len(ref), -1).sum(1).max()) if len(ref) else 0


def judge(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in NUMBERS)


def check_lines(readings: dict, limits: dict) -> list[str]:
    return [f"check {k} {readings[k]!r} limit {limits[k]!r}" for k in NUMBERS]


@torch.no_grad()
def run_check(reference, start: dict, snapshots: list, stream, sample, limits: dict,
              lower=None):
    """The readings of the program's `start` state and `snapshots` ((k,
    pre, post, frames) per checked agent step) against `reference`, and
    how many of those 1 + len(snapshots) items read over a limit. With
    `lower` (a dtype), also the control's readings: the reference
    computed with its state in that dtype, in the program's place, on
    the same steps; else None."""
    readings = {"state_err": state_err(start, reference.start()), "frame_px": 0}
    failed = int(not judge(readings, limits))
    control = dict(readings) if lower is not None else None
    for k, pre, post, frames in snapshots:
        want = reference.agent_step(pre, stream, k)
        want_frames = reference.render(want, sample)
        one = {"state_err": state_err(post, want), "frame_px": frame_px(frames, want_frames)}
        failed += int(not judge(one, limits))
        _fold(readings, one)
        if lower is not None:
            low = reference.agent_step(pre, stream, k, lower=lower)
            _fold(control, {"state_err": state_err(low, want),
                            "frame_px": frame_px(reference.render(low, sample), want_frames)})
            del low
        del want, want_frames
    return readings, failed, control


def _fold(total: dict, one: dict) -> None:
    for key in NUMBERS:
        total[key] = max(total[key], one[key])
