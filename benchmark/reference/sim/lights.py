"""Sector light-effect waveforms, closed-form in time.

Port of `tpu_doom/sim/lights.py` with the env batch written out: time is
(B,) and the light table (L,), giving (B, L).
"""

from __future__ import annotations

import torch

from .._numerics import div
from ..wad.light import KIND_ALTERNATE, KIND_GLOW, KIND_RANDOM


def _fract(x):
    return x - torch.floor(x)


def _noise(sync, t):
    """Deterministic sin-hash (ref lights.rs:62-64)."""
    return _fract(
        1.0 + torch.sin((sync + div(t, 1000.0)) * 12.9898 + sync * 78.233) * 43758.547
    )


def light_levels_at(scene, time):
    """All light-table entries at per-env `time` (B,) -> (B, L) f32."""
    t = time[:, None]
    level = scene.light_level[None, :]
    alt = scene.light_alt[None, :]
    speed = scene.light_speed[None, :]
    duration = scene.light_duration[None, :]
    sync = scene.light_sync[None, :]
    kind = scene.light_kind[None, :]

    scale = level - alt
    safe_scale = torch.where(scale == 0.0, 1.0, scale)
    phase = t * speed / safe_scale
    glow = torch.abs(0.5 - _fract(phase)) * 2.0 * scale + alt
    random = torch.where(_noise(sync, torch.floor(t * speed)) < duration, alt, level)
    alternate = torch.where(
        _fract(t * speed + sync * 3.5435) < duration, alt, level
    )
    return torch.where(
        kind == KIND_GLOW,
        glow,
        torch.where(
            kind == KIND_RANDOM,
            random,
            torch.where(kind == KIND_ALTERNATE, alternate, level),
        ),
    )


def light_table_u8(scene, time):
    """Quantized levels (B, L) u8 (clamp * 255 truncated)."""
    levels = torch.clamp(light_levels_at(scene, time), 0.0, 1.0)
    return (levels * 255.0).to(torch.uint8)
