"""Per-sector light levels and light-effect parameters.

Reference behavior: rust-doom's wad/src/light.rs. A sector's light level
is quantized `(light >> 3) / 31`; special sector types install an effect
(glow / random flash-flicker / alternating strobe) whose alternate level is
the minimum light over adjacent sectors. The runtime waveform lives in
tpu_doom_torch.sim.lights (ref game/src/lights.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from .level import LevelData

# LightEffectKind encoding (stable ints, used in device arrays).
KIND_NONE = 0
KIND_GLOW = 1
KIND_RANDOM = 2
KIND_ALTERNATE = 3

# Sector types (ref light.rs:127-134).
FLASH = 1
FAST_STROBE_1 = 2
SLOW_STROBE = 3
FAST_STROBE_2 = 4
GLOW = 8
SLOW_STROBE_SYNC = 12
FAST_STROBE_SYNC = 13
FLICKER = 17

# Effect constants (ref light.rs:117-125).
FLASH_SPEED, FLASH_DURATION = 20.0, 0.06
FLICKER_SPEED, FLICKER_DURATION = 8.0, 0.5
SLOW_STROBE_SPEED, SLOW_STROBE_DURATION = 1.0, 0.85
FAST_STROBE_SPEED, FAST_STROBE_DURATION = 2.0, 0.7
GLOW_SPEED = 0.5

_EFFECT_TYPES = {
    FLASH,
    FAST_STROBE_1,
    FAST_STROBE_2,
    FAST_STROBE_SYNC,
    SLOW_STROBE,
    SLOW_STROBE_SYNC,
    GLOW,
    FLICKER,
}


@dataclass(frozen=True)
class LightInfo:
    """Immutable & hashable so the level builder can dedup identical infos
    (ref game/src/lights.rs:14-24 dedups by equality)."""

    level: float
    kind: int = KIND_NONE  # KIND_* ; KIND_NONE means no effect
    alt_level: float = 0.0
    speed: float = 0.0
    duration: float = 0.0
    sync: float = 0.0

    @property
    def has_effect(self) -> bool:
        return self.kind != KIND_NONE


def light_to_f32(level: int) -> float:
    """Quantized light (ref light.rs:113-115)."""
    return float(int(level) >> 3) / 31.0


def id_to_sync(sector_id: int) -> float:
    """Deterministic per-sector phase hash (ref light.rs:109-111)."""
    return float((sector_id * 1_664_525 + 1_013_904_223) & 0xFFFF) / 15.0


def light_info_for_sector(level: LevelData, sector_id: int) -> LightInfo:
    """Ref light.rs:27-79 (`new_light`)."""
    sector = level.sectors[sector_id]
    base = light_to_f32(int(sector["light"]))
    sector_type = int(sector["sector_type"])
    if sector_type not in _EFFECT_TYPES:
        return LightInfo(level=base)
    alt = light_to_f32(level.sector_min_light(sector_id))
    if abs(alt - base) < 1.1920929e-07:  # f32::EPSILON
        return LightInfo(level=base)
    sync = (
        0.0
        if sector_type in (SLOW_STROBE_SYNC, FAST_STROBE_SYNC, GLOW)
        else id_to_sync(sector_id)
    )
    if sector_type == FLASH:
        kind, speed, duration = KIND_RANDOM, FLASH_SPEED, FLASH_DURATION
    elif sector_type == FLICKER:
        kind, speed, duration = KIND_RANDOM, FLICKER_SPEED, FLICKER_DURATION
    elif sector_type in (SLOW_STROBE, SLOW_STROBE_SYNC):
        kind, speed, duration = KIND_ALTERNATE, SLOW_STROBE_SPEED, SLOW_STROBE_DURATION
    elif sector_type in (FAST_STROBE_1, FAST_STROBE_2, FAST_STROBE_SYNC):
        kind, speed, duration = KIND_ALTERNATE, FAST_STROBE_SPEED, FAST_STROBE_DURATION
    else:  # GLOW
        kind, speed, duration = KIND_GLOW, GLOW_SPEED, 0.0
    return LightInfo(
        level=base, kind=kind, alt_level=alt, speed=speed, duration=duration, sync=sync
    )


def with_contrast(info: LightInfo, brighten: bool) -> LightInfo:
    """Fake contrast for axis-aligned walls: +-2/31, clamped, only applied
    to effect-less sectors by the caller (ref light.rs:82-101)."""
    delta = 2.0 / 31.0 if brighten else -2.0 / 31.0
    return LightInfo(
        level=min(1.0, max(0.0, info.level + delta)),
        kind=info.kind,
        alt_level=info.alt_level,
        speed=info.speed,
        duration=info.duration,
        sync=info.sync,
    )
