"""TOML WAD metadata: skies, animations, things, linedef specials.

Reference behavior: rust-doom's wad/src/meta.rs (serde structs) and
assets/meta/doom.toml. Notable quirk kept for parity: `move.speed` in the
TOML is scaled by /8*0.7 at parse time (meta.rs:222-227).
"""

from __future__ import annotations

import re
import tomllib
from dataclasses import dataclass, field
from typing import Optional

from .name import wad_name

TRIGGER_TYPES = ("Any", "Push", "Switch", "WalkOver", "Gun")
HEIGHT_REFS = (
    "LowestFloor",
    "NextFloor",
    "HighestFloor",
    "LowestCeiling",
    "HighestCeiling",
    "Floor",
    "Ceiling",
)


@dataclass
class SkyMetadata:
    texture_name: bytes
    level_pattern: re.Pattern
    tiled_band_size: float


@dataclass
class ThingMetadata:
    thing_type: int
    sprite: bytes
    sequence: str
    hanging: bool
    radius: int


@dataclass
class HeightDef:
    to: str  # one of HEIGHT_REFS
    offset: int = 0


@dataclass
class HeightEffectDef:
    first: HeightDef
    second: Optional[HeightDef] = None


@dataclass
class MoveEffectDef:
    floor: Optional[HeightEffectDef] = None
    ceiling: Optional[HeightEffectDef] = None
    repeat: bool = False
    wait: float = 0.0
    speed: float = 0.0  # already scaled by /8*0.7


@dataclass
class LinedefMetadata:
    special_type: int
    trigger: str  # one of TRIGGER_TYPES
    monsters: bool = False
    only_once: bool = False
    move_effect: Optional[MoveEffectDef] = None
    exit_effect: Optional[str] = None  # "Normal" | "Secret"


THING_CATEGORIES = (
    "decorations",
    "weapons",
    "powerups",
    "artifacts",
    "ammo",
    "keys",
    "monsters",
)


@dataclass
class WadMetadata:
    sky: list[SkyMetadata] = field(default_factory=list)
    animated_flats: list[list[bytes]] = field(default_factory=list)
    animated_walls: list[list[bytes]] = field(default_factory=list)
    things: dict[str, list[ThingMetadata]] = field(default_factory=dict)
    linedef: dict[int, LinedefMetadata] = field(default_factory=dict)

    @classmethod
    def from_file(cls, path) -> "WadMetadata":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    @classmethod
    def from_text(cls, text: str) -> "WadMetadata":
        return cls.from_dict(tomllib.loads(text))

    @classmethod
    def from_dict(cls, doc: dict) -> "WadMetadata":
        sky = [
            SkyMetadata(
                texture_name=wad_name(s["texture_name"]),
                level_pattern=re.compile(s["level_pattern"]),
                tiled_band_size=float(s["tiled_band_size"]),
            )
            for s in doc.get("sky", [])
        ]
        anims = doc.get("animations", {})
        animated_flats = [
            [wad_name(n) for n in seq] for seq in anims.get("flats", [])
        ]
        animated_walls = [
            [wad_name(n) for n in seq] for seq in anims.get("walls", [])
        ]
        things: dict[str, list[ThingMetadata]] = {}
        things_doc = doc.get("things", {})
        for cat in THING_CATEGORIES:
            things[cat] = [
                ThingMetadata(
                    thing_type=int(t["thing_type"]),
                    sprite=wad_name(t["sprite"]),
                    sequence=str(t["sequence"]),
                    hanging=bool(t["hanging"]),
                    radius=int(t["radius"]),
                )
                for t in things_doc.get(cat, [])
            ]
        linedef: dict[int, LinedefMetadata] = {}
        for ld in doc.get("linedef", []):
            meta = LinedefMetadata(
                special_type=int(ld["special_type"]),
                trigger=_check(ld["trigger"], TRIGGER_TYPES),
                monsters=bool(ld.get("monsters", False)),
                only_once=bool(ld.get("only_once", False)),
                move_effect=_parse_move(ld.get("move")),
                exit_effect=_check(ld["exit"], ("Normal", "Secret"))
                if "exit" in ld
                else None,
            )
            linedef[meta.special_type] = meta
        return cls(
            sky=sky,
            animated_flats=animated_flats,
            animated_walls=animated_walls,
            things=things,
            linedef=linedef,
        )

    def sky_for(self, level_name: bytes) -> Optional[SkyMetadata]:
        """First sky whose regex matches; falls back to the first entry
        (ref meta.rs:156-172)."""
        text = level_name.rstrip(b"\0").decode("ascii", errors="replace")
        for s in self.sky:
            if s.level_pattern.search(text):
                return s
        return self.sky[0] if self.sky else None

    def find_thing(self, thing_type: int) -> Optional[ThingMetadata]:
        """Search categories in the reference's fixed order (meta.rs:174-205)."""
        for cat in THING_CATEGORIES:
            for t in self.things.get(cat, ()):
                if t.thing_type == thing_type:
                    return t
        return None


def _check(value: str, allowed: tuple[str, ...]) -> str:
    if value not in allowed:
        raise ValueError(f"bad metadata enum value {value!r}; allowed {allowed}")
    return value


def _parse_height(d: dict) -> HeightDef:
    return HeightDef(to=_check(d["to"], HEIGHT_REFS), offset=int(d.get("off", 0)))


def _parse_height_effect(d: Optional[dict]) -> Optional[HeightEffectDef]:
    if d is None:
        return None
    return HeightEffectDef(
        first=_parse_height(d["first"]),
        second=_parse_height(d["second"]) if "second" in d else None,
    )


def _parse_move(d: Optional[dict]) -> Optional[MoveEffectDef]:
    if d is None:
        return None
    return MoveEffectDef(
        floor=_parse_height_effect(d.get("floor")),
        ceiling=_parse_height_effect(d.get("ceiling")),
        repeat=bool(d.get("repeat", False)),
        wait=float(d.get("wait", 0.0)),
        # Speed units quirk kept for parity (ref meta.rs:222-227).
        speed=float(d.get("speed", 0.0)) / 8.0 * 0.7,
    )
