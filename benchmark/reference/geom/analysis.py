"""Level analysis: dynamic sectors, movable-object ids, and triggers.

Reference behavior: rust-doom's wad/src/visitor.rs:142-497
(LevelAnalysis, DynamicSectorInfo, Trigger, MoveEffect). Object id 0 is the
static world; ids >= 1 are movable floors/ceilings, one per dynamic
surface, assigned in the reference's order (ceiling before floor per
sector, sectors in linedef-trigger discovery order).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from ..wad.level import LevelData, NeighbourHeights
from ..wad.meta import HeightDef, LinedefMetadata, WadMetadata
from ..wad.types import from_wad_height
from .lines import Line2

log = logging.getLogger(__name__)


@dataclass
class MoveEffect:
    """One movable surface's animation program (ref visitor.rs:263-271).
    Offsets are in game units relative to the surface's rest height."""

    object_id: int
    first_height_offset: float
    second_height_offset: Optional[float]
    speed: float
    wait: float
    repeat: bool


@dataclass
class Trigger:
    trigger_type: str  # Any | Push | Switch | WalkOver | Gun
    line: Line2
    special_type: int
    only_once: bool
    unimplemented: bool
    move_effect_def: object  # Optional[MoveEffectDef]
    exit_effect: Optional[str]
    move_effects: list[MoveEffect] = field(default_factory=list)


@dataclass
class _DynamicSectorInfo:
    floor_id: int = 0
    ceiling_id: int = 0
    neighbour_heights: Optional[NeighbourHeights] = None
    floor_range: Optional[tuple[int, int]] = None
    ceiling_range: Optional[tuple[int, int]] = None


def _height_def_to_height(
    hdef: HeightDef, sector, heights: NeighbourHeights
) -> Optional[int]:
    """Ref visitor.rs:273-286."""
    to = hdef.to
    if to == "LowestFloor":
        base = heights.lowest_floor
    elif to == "NextFloor":
        if heights.next_floor is None:
            return None
        base = heights.next_floor
    elif to == "HighestFloor":
        base = heights.highest_floor
    elif to == "LowestCeiling":
        base = heights.lowest_ceiling
    elif to == "HighestCeiling":
        base = heights.highest_ceiling
    elif to == "Floor":
        base = int(sector["floor_height"])
    elif to == "Ceiling":
        base = int(sector["ceiling_height"])
    else:  # pragma: no cover
        raise ValueError(to)
    return base + hdef.offset


def _option_to_heights(effect, sector, heights):
    """Ref visitor.rs:288-301."""
    if effect is None:
        return None, None
    first = _height_def_to_height(effect.first, sector, heights)
    second = (
        _height_def_to_height(effect.second, sector, heights)
        if effect.second is not None
        else None
    )
    return first, second


def _merge_range(range_, current: int, coords) -> Optional[tuple[int, int]]:
    """Ref visitor.rs:247-261: extend range with coords, then include
    the current height -- but only if any coord contributed."""
    r = range_
    for c in coords:
        if c is None:
            continue
        r = (c, c) if r is None else (min(r[0], c), max(r[1], c))
    if r is None:
        return range_
    return (min(r[0], current), max(r[1], current))


class LevelAnalysis:
    """Scan linedefs for specials; build triggers and movable-object table."""

    def __init__(self, level: LevelData, meta: WadMetadata):
        self.dynamic_info: dict[int, _DynamicSectorInfo] = {}
        self.triggers: list[Trigger] = []
        self.num_objects = 1
        self._compute(level, meta)

    def floor_id(self, sector_id: int) -> int:
        info = self.dynamic_info.get(sector_id)
        return info.floor_id if info else 0

    def ceiling_id(self, sector_id: int) -> int:
        info = self.dynamic_info.get(sector_id)
        return info.ceiling_id if info else 0

    def sector_ranges(self, sector_id: int):
        """(floor_range, ceiling_range) in WAD units, or None when static."""
        info = self.dynamic_info.get(sector_id)
        if info is None:
            return None, None
        return info.floor_range, info.ceiling_range

    # -- internals ------------------------------------------------------

    def _compute(self, level: LevelData, meta: WadMetadata):
        """Ref visitor.rs:341-444 (compute_dynamic_sectors)."""
        tags = level.sectors["tag"]
        sectors_by_tag: dict[int, list[int]] = {}
        for i, tag in enumerate(tags):
            if int(tag) > 0:
                sectors_by_tag.setdefault(int(tag), []).append(i)

        next_object_id = [1]
        num_dynamic_linedefs = 0
        for i_linedef, linedef in enumerate(level.linedefs):
            trigger = self._linedef_to_trigger(level, meta, linedef)
            if trigger is None:
                continue
            num_dynamic_linedefs += 1
            tag = int(linedef["sector_tag"])
            if tag == 0:
                # Manual (push) linedef: the dynamic sector is behind the
                # LEFT sidedef (ref visitor.rs:385-403).
                left = int(linedef["left_side"])
                if left != -1:
                    sector_id = int(level.sidedefs[left]["sector"])
                    self._update_dynamic(
                        next_object_id, level, sector_id, trigger
                    )
                self.triggers.append(trigger)
                continue
            if tag in sectors_by_tag:
                for sector_id in sectors_by_tag[tag]:
                    self._update_dynamic(next_object_id, level, sector_id, trigger)
            else:
                log.warning(
                    "no sector with tag %d, required by linedef %d", tag, i_linedef
                )
            self.triggers.append(trigger)
        self.num_objects = next_object_id[0]
        log.info(
            "dynamic sectors: num_objects=%d num_dynamic_linedefs=%d "
            "num_triggers=%d",
            self.num_objects,
            num_dynamic_linedefs,
            len(self.triggers),
        )

    def _linedef_to_trigger(
        self, level: LevelData, meta: WadMetadata, linedef
    ) -> Optional[Trigger]:
        """Ref visitor.rs:446-496."""
        special = int(linedef["special_type"])
        if special == 0:
            return None
        v1 = level.vertex(int(linedef["start_vertex"]))
        v2 = level.vertex(int(linedef["end_vertex"]))
        line = Line2.from_two_points(v1, v2)
        ld_meta: Optional[LinedefMetadata] = meta.linedef.get(special)
        if ld_meta is not None:
            return Trigger(
                trigger_type=ld_meta.trigger,
                only_once=ld_meta.only_once,
                move_effect_def=ld_meta.move_effect,
                exit_effect=ld_meta.exit_effect,
                unimplemented=False,
                special_type=special,
                line=line,
            )
        # The reference emits an unimplemented 'Any' trigger for EVERY
        # special absent from metadata -- including scroll special 48
        # (0x30), whose render effect the walker applies separately
        # (visitor.rs:922). The trigger is behaviorally inert (no move
        # effects, no exit) but kept so the trigger set matches
        # visitor.rs:446-496 exactly.
        log.error("unknown linedef special type: %d", special)
        return Trigger(
            trigger_type="Any",
            only_once=False,
            move_effect_def=None,
            exit_effect=None,
            unimplemented=True,
            special_type=special,
            line=line,
        )

    def _update_dynamic(
        self, next_object_id: list[int], level: LevelData, sector_id: int, trigger
    ):
        """Ref visitor.rs:167-245 (DynamicSectorInfo::update)."""
        info = self.dynamic_info.setdefault(sector_id, _DynamicSectorInfo())
        effect_def = trigger.move_effect_def
        if effect_def is None:
            return
        sector = level.sectors[sector_id]
        if info.neighbour_heights is None:
            info.neighbour_heights = level.neighbour_heights(sector_id)
        heights = info.neighbour_heights
        if heights is None:
            log.error("sector %d has no neighbours; cannot compute height", sector_id)
            return

        first_floor, second_floor = _option_to_heights(
            effect_def.floor, sector, heights
        )
        first_ceiling, second_ceiling = _option_to_heights(
            effect_def.ceiling, sector, heights
        )
        floor_h = int(sector["floor_height"])
        ceiling_h = int(sector["ceiling_height"])
        info.floor_range = _merge_range(
            info.floor_range, floor_h, (first_floor, second_floor)
        )
        info.ceiling_range = _merge_range(
            info.ceiling_range, ceiling_h, (first_ceiling, second_ceiling)
        )

        # Id assignment order (ceiling then floor) matches visitor.rs:211-218.
        if info.ceiling_range is not None and info.ceiling_id == 0:
            info.ceiling_id = next_object_id[0]
            next_object_id[0] += 1
        if info.floor_range is not None and info.floor_id == 0:
            info.floor_id = next_object_id[0]
            next_object_id[0] += 1

        if first_floor is not None:
            trigger.move_effects.append(
                MoveEffect(
                    object_id=info.floor_id,
                    wait=effect_def.wait,
                    speed=effect_def.speed,
                    first_height_offset=float(from_wad_height(first_floor - floor_h)),
                    second_height_offset=(
                        float(from_wad_height(second_floor - floor_h))
                        if second_floor is not None
                        else None
                    ),
                    repeat=effect_def.repeat,
                )
            )
        if first_ceiling is not None:
            trigger.move_effects.append(
                MoveEffect(
                    object_id=info.ceiling_id,
                    wait=effect_def.wait,
                    speed=effect_def.speed,
                    first_height_offset=float(
                        from_wad_height(first_ceiling - ceiling_h)
                    ),
                    second_height_offset=(
                        float(from_wad_height(second_ceiling - ceiling_h))
                        if second_ceiling is not None
                        else None
                    ),
                    repeat=effect_def.repeat,
                )
            )
