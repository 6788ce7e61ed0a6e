"""Raw level data: the 8 per-level lumps as dense NumPy tables.

Reference behavior: rust-doom's wad/src/level.rs. Lumps live at fixed
offsets from the level marker (level.rs:13-20). Unlike the reference's
linear `adjacent_sectors` scan (level.rs:230-259, with a TODO admitting it
should be precomputed), we precompute the sector adjacency once, and derive
`sector_min_light` / `neighbour_heights` vectorized from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import types as T
from .archive import Archive, CorruptWad

THINGS_OFFSET = 1
LINEDEFS_OFFSET = 2
SIDEDEFS_OFFSET = 3
VERTICES_OFFSET = 4
SEGS_OFFSET = 5
SSECTORS_OFFSET = 6
NODES_OFFSET = 7
SECTORS_OFFSET = 8


@dataclass
class NeighbourHeights:
    """Min/max/next heights over a sector's neighbours (ref level.rs:215-222)."""

    lowest_floor: int
    next_floor: Optional[int]
    highest_floor: int
    lowest_ceiling: int
    highest_ceiling: int


class LevelData:
    """All 8 level tables, loaded once; the core host-side data model."""

    def __init__(self, wad: Archive, level_index: int):
        start = wad.level_index_of(level_index)
        self.name = wad.level_name(level_index)
        self.things = wad.decode_lump(start + THINGS_OFFSET, T.THING_DTYPE)
        self.linedefs = wad.decode_lump(start + LINEDEFS_OFFSET, T.LINEDEF_DTYPE)
        self.sidedefs = wad.decode_lump(start + SIDEDEFS_OFFSET, T.SIDEDEF_DTYPE)
        self.vertices = wad.decode_lump(start + VERTICES_OFFSET, T.VERTEX_DTYPE)
        self.segs = wad.decode_lump(start + SEGS_OFFSET, T.SEG_DTYPE)
        self.subsectors = wad.decode_lump(start + SSECTORS_OFFSET, T.SUBSECTOR_DTYPE)
        self.nodes = wad.decode_lump(start + NODES_OFFSET, T.NODE_DTYPE)
        self.sectors = wad.decode_lump(start + SECTORS_OFFSET, T.SECTOR_DTYPE)
        self._adjacency: Optional[list[np.ndarray]] = None

    # -- game-space vertex positions ------------------------------------

    def vertex(self, vertex_id: int) -> np.ndarray:
        """Game-space (x, z) of a vertex (ref level.rs:83-87)."""
        v = self.vertices[vertex_id]
        return T.from_wad_coords(v["x"], v["y"])

    def all_vertices_game(self) -> np.ndarray:
        """(V, 2) game-space vertex table."""
        return T.from_wad_coords(self.vertices["x"], self.vertices["y"])

    # -- relational accessors (ref level.rs:89-161) ----------------------

    def seg_linedef(self, seg) -> np.void:
        return self.linedefs[int(seg["linedef"])]

    def seg_vertices(self, seg) -> tuple[np.ndarray, np.ndarray]:
        return self.vertex(int(seg["start_vertex"])), self.vertex(
            int(seg["end_vertex"])
        )

    def _sidedef_id(self, linedef, direction: int) -> int:
        side = int(linedef["right_side"] if direction == 0 else linedef["left_side"])
        return side

    def seg_sidedef(self, seg):
        side = self._sidedef_id(self.seg_linedef(seg), int(seg["direction"]))
        return None if side == -1 else self.sidedefs[side]

    def seg_back_sidedef(self, seg):
        side = self._sidedef_id(self.seg_linedef(seg), 1 - int(seg["direction"]))
        return None if side == -1 else self.sidedefs[side]

    def seg_sector_id(self, seg) -> Optional[int]:
        side = self.seg_sidedef(seg)
        return None if side is None else int(side["sector"])

    def seg_back_sector_id(self, seg) -> Optional[int]:
        side = self.seg_back_sidedef(seg)
        return None if side is None else int(side["sector"])

    def ssector_segs(self, subsector) -> np.ndarray:
        start = int(subsector["first_seg"])
        end = start + int(subsector["num_segs"])
        if end > len(self.segs):
            raise CorruptWad("subsector seg range out of bounds")
        return self.segs[start:end]

    # -- precomputed adjacency (replaces the reference's linear scan) -----

    def sector_adjacency(self) -> list[np.ndarray]:
        """adjacency[s] = array of neighbour sector ids (multiplicity kept,
        matching the reference's per-linedef iteration order)."""
        if self._adjacency is not None:
            return self._adjacency
        n = len(self.sectors)
        lists: list[list[int]] = [[] for _ in range(n)]
        left = self.linedefs["left_side"].astype(np.int32)
        right = self.linedefs["right_side"].astype(np.int32)
        both = (left != -1) & (right != -1)
        ls = self.sidedefs["sector"][left[both]].astype(np.int32)
        rs = self.sidedefs["sector"][right[both]].astype(np.int32)
        for a, b in zip(ls, rs):
            # Reference semantics (level.rs:244-250): if left == sector the
            # neighbour is right, elif right == sector the neighbour is left.
            if a == b:
                lists[a].append(int(b))
            else:
                lists[a].append(int(b))
                lists[b].append(int(a))
        self._adjacency = [np.asarray(l, dtype=np.int32) for l in lists]
        return self._adjacency

    def sector_min_light(self, sector_id: int) -> int:
        """Minimum light among the sector and its neighbours
        (ref level.rs:178-182)."""
        light = int(self.sectors[sector_id]["light"])
        adj = self.sector_adjacency()[sector_id]
        if len(adj):
            light = min(light, int(self.sectors["light"][adj].min()))
        return light

    def neighbour_heights(self, sector_id: int) -> Optional[NeighbourHeights]:
        """Ref level.rs:184-212. ``next_floor`` = lowest neighbour floor
        strictly above this sector's floor."""
        adj = self.sector_adjacency()[sector_id]
        if len(adj) == 0:
            return None
        floors = self.sectors["floor_height"][adj].astype(np.int32)
        ceils = self.sectors["ceiling_height"][adj].astype(np.int32)
        of_floor = int(self.sectors[sector_id]["floor_height"])
        above = floors[floors > of_floor]
        return NeighbourHeights(
            lowest_floor=int(floors.min()),
            next_floor=int(above.min()) if len(above) else None,
            highest_floor=int(floors.max()),
            lowest_ceiling=int(ceils.min()),
            highest_ceiling=int(ceils.max()),
        )

    def min_max_height(self) -> tuple[int, int]:
        """(min floor - 512, max ceiling + 512), used for sky wall extents
        (ref wad/src/visitor.rs:1173-1182)."""
        if len(self.sectors) == 0:
            return (32767 - 512, -32768 + 512)
        return (
            int(self.sectors["floor_height"].min()) - 512,
            int(self.sectors["ceiling_height"].max()) + 512,
        )
