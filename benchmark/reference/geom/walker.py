"""BSP level walker: compiles raw level tables into geometry events.

Reference behavior: rust-doom's wad/src/visitor.rs:499-1259
(LevelWalker + points_to_polygon). This runs once per level at load time
on the host, exactly like the reference (pure preprocessing); visitors
consume wall/flat/sky/decor/marker events and emit dense arrays.

Key reproduced mechanics:
  * subsector polygons = explicit seg vertices + implicit BSP-line
    intersections filtered by halfspace tolerances (visitor.rs:653-709),
  * CCW sort + dedup + POLY_BIAS fattening (visitor.rs:1192-1259),
  * lower/middle/upper wall pegging rules (visitor.rs:711-937),
  * sky quads/polys, scroll special 0x30, axis-aligned light contrast,
  * things -> player-start markers and decor billboards.
"""

from __future__ import annotations

import functools
import logging
import math
from dataclasses import dataclass
from typing import Optional

from ..wad.level import LevelData
from ..wad.light import LightInfo, light_info_for_sector, with_contrast
from ..wad.meta import WadMetadata
from ..wad.name import is_sky_flat, is_untextured, name_push, pad8
from ..wad.tex import TextureDirectory
from ..wad.types import (
    LINEDEF_IMPASSABLE,
    LINEDEF_LOWER_UNPEGGED,
    LINEDEF_UPPER_UNPEGGED,
    parse_child_id,
)
from .analysis import LevelAnalysis
from .lines import Line2

log = logging.getLogger(__name__)

# Tolerances (ref visitor.rs:1157-1162).
BSP_TOLERANCE = 1e-3
SEG_TOLERANCE = 0.1
POLY_BIAS = 0.64 * 3e-4

F32_EPSILON = 1.1920929e-07

# Peg modes (ref visitor.rs:1164-1171).
PEG_TOP = 0
PEG_BOTTOM = 1
PEG_BOTTOM_LOWER = 2
PEG_TOP_FLOAT = 3
PEG_BOTTOM_FLOAT = 4

# Marker thing types (ref visitor.rs:1345-1364).
_PLAYER_STARTS = {1: 0, 2: 1, 3: 2, 4: 3}
THING_TELEPORT_START = 11
THING_TELEPORT_END = 14


@dataclass
class StaticQuad:
    object_id: int
    vertices: tuple  # ((x1,z1), (x2,z2)) game units
    tex_start: tuple  # (s1, t1)
    tex_end: tuple  # (s2, t2)
    height_range: tuple  # (low, high) game units
    light_info: LightInfo
    scroll: float
    tex_name: Optional[bytes]
    blocker: bool
    # Portal-renderer annotations (additive; other visitors ignore them):
    seg_id: int = -1  # index into the level SEGS table
    piece: str = ""  # "solid" | "lower" | "middle" | "upper"


@dataclass
class StaticPoly:
    object_id: int
    vertices: list
    height: float
    light_info: LightInfo
    tex_name: bytes


@dataclass
class SkyQuad:
    object_id: int
    vertices: tuple
    height_range: tuple


@dataclass
class SkyPoly:
    object_id: int
    vertices: list
    height: float


@dataclass
class Decor:
    object_id: int
    low: tuple  # (x, y, z)
    high: tuple
    half_width: float
    light_info: LightInfo
    tex_name: bytes


class LevelVisitor:
    """13-callback visitor protocol (ref visitor.rs:65-127)."""

    def visit_wall_quad(self, quad: StaticQuad):
        pass

    def visit_floor_poly(self, poly: StaticPoly):
        pass

    def visit_ceil_poly(self, poly: StaticPoly):
        pass

    def visit_floor_sky_poly(self, poly: SkyPoly):
        pass

    def visit_ceil_sky_poly(self, poly: SkyPoly):
        pass

    def visit_sky_quad(self, quad: SkyQuad):
        pass

    def visit_marker(self, pos, yaw: float, marker):
        pass

    def visit_decor(self, decor: Decor):
        pass

    def visit_bsp_root(self, line: Line2):
        pass

    def visit_bsp_node(self, line: Line2, branch: int):
        pass

    def visit_bsp_leaf(self, branch: int):
        pass

    def visit_bsp_leaf_end(self):
        pass

    def visit_bsp_node_end(self):
        pass


class _Chain(LevelVisitor):
    def __init__(self, visitors):
        self.visitors = visitors

    def __getattribute__(self, name):
        if name.startswith("visit_"):
            visitors = object.__getattribute__(self, "visitors")

            def fan(*args):
                for v in visitors:
                    getattr(v, name)(*args)

            return fan
        return object.__getattribute__(self, name)


def chain_visitors(*visitors: LevelVisitor) -> LevelVisitor:
    """Fan events out to several visitors (ref visitor.rs:1261-1331)."""
    return _Chain(visitors)


@dataclass
class _SectorInfo:
    floor_id: int
    ceiling_id: int
    floor_range: tuple  # WAD units
    ceiling_range: tuple

    def max_height(self) -> int:
        return self.ceiling_range[1] - self.floor_range[0]


def _g(x):  # WAD i16 -> game float
    return float(x) / 100.0


class LevelWalker:
    def __init__(
        self,
        level: LevelData,
        analysis: LevelAnalysis,
        tex: TextureDirectory,
        meta: WadMetadata,
        visitor: LevelVisitor,
    ):
        self.level = level
        self.analysis = analysis
        self.tex = tex
        self.meta = meta
        self.visitor = visitor
        self.height_range = level.min_max_height()
        self.bsp_lines: list[Line2] = []
        self._light_cache: dict[int, LightInfo] = {}

    # -- public ----------------------------------------------------------

    def walk(self):
        if len(self.level.nodes) == 0:
            log.warning("level contains no nodes; visitor not called")
            return
        root = self.level.nodes[-1]
        partition = _partition_line(root)
        self.visitor.visit_bsp_root(partition)
        self._children(root, partition)
        self.visitor.visit_bsp_node_end()
        self._things()

    # -- BSP descent ------------------------------------------------------

    def _children(self, node, partition: Line2):
        self.bsp_lines.append(partition)
        self._node(int(node["left"]), +1)
        self.bsp_lines.pop()
        self.bsp_lines.append(partition.inverted_halfspaces())
        self._node(int(node["right"]), -1)
        self.bsp_lines.pop()

    def _node(self, child_id: int, branch: int):
        idx, is_leaf = parse_child_id(child_id)
        idx = int(idx)
        if is_leaf:
            self.visitor.visit_bsp_leaf(branch)
            self._subsector(idx)
            self.visitor.visit_bsp_leaf_end()
            return
        if idx >= len(self.level.nodes):
            log.warning("missing node %d, skipping", idx)
            return
        node = self.level.nodes[idx]
        partition = _partition_line(node)
        self.visitor.visit_bsp_node(partition, branch)
        self._children(node, partition)
        self.visitor.visit_bsp_node_end()

    def _sector_info(self, sector_id: int) -> _SectorInfo:
        sector = self.level.sectors[sector_id]
        floor_range = (int(sector["floor_height"]), int(sector["floor_height"]))
        ceiling_range = (
            int(sector["ceiling_height"]),
            int(sector["ceiling_height"]),
        )
        fr, cr = self.analysis.sector_ranges(sector_id)
        return _SectorInfo(
            floor_id=self.analysis.floor_id(sector_id),
            ceiling_id=self.analysis.ceiling_id(sector_id),
            floor_range=fr or floor_range,
            ceiling_range=cr or ceiling_range,
        )

    def _light_info(self, sector_id: int) -> LightInfo:
        info = self._light_cache.get(sector_id)
        if info is None:
            info = light_info_for_sector(self.level, sector_id)
            self._light_cache[sector_id] = info
        return info

    # -- subsectors ---------------------------------------------------------

    def _subsector(self, idx: int):
        """Ref visitor.rs:621-709."""
        if idx >= len(self.level.subsectors):
            log.warning("cannot find subsector %d, skipping", idx)
            return
        segs = self.level.ssector_segs(self.level.subsectors[idx])
        if len(segs) == 0:
            log.warning("zero segs for subsector %d, skipping", idx)
            return
        sector_id = self.level.seg_sector_id(segs[0])
        if sector_id is None:
            log.warning("no sector for subsector %d, skipping", idx)
            return
        info = self._sector_info(sector_id)

        first_seg = int(self.level.subsectors[idx]["first_seg"])
        points: list[tuple[float, float]] = []
        seg_lines: list[Line2] = []
        for i_seg, seg in enumerate(segs):
            v1, v2 = self.level.seg_vertices(seg)
            v1 = (float(v1[0]), float(v1[1]))
            v2 = (float(v2[0]), float(v2[1]))
            points.append(v1)
            points.append(v2)
            seg_lines.append(Line2.from_two_points(v1, v2))
            self._seg(sector_id, info, seg, (v1, v2), first_seg + i_seg)

        # Implicit points: BSP-line pairwise intersections inside both the
        # BSP volume and the segs volume (visitor.rs:672-691).
        nb = len(self.bsp_lines)
        for i in range(nb - 1):
            for j in range(i + 1, nb):
                point = self.bsp_lines[i].intersect_point(self.bsp_lines[j])
                if point is None:
                    continue
                if all(
                    l.signed_distance(point) >= -BSP_TOLERANCE for l in self.bsp_lines
                ) and all(
                    l.signed_distance(point) <= SEG_TOLERANCE for l in seg_lines
                ):
                    points.append(point)

        if len(points) < 3:
            log.warning("degenerate source polygon %d (%d verts)", idx, len(points))
        points = points_to_polygon(points)
        if len(points) < 3:
            log.warning(
                "degenerate canonicalised polygon %d (%d verts)", idx, len(points)
            )
        else:
            self._flat_poly(sector_id, info, points)

    # -- walls --------------------------------------------------------------

    def _seg(self, sector_id: int, info: _SectorInfo, seg, vertices, seg_id: int = -1):
        """Portal/solid wall decomposition with pegging (ref visitor.rs:711-837)."""
        level = self.level
        line = level.seg_linedef(seg)
        sidedef = level.seg_sidedef(seg)
        if sidedef is None:
            log.warning("no sidedef for seg, skipping")
            return
        sector = level.sectors[sector_id]
        hmin, hmax = self.height_range
        floor = int(sector["floor_height"])
        ceiling = int(sector["ceiling_height"])
        flags = int(line["flags"])
        unpeg_lower = bool(flags & LINEDEF_LOWER_UNPEGGED)
        unpeg_upper = bool(flags & LINEDEF_UPPER_UNPEGGED)
        back_sector_id = level.seg_back_sector_id(seg)

        if back_sector_id is None:
            self._wall_quad(
                sector_id,
                seg,
                vertices,
                object_id=info.floor_id if unpeg_lower else info.ceiling_id,
                height_range=(
                    (floor, floor + info.max_height())
                    if unpeg_lower
                    else (ceiling - info.max_height(), ceiling)
                ),
                texture_name=pad8(sidedef["middle_texture"]),
                peg=PEG_BOTTOM if unpeg_lower else PEG_TOP,
                blocker=True,
                seg_id=seg_id,
                piece="solid",
            )
            if is_sky_flat(pad8(sector["ceiling_texture"])):
                self._sky_quad(info.ceiling_id, vertices, (ceiling, hmax))
            if is_sky_flat(pad8(sector["floor_texture"])):
                self._sky_quad(info.floor_id, vertices, (hmin, floor))
            return

        back_sector = level.sectors[back_sector_id]
        back_floor = int(back_sector["floor_height"])
        back_ceiling = int(back_sector["ceiling_height"])
        back_info = self._sector_info(back_sector_id)

        ceil_sky = is_sky_flat(pad8(sector["ceiling_texture"]))
        back_ceil_sky = is_sky_flat(pad8(back_sector["ceiling_texture"]))
        floor_sky = is_sky_flat(pad8(sector["floor_texture"]))
        back_floor_sky = is_sky_flat(pad8(back_sector["floor_texture"]))
        if ceil_sky and not back_ceil_sky:
            self._sky_quad(info.ceiling_id, vertices, (ceiling, hmax))
        if floor_sky and not back_floor_sky:
            self._sky_quad(info.floor_id, vertices, (hmin, floor))

        # Lower wall.
        if back_info.floor_range[1] > info.floor_range[0]:
            self._wall_quad(
                sector_id,
                seg,
                vertices,
                object_id=back_info.floor_id,
                height_range=(
                    back_floor - back_info.floor_range[1] + info.floor_range[0],
                    back_floor,
                ),
                texture_name=pad8(sidedef["lower_texture"]),
                peg=PEG_BOTTOM_LOWER if unpeg_lower else PEG_TOP,
                blocker=True,
                seg_id=seg_id,
                piece="lower",
            )
            floor = back_floor
        # Upper wall.
        if back_ceiling < ceiling:
            if not back_ceil_sky:
                self._wall_quad(
                    sector_id,
                    seg,
                    vertices,
                    object_id=back_info.ceiling_id,
                    height_range=(back_ceiling, ceiling),
                    texture_name=pad8(sidedef["upper_texture"]),
                    peg=PEG_TOP if unpeg_upper else PEG_BOTTOM,
                    blocker=True,
                    seg_id=seg_id,
                    piece="upper",
                )
            ceil = back_ceiling
        else:
            ceil = ceiling
        # Middle wall.
        if unpeg_lower:
            peg = (
                PEG_TOP_FLOAT
                if is_untextured(pad8(sidedef["upper_texture"]))
                else PEG_BOTTOM
            )
        elif is_untextured(pad8(sidedef["lower_texture"])):
            peg = PEG_BOTTOM_FLOAT
        else:
            peg = PEG_TOP
        self._wall_quad(
            sector_id,
            seg,
            vertices,
            object_id=info.floor_id if unpeg_lower else info.ceiling_id,
            height_range=(floor, ceil),
            texture_name=pad8(sidedef["middle_texture"]),
            peg=peg,
            blocker=bool(flags & LINEDEF_IMPASSABLE),
            seg_id=seg_id,
            piece="middle",
        )

    def _wall_quad(
        self,
        sector_id: int,
        seg,
        vertices,
        *,
        object_id: int,
        height_range,
        texture_name: bytes,
        peg: int,
        blocker: bool,
        seg_id: int = -1,
        piece: str = "",
    ):
        """Texture size/pegging/offset math (ref visitor.rs:839-937)."""
        (v1, v2) = vertices
        low, high = height_range
        if low >= high:
            return
        size = None
        if not is_untextured(texture_name):
            image = self.tex.texture(texture_name)
            if image is None:
                log.warning("wall_quad: no such wall texture %r", texture_name)
                return
            size = (float(image.width), float(image.height))
        line = self.level.seg_linedef(seg)
        sidedef = self.level.seg_sidedef(seg)
        if sidedef is None:
            log.warning("missing sidedef for seg, skipping wall")
            return
        sd_x = float(sidedef["x_offset"])
        sd_y = float(sidedef["y_offset"])

        dx, dy = v2[0] - v1[0], v2[1] - v1[1]
        mag = math.hypot(dx, dy)
        if mag > 0:
            bias = (dx / mag * POLY_BIAS, dy / mag * POLY_BIAS)
        else:
            bias = (0.0, 0.0)
        bv1 = (v1[0] - bias[0], v1[1] - bias[1])
        bv2 = (v2[0] + bias[0], v2[1] + bias[1])

        if size is not None and peg == PEG_TOP_FLOAT:
            glow = _g(low + int(sd_y))
            ghigh = _g(low + int(size[1]) + int(sd_y))
        elif size is not None and peg == PEG_BOTTOM_FLOAT:
            glow = _g(high + int(sd_y) - int(size[1]))
            ghigh = _g(high + int(sd_y))
        else:
            glow, ghigh = _g(low), _g(high)

        light_info = self._light_info(sector_id)
        if not light_info.has_effect:
            if abs(v1[0] - v2[0]) < F32_EPSILON:
                light_info = with_contrast(light_info, brighten=True)
            elif abs(v1[1] - v2[1]) < F32_EPSILON:
                light_info = with_contrast(light_info, brighten=False)

        height = (ghigh - glow) * 100.0
        s1 = float(seg["offset"]) + sd_x
        s2 = s1 + mag * 100.0
        if size is None or peg == PEG_TOP:
            t1, t2 = height, 0.0
        elif peg == PEG_BOTTOM:
            t1, t2 = size[1], size[1] - height
        elif peg == PEG_BOTTOM_LOWER:
            sector = self.level.sectors[sector_id]
            sector_height = float(
                int(sector["ceiling_height"]) - int(sector["floor_height"])
            )
            t1, t2 = size[1] + sector_height, size[1] - height + sector_height
        else:  # TopFloat / BottomFloat
            t1, t2 = size[1], 0.0
        t1 += sd_y
        t2 += sd_y

        scroll = 35.0 if int(line["special_type"]) == 0x30 else 0.0
        glow, ghigh = glow - POLY_BIAS, ghigh + POLY_BIAS

        self.visitor.visit_wall_quad(
            StaticQuad(
                object_id=object_id,
                vertices=(bv1, bv2),
                tex_start=(s1, t1),
                tex_end=(s2, t2),
                height_range=(glow, ghigh),
                light_info=light_info,
                scroll=scroll,
                tex_name=texture_name if size is not None else None,
                blocker=blocker,
                seg_id=seg_id,
                piece=piece,
            )
        )

    # -- flats ---------------------------------------------------------------

    def _flat_poly(self, sector_id: int, info: _SectorInfo, points):
        """Ref visitor.rs:939-985."""
        sector = self.level.sectors[sector_id]
        light_info = self._light_info(sector_id)
        floor_tex = pad8(sector["floor_texture"])
        ceil_tex = pad8(sector["ceiling_texture"])
        floor_sky = is_sky_flat(floor_tex)
        ceil_sky = is_sky_flat(ceil_tex)
        floor_y = _g(self.height_range[0] if floor_sky else int(sector["floor_height"]))
        ceil_y = _g(self.height_range[1] if ceil_sky else int(sector["ceiling_height"]))
        if floor_sky:
            self.visitor.visit_floor_sky_poly(
                SkyPoly(object_id=info.floor_id, vertices=points, height=floor_y)
            )
        else:
            self.visitor.visit_floor_poly(
                StaticPoly(
                    object_id=info.floor_id,
                    vertices=points,
                    height=floor_y,
                    light_info=light_info,
                    tex_name=floor_tex,
                )
            )
        if ceil_sky:
            self.visitor.visit_ceil_sky_poly(
                SkyPoly(object_id=info.ceiling_id, vertices=points, height=ceil_y)
            )
        else:
            self.visitor.visit_ceil_poly(
                StaticPoly(
                    object_id=info.ceiling_id,
                    vertices=points,
                    height=ceil_y,
                    light_info=light_info,
                    tex_name=ceil_tex,
                )
            )

    def _sky_quad(self, object_id: int, vertices, height_range):
        """Ref visitor.rs:987-1008."""
        (v1, v2) = vertices
        low, high = height_range
        if low >= high:
            return
        dx, dy = v2[0] - v1[0], v2[1] - v1[1]
        mag = math.hypot(dx, dy)
        edge = (dx / mag, dy / mag) if mag > 0 else (0.0, 0.0)
        bias = (edge[0] * POLY_BIAS * 16.0, edge[1] * POLY_BIAS * 16.0)
        normal = (-edge[1], edge[0])
        nbias = (normal[0] * POLY_BIAS * 16.0, normal[1] * POLY_BIAS * 16.0)
        bv1 = (v1[0] + nbias[0] - bias[0], v1[1] + nbias[1] - bias[1])
        bv2 = (v2[0] + nbias[0] + bias[0], v2[1] + nbias[1] + bias[1])
        self.visitor.visit_sky_quad(
            SkyQuad(
                object_id=object_id,
                vertices=(bv1, bv2),
                height_range=(_g(low), _g(high)),
            )
        )

    # -- things -----------------------------------------------------------------

    def _things(self):
        """Markers + decor (ref visitor.rs:1010-1137)."""
        for thing in self.level.things:
            pos = (
                -float(thing["y"]) / 100.0,
                -float(thing["x"]) / 100.0,
            )
            yaw_deg = round(float(thing["angle"]) / 45.0) * 45.0
            yaw = math.radians(yaw_deg)
            sector_id = self.sector_at(pos)
            if sector_id is None:
                continue
            ttype = int(thing["thing_type"])
            if ttype in _PLAYER_STARTS:
                sector = self.level.sectors[sector_id]
                p3 = (pos[0], _g(int(sector["floor_height"])), pos[1])
                self.visitor.visit_marker(
                    p3, yaw, ("StartPos", _PLAYER_STARTS[ttype])
                )
            elif ttype == THING_TELEPORT_START:
                sector = self.level.sectors[sector_id]
                p3 = (pos[0], _g(int(sector["floor_height"])), pos[1])
                self.visitor.visit_marker(p3, yaw, ("TeleportStart", 0))
            elif ttype == THING_TELEPORT_END:
                sector = self.level.sectors[sector_id]
                p3 = (pos[0], _g(int(sector["floor_height"])), pos[1])
                self.visitor.visit_marker(p3, yaw, ("TeleportEnd", 0))
            else:
                self._decor(thing, pos, sector_id)

    def sector_at(self, pos) -> Optional[int]:
        """BSP point query (ref visitor.rs:1028-1060)."""
        child_id = (len(self.level.nodes) - 1) & 0x7FFF
        is_leaf = False
        while True:
            if is_leaf:
                if child_id >= len(self.level.subsectors):
                    return None
                segs = self.level.ssector_segs(self.level.subsectors[child_id])
                if len(segs) == 0:
                    return None
                sector_id = self.level.seg_sector_id(segs[0])
                if sector_id is None:
                    return None
                for seg in segs:
                    v1, v2 = self.level.seg_vertices(seg)
                    line = Line2.from_two_points(
                        (float(v1[0]), float(v1[1])), (float(v2[0]), float(v2[1]))
                    )
                    if line.signed_distance(pos) > SEG_TOLERANCE:
                        return None
                return sector_id
            if child_id >= len(self.level.nodes):
                return None
            node = self.level.nodes[child_id]
            partition = _partition_line(node)
            nxt = (
                int(node["left"])
                if partition.signed_distance(pos) > 0.0
                else int(node["right"])
            )
            idx, is_leaf = parse_child_id(nxt)
            child_id = int(idx)

    def _decor(self, thing, pos, sector_id: int):
        """Ref visitor.rs:1062-1137."""
        meta = self.meta.find_thing(int(thing["thing_type"]))
        if meta is None:
            log.warning("no metadata for thing type %d", int(thing["thing_type"]))
            return
        try:
            sprite = name_push(meta.sprite, meta.sequence.encode()[0])
            sprite0 = name_push(sprite, ord("0"))
            sprite1 = name_push(sprite, ord("1"))
        except Exception:
            log.warning("bad sprite name %r for thing", meta.sprite)
            return
        image = self.tex.texture(sprite0)
        name = sprite0
        if image is None:
            image = self.tex.texture(sprite1)
            name = sprite1
        if image is None:
            log.warning(
                "no such sprite %r for thing %d", meta.sprite, int(thing["thing_type"])
            )
            return
        size = (_g(image.width), _g(image.height))
        sector = self.level.sectors[sector_id]
        if meta.hanging:
            object_id = self.analysis.ceiling_id(sector_id)
            ceil_y = _g(int(sector["ceiling_height"]))
            low = (pos[0], ceil_y - size[1], pos[1])
            high = (pos[0], ceil_y, pos[1])
        else:
            object_id = self.analysis.floor_id(sector_id)
            floor_y = _g(int(sector["floor_height"]))
            low = (pos[0], floor_y, pos[1])
            high = (pos[0], floor_y + size[1], pos[1])
        self.visitor.visit_decor(
            Decor(
                object_id=object_id,
                low=low,
                high=high,
                half_width=size[0] * 0.5,
                light_info=self._light_info(sector_id),
                tex_name=name,
            )
        )


def _partition_line(node) -> Line2:
    x, y = float(node["line_x"]), float(node["line_y"])
    sx, sy = float(node["step_x"]), float(node["step_y"])
    # from_wad_coords: (x, y) -> (-y/100, -x/100)
    p1 = (-y / 100.0, -x / 100.0)
    p2 = (-(y + sy) / 100.0, -(x + sx) / 100.0)
    return Line2.from_two_points(p1, p2)


def polygon_center(points) -> tuple[float, float]:
    n = float(len(points))
    return (sum(p[0] for p in points) / n, sum(p[1] for p in points) / n)


def points_to_polygon(points: list) -> list:
    """CCW sort around the centroid, near-duplicate removal by accumulated
    area, closing-gap pop, and POLY_BIAS outward fattening
    (ref visitor.rs:1192-1259)."""
    if not points:
        return []
    center = polygon_center(points)

    def cmp(a, b):
        ac = (a[0] - center[0], a[1] - center[1])
        bc = (b[0] - center[0], b[1] - center[1])
        if ac[0] >= 0.0 and bc[0] < 0.0:
            return -1
        if ac[0] < 0.0 and bc[0] >= 0.0:
            return 1
        if ac[0] == 0.0 and bc[0] == 0.0:
            if ac[1] >= 0.0 or bc[1] >= 0.0:
                return -1 if a[1] > b[1] else 1
            return -1 if b[1] > a[1] else 1
        pd = ac[0] * bc[1] - ac[1] * bc[0]
        return -1 if pd < 0.0 else 1

    points = sorted(points, key=functools.cmp_to_key(cmp))

    simplified = [points[0]]
    current = points[1]
    area = 0.0
    for i in range(2, len(points)):
        nxt = points[i]
        prev = simplified[-1]
        d1 = (nxt[0] - current[0], nxt[1] - current[1])
        d2 = (current[0] - prev[0], current[1] - prev[1])
        new_area = (d1[0] * d2[1] - d1[1] * d2[0]) * 0.5
        if new_area >= 0.0:
            if area + new_area > 1.024e-5:
                area = 0.0
                simplified.append(current)
            else:
                area += new_area
        current = nxt
    simplified.append(points[-1])
    if len(simplified) < 3:
        return []
    while simplified and math.hypot(
        simplified[0][0] - simplified[-1][0], simplified[0][1] - simplified[-1][1]
    ) < 0.0032:
        simplified.pop()

    if len(simplified) < 3:
        return []
    center = polygon_center(simplified)
    out = []
    for p in simplified:
        dx, dy = p[0] - center[0], p[1] - center[1]
        mag = math.hypot(dx, dy)
        if mag >= 1e-16:
            out.append((p[0] + dx / mag * POLY_BIAS, p[1] + dy / mag * POLY_BIAS))
        else:
            out.append(p)
    return out
