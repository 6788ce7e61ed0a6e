"""Level compiler: walker events -> dense arrays (the device data model).

This fuses the roles of three reference components:
  * game/src/level.rs Builder      -> render vertex SoA + index lists
  * game/src/world.rs WorldBuilder -> collision triangle soup (per object)
  * game/src/game_shaders.rs       -> per-level atlases + palette LUTs
  * game/src/lights.rs Lights      -> deduped light table (<= 255 entries)

Output is a `LevelArrays` bundle of NumPy arrays; `scene_from_arrays()` in
tpu_doom_torch.sim.scene uploads them once.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

import numpy as np

from ..wad.archive import Archive
from ..wad.level import LevelData
from ..wad.light import LightInfo
from ..wad.meta import WadMetadata
from ..wad.name import is_sky_flat, is_untextured, name_push, pad8
from ..wad.tex import Bounds, TextureDirectory
from .analysis import LevelAnalysis, Trigger
from .broadphase import build_grid
from .walker import (
    Decor,
    LevelVisitor,
    LevelWalker,
    SkyPoly,
    SkyQuad,
    StaticPoly,
    StaticQuad,
    chain_visitors,
)

log = logging.getLogger(__name__)

TRIGGER_TYPE_IDS = {"Any": 0, "Push": 1, "Switch": 2, "WalkOver": 3, "Gun": 4}
EXIT_NONE, EXIT_NORMAL, EXIT_SECRET = 0, 1, 2


@dataclass
class LevelArrays:
    """Everything one level contributes to the device."""

    name: bytes
    num_objects: int

    # --- static geometry (walls + flats share one vertex stream) ---------
    static_pos: np.ndarray  # (N, 3) f32
    static_atlas_uv: np.ndarray  # (N, 2) f32
    static_tile_uv: np.ndarray  # (N, 2) f32
    static_tile_size: np.ndarray  # (N, 2) f32
    static_scroll: np.ndarray  # (N,) f32
    static_row_height: np.ndarray  # (N,) f32
    static_num_frames: np.ndarray  # (N,) i32
    static_light: np.ndarray  # (N,) i32
    static_object: np.ndarray  # (N,) i32
    wall_tris: np.ndarray  # (Tw, 3) i32
    wall_tri_transparent: np.ndarray  # (Tw,) bool: texture region has holes
    flat_tris: np.ndarray  # (Tf, 3) i32

    # --- sky geometry ------------------------------------------------------
    sky_pos: np.ndarray  # (Ns, 3) f32
    sky_object: np.ndarray  # (Ns,) i32
    sky_tris: np.ndarray  # (Ts, 3) i32

    # --- decor (billboard) geometry ----------------------------------------
    decor_pos: np.ndarray  # (Nd, 3) f32
    decor_local_x: np.ndarray  # (Nd,) f32
    decor_atlas_uv: np.ndarray
    decor_tile_uv: np.ndarray
    decor_tile_size: np.ndarray
    decor_num_frames: np.ndarray
    decor_light: np.ndarray
    decor_object: np.ndarray
    decor_tris: np.ndarray  # (Td, 3) i32

    # --- collision ---------------------------------------------------------
    coll_v0: np.ndarray  # (M, 3) f32
    coll_v1: np.ndarray
    coll_v2: np.ndarray
    coll_normal: np.ndarray
    coll_object: np.ndarray  # (M,) i32
    # Collision broad-phase (uniform XZ grid; see geom/broadphase.py).
    bp_origin: np.ndarray  # (2,) f32
    bp_inv_cell: np.ndarray  # () f32
    bp_dims: np.ndarray  # (2,) i32 = (nx, nz)
    bp_cells: np.ndarray  # (nx*nz, M) i32, -1 padded

    # --- triggers / move effects -------------------------------------------
    trig_origin: np.ndarray  # (K, 2) f32
    trig_displace: np.ndarray  # (K, 2) f32 unit
    trig_length: np.ndarray  # (K,) f32
    trig_type: np.ndarray  # (K,) i32 (TRIGGER_TYPE_IDS)
    trig_only_once: np.ndarray  # (K,) bool
    trig_exit: np.ndarray  # (K,) i32 EXIT_*
    trig_special: np.ndarray  # (K,) i32
    eff_trigger: np.ndarray  # (D,) i32 trigger index
    eff_object: np.ndarray  # (D,) i32 object id
    eff_first_offset: np.ndarray  # (D,) f32
    eff_second_offset: np.ndarray  # (D,) f32 (valid if has_second)
    eff_has_second: np.ndarray  # (D,) bool
    eff_speed: np.ndarray  # (D,) f32
    eff_wait: np.ndarray  # (D,) f32
    eff_repeat: np.ndarray  # (D,) bool

    # --- lights --------------------------------------------------------------
    light_level: np.ndarray  # (L,) f32
    light_kind: np.ndarray  # (L,) i32
    light_alt: np.ndarray  # (L,) f32
    light_speed: np.ndarray  # (L,) f32
    light_duration: np.ndarray  # (L,) f32
    light_sync: np.ndarray  # (L,) f32

    # --- textures / LUTs -------------------------------------------------------
    palette: np.ndarray  # (256, 3) u8 raw PLAYPAL palette 0
    palette_lut: np.ndarray  # (32, 256, 3) u8 (colormap x index -> RGB)
    colormaps: np.ndarray  # (34, 256) u8
    walls_atlas_index: np.ndarray  # (Hw, Ww) u8
    walls_atlas_alpha: np.ndarray  # (Hw, Ww) bool (True = opaque)
    flats_atlas: np.ndarray  # (Hf, Wf) u8 (opaque)
    decor_atlas_index: np.ndarray
    decor_atlas_alpha: np.ndarray
    combo_atlas: np.ndarray  # (32, 4, Hc, Wc) u16: colormapped idx | (hole << 8)
    combo_dims: np.ndarray  # (4, 2) i32 original (H, W) per plane for REPEAT wrap
    sky_index: np.ndarray  # (Hs, Ws) u8
    tiled_band_size: float

    # --- player start ------------------------------------------------------------
    start_pos: np.ndarray  # (3,) f32 (already includes +(0, 0.5, 0.32))
    start_yaw: float

    # Portal/column renderer tables (geom/portal.py); not part of the
    # LevelBank padding protocol (portal backend is single-level for now).
    portal: object = None

    stats: dict = field(default_factory=dict)


class _Lights:
    """Dedup light table (ref game/src/lights.rs:7-24)."""

    def __init__(self):
        self.infos: list[LightInfo] = []
        self._index: dict[LightInfo, int] = {}

    def push(self, info: LightInfo) -> int:
        idx = self._index.get(info)
        if idx is None:
            assert len(self.infos) < 255, "light table overflow"
            idx = len(self.infos)
            self.infos.append(info)
            self._index[info] = idx
        return idx


class _RenderBuilder(LevelVisitor):
    """Vertex/index accumulation (ref game/src/level.rs:307-794 Builder)."""

    def __init__(self, walls_bounds, flats_bounds, decor_bounds):
        self.walls_bounds = walls_bounds
        self.flats_bounds = flats_bounds
        self.decor_bounds = decor_bounds
        self.lights = _Lights()
        self.start_pos = np.zeros(3, dtype=np.float32)
        self.start_yaw = 0.0

        self.sv = {k: [] for k in (
            "pos", "atlas_uv", "tile_uv", "tile_size", "scroll",
            "row_height", "num_frames", "light", "object",
        )}
        self.wall_tris: list[tuple[int, int, int]] = []
        self.flat_tris: list[tuple[int, int, int]] = []

        self.sky_pos: list = []
        self.sky_object: list = []
        self.sky_tris: list = []

        self.dv = {k: [] for k in (
            "pos", "local_x", "atlas_uv", "tile_uv", "tile_size",
            "num_frames", "light", "object",
        )}
        self.decor_tris: list = []
        # (seg_id, piece) -> wall-piece record for the portal renderer.
        self.seg_pieces: dict = {}
        self.sprite_records: list = []
        self.counts = dict(
            wall_quads=0, floor_polys=0, ceil_polys=0, sky_wall_quads=0,
            sky_floor_polys=0, sky_ceil_polys=0, decors=0,
        )

    # -- vertex helpers -------------------------------------------------

    def _static_vertex(
        self, xz, y, tile_u, tile_v, light, scroll, bounds: Bounds, object_id
    ):
        self.sv["pos"].append((xz[0], y, xz[1]))
        self.sv["atlas_uv"].append(bounds.pos)
        self.sv["tile_uv"].append((tile_u, tile_v))
        self.sv["tile_size"].append(bounds.size)
        self.sv["scroll"].append(scroll)
        self.sv["row_height"].append(float(bounds.row_height))
        self.sv["num_frames"].append(bounds.num_frames)
        self.sv["light"].append(light)
        self.sv["object"].append(object_id)

    @staticmethod
    def _quad_indices(n: int, out: list):
        """4 freshly-pushed vertices -> 2 triangles (ref level.rs:620-634)."""
        v0 = n - 4
        out.append((v0, v0 + 1, v0 + 3))
        out.append((v0 + 1, v0 + 2, v0 + 3))

    @staticmethod
    def _poly_indices(n: int, poly_len: int, out: list):
        """Fan triangulation (ref level.rs:636-645)."""
        v0 = n - poly_len
        for v1 in range(v0, n - 1):
            out.append((v0, v1, v1 + 1))

    # -- visitor callbacks ---------------------------------------------

    def visit_wall_quad(self, quad: StaticQuad):
        self.counts["wall_quads"] += 1
        if quad.tex_name is None:
            return
        bounds = self.walls_bounds.get(quad.tex_name)
        if bounds is None:
            log.warning("no such wall texture %r", quad.tex_name)
            return
        light = self.lights.push(quad.light_info)
        (v1, v2) = quad.vertices
        (low, high) = quad.height_range
        (s1, t1) = quad.tex_start
        (s2, t2) = quad.tex_end
        if quad.seg_id >= 0 and quad.piece:
            self.seg_pieces[(quad.seg_id, quad.piece)] = dict(
                low=low, high=high, s1=s1, t1=t1, s2=s2, t2=t2,
                light=light, scroll=quad.scroll, bounds=bounds,
                object_id=quad.object_id, blocker=quad.blocker,
            )
        for xz, y, tu, tv in (
            (v1, low, s1, t1),
            (v2, low, s2, t1),
            (v2, high, s2, t2),
            (v1, high, s1, t2),
        ):
            self._static_vertex(xz, y, tu, tv, light, quad.scroll, bounds, quad.object_id)
        self._quad_indices(len(self.sv["pos"]), self.wall_tris)

    def _flat_poly(self, poly: StaticPoly, reverse: bool):
        bounds = self.flats_bounds.get(poly.tex_name)
        if bounds is None:
            log.warning("no such flat texture %r", poly.tex_name)
            return
        light = self.lights.push(poly.light_info)
        verts = list(reversed(poly.vertices)) if reverse else poly.vertices
        for xz in verts:
            # Flat tile UV is world-position derived (ref level.rs:537-549).
            self._static_vertex(
                xz, poly.height, -xz[0] * 100.0, -xz[1] * 100.0, light, 0.0,
                bounds, poly.object_id,
            )
        self._poly_indices(len(self.sv["pos"]), len(verts), self.flat_tris)

    def visit_floor_poly(self, poly: StaticPoly):
        self.counts["floor_polys"] += 1
        self._flat_poly(poly, reverse=False)

    def visit_ceil_poly(self, poly: StaticPoly):
        self.counts["ceil_polys"] += 1
        self._flat_poly(poly, reverse=True)

    def _sky_poly(self, poly: SkyPoly, reverse: bool):
        verts = list(reversed(poly.vertices)) if reverse else poly.vertices
        for xz in verts:
            self.sky_pos.append((xz[0], poly.height, xz[1]))
            self.sky_object.append(poly.object_id)
        self._poly_indices(len(self.sky_pos), len(verts), self.sky_tris)

    def visit_floor_sky_poly(self, poly: SkyPoly):
        self.counts["sky_floor_polys"] += 1
        self._sky_poly(poly, reverse=False)

    def visit_ceil_sky_poly(self, poly: SkyPoly):
        self.counts["sky_ceil_polys"] += 1
        self._sky_poly(poly, reverse=True)

    def visit_sky_quad(self, quad: SkyQuad):
        self.counts["sky_wall_quads"] += 1
        (v1, v2) = quad.vertices
        (low, high) = quad.height_range
        for xz, y in ((v1, low), (v2, low), (v2, high), (v1, high)):
            self.sky_pos.append((xz[0], y, xz[1]))
            self.sky_object.append(quad.object_id)
        self._quad_indices(len(self.sky_pos), self.sky_tris)

    def visit_marker(self, pos, yaw, marker):
        kind, player = marker
        if kind == "StartPos" and player == 0:
            # Spawn offset (ref game/src/level.rs:757-762).
            self.start_pos = np.array(
                [pos[0], pos[1] + 0.5, pos[2] + 32.0 / 100.0], dtype=np.float32
            )
            self.start_yaw = yaw

    def visit_decor(self, decor: Decor):
        self.counts["decors"] += 1
        bounds = self.decor_bounds.get(decor.tex_name)
        if bounds is None:
            log.warning("no such decor texture %r", decor.tex_name)
            return
        light = self.lights.push(decor.light_info)
        hw = decor.half_width
        w, h = bounds.size
        # Per-sprite scalar record for the portal renderer (the billboard
        # quad reduced to center/extent/uv mapping; render/portal.py).
        self.sprite_records.append(dict(
            center=(decor.low[0], decor.low[2]),
            half_width=hw,
            low=decor.low[1],
            high=decor.high[1],
            object_id=decor.object_id,
            s2=w, t1=h, t2=0.0,
            light=light,
            bounds=bounds,
        ))
        for pos, local_x, tu, tv in (
            (decor.low, -hw, 0.0, h),
            (decor.low, hw, w, h),
            (decor.high, hw, w, 0.0),
            (decor.high, -hw, 0.0, 0.0),
        ):
            self.dv["pos"].append(pos)
            self.dv["local_x"].append(local_x)
            self.dv["atlas_uv"].append(bounds.pos)
            self.dv["tile_uv"].append((tu, tv))
            self.dv["tile_size"].append(bounds.size)
            self.dv["num_frames"].append(1)
            self.dv["light"].append(light)
            self.dv["object"].append(decor.object_id)
        self._quad_indices(len(self.dv["pos"]), self.decor_tris)


class _CollisionBuilder(LevelVisitor):
    """Collision triangle soup per object (ref game/src/world.rs:211-409).

    The reference also mirrors the BSP into leaf chunks for culling; the
    TPU path brute-forces a masked min-reduce over all triangles per env
    (v1), so only the per-object grouping is kept here.
    """

    def __init__(self):
        self.by_object: dict[int, list] = {0: []}

    def _add_polygon(self, object_id: int, verts: list, normal):
        tris = self.by_object.setdefault(object_id, [])
        for i in range(2, len(verts)):
            tris.append((verts[0], verts[i - 1], verts[i], normal))

    def visit_floor_poly(self, poly: StaticPoly):
        self._add_polygon(
            poly.object_id,
            [(v[0], poly.height, v[1]) for v in poly.vertices],
            (0.0, 1.0, 0.0),
        )

    def visit_ceil_poly(self, poly: StaticPoly):
        self._add_polygon(
            poly.object_id,
            [(v[0], poly.height, v[1]) for v in reversed(poly.vertices)],
            (0.0, -1.0, 0.0),
        )

    visit_floor_sky_poly = visit_floor_poly
    visit_ceil_sky_poly = visit_ceil_poly

    def visit_sky_quad(self, quad: SkyQuad):
        (v1, v2) = quad.vertices
        (low, high) = quad.height_range
        dx, dy = v2[0] - v1[0], v2[1] - v1[1]
        mag = math.hypot(dx, dy)
        edge = (dx / mag, dy / mag) if mag > 0 else (0.0, 0.0)
        normal = (-edge[1], 0.0, edge[0])
        self._add_polygon(
            quad.object_id,
            [
                (v1[0], low, v1[1]),
                (v2[0], low, v2[1]),
                (v2[0], high, v2[1]),
                (v1[0], high, v1[1]),
            ],
            normal,
        )

    def visit_wall_quad(self, quad: StaticQuad):
        # Only blocking walls collide (ref world.rs:378-386).
        if quad.blocker:
            self.visit_sky_quad(
                SkyQuad(
                    object_id=quad.object_id,
                    vertices=quad.vertices,
                    height_range=quad.height_range,
                )
            )


def _decor_sprite_names(level: LevelData, meta: WadMetadata):
    """Sprite names referenced by this level's things
    (ref game/src/game_shaders.rs:331-349)."""
    names = []
    for thing in level.things:
        t = meta.find_thing(int(thing["thing_type"]))
        if t is None:
            continue
        try:
            base = name_push(t.sprite, t.sequence.encode()[0])
            names.append(name_push(base, ord("0")))
            names.append(name_push(base, ord("1")))
        except Exception:
            continue
    return names


def compile_level(
    wad: Archive,
    tex: TextureDirectory,
    meta: WadMetadata,
    level_index: int,
) -> LevelArrays:
    """Load + analyze + walk one level into dense arrays."""
    level = LevelData(wad, level_index)
    analysis = LevelAnalysis(level, meta)

    # Atlases (ref game_shaders.rs:282-356).
    flat_names = [
        n
        for s in level.sectors
        for n in (pad8(s["floor_texture"]), pad8(s["ceiling_texture"]))
        if not is_untextured(n) and not is_sky_flat(n)
    ]
    flats_atlas, flats_bounds = tex.build_flat_atlas(flat_names)
    wall_names = [
        n
        for s in level.sidedefs
        for n in (
            pad8(s["upper_texture"]),
            pad8(s["lower_texture"]),
            pad8(s["middle_texture"]),
        )
        if not is_untextured(n)
    ]
    walls_atlas, walls_bounds = tex.build_texture_atlas(wall_names)
    decor_atlas, decor_bounds = tex.build_texture_atlas(
        _decor_sprite_names(level, meta)
    )

    sky_meta = meta.sky_for(level.name)
    if sky_meta is not None and tex.texture(sky_meta.texture_name) is not None:
        sky_img = tex.texture(sky_meta.texture_name)
        sky_index, _ = sky_img.to_index_alpha()
        tiled_band_size = sky_meta.tiled_band_size
    else:
        log.error("no sky texture for level %r", level.name)
        sky_index = np.zeros((1, 1), dtype=np.uint8)
        tiled_band_size = 0.0

    render = _RenderBuilder(walls_bounds, flats_bounds, decor_bounds)
    collision = _CollisionBuilder()
    walker = LevelWalker(
        level, analysis, tex, meta, chain_visitors(render, collision)
    )
    walker.walk()

    # -- pack static -----------------------------------------------------
    def f32(x, shape2=None):
        a = np.asarray(x, dtype=np.float32)
        if a.size == 0 and shape2:
            a = a.reshape((0,) + shape2)
        return a

    def i32(x):
        return np.asarray(x, dtype=np.int32)

    # -- collision soup, object 0 first --------------------------------
    cv0, cv1, cv2, cn, cobj = [], [], [], [], []
    for obj in sorted(collision.by_object):
        for (a, b, c, n) in collision.by_object[obj]:
            cv0.append(a)
            cv1.append(b)
            cv2.append(c)
            cn.append(n)
            cobj.append(obj)

    coll_v0_arr = f32(cv0, (3,))
    coll_v1_arr = f32(cv1, (3,))
    coll_v2_arr = f32(cv2, (3,))
    bp_origin, bp_inv_cell, bp_nx, bp_nz, bp_cells = build_grid(
        coll_v0_arr, coll_v1_arr, coll_v2_arr
    )

    # -- triggers ----------------------------------------------------------
    # Unimplemented triggers (unknown specials, ref visitor.rs:475-489) are
    # kept in the analysis for load-time logging/parity, but dropped from
    # the DEVICE tables: when one fires in the reference it has no move
    # effects, no exit, and is not only_once -- the only observable is an
    # error log (ref level.rs:149-151). Polling them every tick is pure
    # waste on the hot path.
    triggers: list[Trigger] = [t for t in analysis.triggers if not t.unimplemented]
    trig_origin = f32([t.line.origin for t in triggers], (2,))
    trig_displace = f32([t.line.displace for t in triggers], (2,))
    trig_length = f32([t.line.length for t in triggers])
    trig_type = i32([TRIGGER_TYPE_IDS[t.trigger_type] for t in triggers])
    trig_only_once = np.asarray([t.only_once for t in triggers], dtype=bool)
    trig_exit = i32(
        [
            EXIT_NONE
            if t.exit_effect is None
            else (EXIT_NORMAL if t.exit_effect == "Normal" else EXIT_SECRET)
            for t in triggers
        ]
    )
    trig_special = i32([t.special_type for t in triggers])
    eff = [(i, e) for i, t in enumerate(triggers) for e in t.move_effects]
    eff_trigger = i32([i for i, _ in eff])
    eff_object = i32([e.object_id for _, e in eff])
    eff_first = f32([e.first_height_offset for _, e in eff])
    eff_second = f32(
        [
            e.second_height_offset if e.second_height_offset is not None else 0.0
            for _, e in eff
        ]
    )
    eff_has_second = np.asarray(
        [e.second_height_offset is not None for _, e in eff], dtype=bool
    )
    eff_speed = f32([e.speed for _, e in eff])
    eff_wait = f32([e.wait for _, e in eff])
    eff_repeat = np.asarray([e.repeat for _, e in eff], dtype=bool)

    from .portal import build_portal_table

    portal_table = build_portal_table(
        level, analysis, render.seg_pieces, flats_bounds,
        walls_atlas.to_index_alpha()[1], render.lights.push,
        sprites=render.sprite_records,
    )

    lights = render.lights.infos or [LightInfo(level=1.0)]
    walls_idx, walls_alpha = walls_atlas.to_index_alpha()
    decor_idx, decor_alpha = decor_atlas.to_index_alpha()

    # Combined COLORMAPPED atlas for single-take sampling on TPU: plane
    # order [flats, walls, decor, sky], one copy per colormap row r with
    # value = colormaps[r][index] | (hole << 8). Folds the texel fetch,
    # the transparency test, AND the colormap LUT into one take per depth
    # layer (sky samples ride along as plane 3 at row 0).
    def _safe_hw(a):
        return (max(a.shape[0], 1), max(a.shape[1], 1))

    fh, fw = _safe_hw(flats_atlas)
    wh, ww = _safe_hw(walls_idx)
    dh, dw = _safe_hw(decor_idx)
    sh_, sw_ = _safe_hw(sky_index)
    hc, wc = max(fh, wh, dh, sh_), max(fw, ww, dw, sw_)
    cmaps = tex.colormaps[:32].astype(np.int32)  # (32, 256)
    base = np.full((4, hc, wc), 256, dtype=np.int32)  # default: hole
    base[0, :fh, :fw] = flats_atlas[:fh, :fw]
    if walls_idx.size:
        base[1, : walls_idx.shape[0], : walls_idx.shape[1]] = (
            walls_idx.astype(np.int32) | ((~walls_alpha).astype(np.int32) << 8)
        )
    if decor_idx.size:
        base[2, : decor_idx.shape[0], : decor_idx.shape[1]] = (
            decor_idx.astype(np.int32) | ((~decor_alpha).astype(np.int32) << 8)
        )
    base[3, : sky_index.shape[0], : sky_index.shape[1]] = sky_index
    hole_bits = base & 256
    indices = base & 255
    # uint16: values are idx | hole<<8 <= 511; at real-WAD texture volume
    # the (32, 4, hc, wc) table dominates device memory (int32 was
    # 537 MB on :texstress:), and every consumer masks/compares.
    combo = (cmaps[:, indices] | hole_bits[None]).astype(np.uint16)
    combo_dims = np.array(
        [[fh, fw], [wh, ww], [dh, dw], [sh_, sw_]], dtype=np.int32
    )

    # Per-wall-triangle transparency: does the triangle's (base-frame) atlas
    # region contain any transparent texel? Lets the renderer depth-resolve
    # opaque walls in the fast single-layer pass. Conservative for animated
    # walls (base frame only).
    wall_tris_arr = i32(render.wall_tris).reshape(-1, 3)
    wall_transparent = np.zeros(len(wall_tris_arr), dtype=bool)
    if len(wall_tris_arr) and walls_alpha.size:
        sv_auv = np.asarray(render.sv["atlas_uv"], dtype=np.float32)
        sv_tsz = np.asarray(render.sv["tile_size"], dtype=np.float32)
        ah, aw = walls_alpha.shape
        for t, tri in enumerate(wall_tris_arr):
            v = int(tri[0])
            x0, y0 = int(sv_auv[v][0]), int(sv_auv[v][1])
            w, h = int(sv_tsz[v][0]), int(sv_tsz[v][1])
            region = walls_alpha[y0 : min(y0 + h, ah), x0 : min(x0 + w, aw)]
            wall_transparent[t] = bool((~region).any())

    arrays = LevelArrays(
        name=level.name,
        num_objects=analysis.num_objects,
        static_pos=f32(render.sv["pos"], (3,)),
        static_atlas_uv=f32(render.sv["atlas_uv"], (2,)),
        static_tile_uv=f32(render.sv["tile_uv"], (2,)),
        static_tile_size=f32(render.sv["tile_size"], (2,)),
        static_scroll=f32(render.sv["scroll"]),
        static_row_height=f32(render.sv["row_height"]),
        static_num_frames=i32(render.sv["num_frames"]),
        static_light=i32(render.sv["light"]),
        static_object=i32(render.sv["object"]),
        wall_tris=wall_tris_arr,
        wall_tri_transparent=wall_transparent,
        flat_tris=i32(render.flat_tris).reshape(-1, 3),
        sky_pos=f32(render.sky_pos, (3,)),
        sky_object=i32(render.sky_object),
        sky_tris=i32(render.sky_tris).reshape(-1, 3),
        decor_pos=f32(render.dv["pos"], (3,)),
        decor_local_x=f32(render.dv["local_x"]),
        decor_atlas_uv=f32(render.dv["atlas_uv"], (2,)),
        decor_tile_uv=f32(render.dv["tile_uv"], (2,)),
        decor_tile_size=f32(render.dv["tile_size"], (2,)),
        decor_num_frames=i32(render.dv["num_frames"]),
        decor_light=i32(render.dv["light"]),
        decor_object=i32(render.dv["object"]),
        decor_tris=i32(render.decor_tris).reshape(-1, 3),
        coll_v0=coll_v0_arr,
        coll_v1=coll_v1_arr,
        coll_v2=coll_v2_arr,
        coll_normal=f32(cn, (3,)),
        coll_object=i32(cobj),
        bp_origin=bp_origin,
        bp_inv_cell=np.float32(bp_inv_cell),
        bp_dims=np.array([bp_nx, bp_nz], dtype=np.int32),
        bp_cells=bp_cells,
        trig_origin=trig_origin.reshape(-1, 2),
        trig_displace=trig_displace.reshape(-1, 2),
        trig_length=trig_length,
        trig_type=trig_type,
        trig_only_once=trig_only_once,
        trig_exit=trig_exit,
        trig_special=trig_special,
        eff_trigger=eff_trigger,
        eff_object=eff_object,
        eff_first_offset=eff_first,
        eff_second_offset=eff_second,
        eff_has_second=eff_has_second,
        eff_speed=eff_speed,
        eff_wait=eff_wait,
        eff_repeat=eff_repeat,
        light_level=f32([l.level for l in lights]),
        light_kind=i32([l.kind for l in lights]),
        light_alt=f32([l.alt_level for l in lights]),
        light_speed=f32([l.speed for l in lights]),
        light_duration=f32([l.duration for l in lights]),
        light_sync=f32([l.sync for l in lights]),
        palette=tex.palettes[0].copy(),
        palette_lut=tex.build_palette_texture(0, 0, 32),
        colormaps=tex.colormaps.copy(),
        walls_atlas_index=walls_idx,
        walls_atlas_alpha=walls_alpha,
        flats_atlas=flats_atlas,
        decor_atlas_index=decor_idx,
        decor_atlas_alpha=decor_alpha,
        combo_atlas=combo,
        combo_dims=combo_dims,
        sky_index=sky_index,
        tiled_band_size=float(tiled_band_size),
        start_pos=render.start_pos,
        start_yaw=float(render.start_yaw),
        portal=portal_table,
        stats=dict(render.counts),
    )
    log.info(
        "level %r compiled: %d static verts, %d wall tris, %d flat tris, "
        "%d sky tris, %d decor tris, %d coll tris, %d triggers, %d effects, "
        "%d lights, %d objects",
        level.name,
        len(arrays.static_pos),
        len(arrays.wall_tris),
        len(arrays.flat_tris),
        len(arrays.sky_tris),
        len(arrays.decor_tris),
        len(arrays.coll_v0),
        len(triggers),
        len(eff),
        len(lights),
        analysis.num_objects,
    )
    return arrays
