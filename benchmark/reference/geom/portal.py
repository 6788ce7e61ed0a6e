"""Portal (column) renderer tables: per-seg crossing records.

Doom's geometry is 2.5D: at zero pitch every wall is screen-vertical and
every flat is a horizontal plane, so a column renderer does W x S seg
crossings instead of the triangle rasterizer's P x T coverage tests
(~100x less arithmetic at 320x200). These tables flatten everything a
column crossing needs: seg geometry, front/back sector heights (base +
movable-object id), sky flags, per-sector flat texturing, and the
lower/middle/upper wall-piece records captured from the walker's quads
(identical pegging/uv/light data to the triangle path).

Built once per level on the host; the runtime lives in
tpu_doom_torch/render/portal.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..wad.level import LevelData
from ..wad.light import light_info_for_sector
from ..wad.name import is_sky_flat, pad8
from .analysis import LevelAnalysis

PIECES = ("lower", "middle", "upper")  # "solid" is stored in the middle slot


@dataclass
class PortalTable:
    """All (S, ...) numpy arrays; see build_portal_table."""

    p1: np.ndarray  # (S, 2) game XZ
    p2: np.ndarray  # (S, 2)
    has_back: np.ndarray  # (S,) bool
    # Heights: base game-units + movable object id (offset added at runtime).
    f_floor: np.ndarray  # (S,)
    f_ceil: np.ndarray
    b_floor: np.ndarray
    b_ceil: np.ndarray
    f_floor_obj: np.ndarray  # (S,) i32
    f_ceil_obj: np.ndarray
    b_floor_obj: np.ndarray
    b_ceil_obj: np.ndarray
    f_floor_sky: np.ndarray  # (S,) bool
    f_ceil_sky: np.ndarray
    b_floor_sky: np.ndarray
    b_ceil_sky: np.ndarray
    # Front-sector flat texturing (for the spans between crossings).
    flat_light: np.ndarray  # (S,) f32 light VALUE index into light table
    floor_atlas: np.ndarray  # (S, 6): atlas_uv(2), tile_size(2), row_h, frames
    ceil_atlas: np.ndarray  # (S, 6)
    # Wall pieces: (S, 3, ...) in PIECES order.
    piece_exists: np.ndarray  # (S, 3) bool
    piece_low: np.ndarray  # (S, 3) base height
    piece_high: np.ndarray
    piece_obj: np.ndarray  # (S, 3) i32
    piece_s1: np.ndarray  # (S, 3) u at seg start
    piece_s2: np.ndarray  # (S, 3) u at seg end
    piece_t1: np.ndarray  # (S, 3) v at low
    piece_t2: np.ndarray  # (S, 3) v at high
    piece_light: np.ndarray  # (S, 3) i32 light index
    piece_scroll: np.ndarray  # (S, 3)
    piece_atlas: np.ndarray  # (S, 3, 6)
    piece_transparent: np.ndarray  # (S, 3) bool (masked: in-walk alpha)
    hmin: np.ndarray  # () f32 sky floor extent
    hmax: np.ndarray  # () f32 sky ceiling extent
    # Sprites (decor billboards) as runtime crossings: the billboard seg
    # endpoints are center +- camera_right * half_width, computed per env
    # in the walk (ref sprite.vert:40-41 billboarding).
    sprite_center: np.ndarray  # (D, 2) game XZ
    sprite_half: np.ndarray  # (D,)
    sprite_low: np.ndarray  # (D,) base height
    sprite_high: np.ndarray  # (D,)
    sprite_obj: np.ndarray  # (D,) i32 movable object id
    sprite_s2: np.ndarray  # (D,) u texel at right edge (left edge = 0)
    sprite_t1: np.ndarray  # (D,) v texel at low
    sprite_t2: np.ndarray  # (D,) v texel at high
    sprite_light: np.ndarray  # (D,) i32
    sprite_atlas: np.ndarray  # (D, 6)


def _bounds6(bounds) -> list:
    return [
        bounds.pos[0],
        bounds.pos[1],
        bounds.size[0],
        bounds.size[1],
        float(bounds.row_height),
        float(bounds.num_frames),
    ]


def build_portal_table(
    level: LevelData,
    analysis: LevelAnalysis,
    seg_pieces: dict,
    flats_bounds: dict,
    walls_alpha: np.ndarray,
    lights_push,
    sprites: list | None = None,
) -> PortalTable:
    """seg_pieces: the walker-captured {(seg_id, piece): record} dict;
    lights_push: the render builder's dedup light-table push fn;
    sprites: the render builder's per-decor scalar records."""
    S = len(level.segs)
    zeros6 = [0.0] * 6

    def sector_info(sid):
        s = level.sectors[sid]
        return (
            float(s["floor_height"]) / 100.0,
            float(s["ceiling_height"]) / 100.0,
            analysis.floor_id(sid),
            analysis.ceiling_id(sid),
            is_sky_flat(pad8(s["floor_texture"])),
            is_sky_flat(pad8(s["ceiling_texture"])),
            pad8(s["floor_texture"]),
            pad8(s["ceiling_texture"]),
        )

    cols = {k: [] for k in (
        "p1", "p2", "has_back", "f_floor", "f_ceil", "b_floor", "b_ceil",
        "f_floor_obj", "f_ceil_obj", "b_floor_obj", "b_ceil_obj",
        "f_floor_sky", "f_ceil_sky", "b_floor_sky", "b_ceil_sky",
        "flat_light", "floor_atlas", "ceil_atlas",
    )}
    pieces = {k: [] for k in (
        "exists", "low", "high", "obj", "s1", "s2", "t1", "t2", "light",
        "scroll", "atlas", "transparent",
    )}

    hmin, hmax = level.min_max_height()
    hmin_g, hmax_g = hmin / 100.0, hmax / 100.0

    for i in range(S):
        seg = level.segs[i]
        v1 = level.vertex(int(seg["start_vertex"]))
        v2 = level.vertex(int(seg["end_vertex"]))
        fsid = level.seg_sector_id(seg)
        bsid = level.seg_back_sector_id(seg)
        if fsid is None:
            # Degenerate: zero-length placeholder never crossed.
            cols["p1"].append((0.0, 0.0))
            cols["p2"].append((0.0, 0.0))
            cols["has_back"].append(False)
            for k in ("f_floor", "f_ceil", "b_floor", "b_ceil", "flat_light"):
                cols[k].append(0.0)
            for k in ("f_floor_obj", "f_ceil_obj", "b_floor_obj", "b_ceil_obj"):
                cols[k].append(0)
            for k in ("f_floor_sky", "f_ceil_sky", "b_floor_sky", "b_ceil_sky"):
                cols[k].append(False)
            cols["floor_atlas"].append(zeros6)
            cols["ceil_atlas"].append(zeros6)
            for k in pieces:
                pieces[k].append([0] * 3 if k != "atlas" else [zeros6] * 3)
            continue
        ff, fc, ffo, fco, ffs, fcs, ftex, ctex = sector_info(fsid)
        cols["p1"].append(tuple(map(float, v1)))
        cols["p2"].append(tuple(map(float, v2)))
        cols["has_back"].append(bsid is not None)
        cols["f_floor"].append(ff)
        cols["f_ceil"].append(fc)
        cols["f_floor_obj"].append(ffo)
        cols["f_ceil_obj"].append(fco)
        cols["f_floor_sky"].append(ffs)
        cols["f_ceil_sky"].append(fcs)
        if bsid is not None:
            bf, bc, bfo, bco, bfs, bcs, _, _ = sector_info(bsid)
        else:
            bf = bc = 0.0
            bfo = bco = 0
            bfs = bcs = False
        cols["b_floor"].append(bf)
        cols["b_ceil"].append(bc)
        cols["b_floor_obj"].append(bfo)
        cols["b_ceil_obj"].append(bco)
        cols["b_floor_sky"].append(bfs)
        cols["b_ceil_sky"].append(bcs)
        cols["flat_light"].append(lights_push(light_info_for_sector(level, fsid)))
        fb = flats_bounds.get(ftex)
        cb = flats_bounds.get(ctex)
        cols["floor_atlas"].append(_bounds6(fb) if fb else zeros6)
        cols["ceil_atlas"].append(_bounds6(cb) if cb else zeros6)

        row = {k: [] for k in pieces}
        for piece in PIECES:
            rec = seg_pieces.get((i, piece))
            if rec is None and piece == "middle":
                rec = seg_pieces.get((i, "solid"))
            if rec is None:
                for k in pieces:
                    row[k].append(0 if k != "atlas" else zeros6)
                continue
            b = rec["bounds"]
            # Masked middles (any transparent texel in the base region) are
            # non-occluding and deferred to the sprite/masked pass.
            transparent = False
            if piece == "middle" and cols["has_back"][-1] and walls_alpha.size:
                x0, y0 = int(b.pos[0]), int(b.pos[1])
                w, h = int(b.size[0]), int(b.size[1])
                region = walls_alpha[y0 : y0 + h, x0 : x0 + w]
                transparent = bool((~region).any())
            row["exists"].append(1)
            row["low"].append(rec["low"])
            row["high"].append(rec["high"])
            row["obj"].append(rec["object_id"])
            row["s1"].append(rec["s1"])
            row["s2"].append(rec["s2"])
            row["t1"].append(rec["t1"])
            row["t2"].append(rec["t2"])
            row["light"].append(rec["light"])
            row["scroll"].append(rec["scroll"])
            row["atlas"].append(_bounds6(b))
            row["transparent"].append(int(transparent))
        for k in pieces:
            pieces[k].append(row[k])

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    b_ = lambda x: np.asarray(x, dtype=bool)
    sprites = sprites or []
    D = len(sprites)
    sp = {
        "center": f32([s["center"] for s in sprites]).reshape(D, 2),
        "half": f32([s["half_width"] for s in sprites]),
        "low": f32([s["low"] for s in sprites]),
        "high": f32([s["high"] for s in sprites]),
        "obj": i32([s["object_id"] for s in sprites]),
        "s2": f32([s["s2"] for s in sprites]),
        "t1": f32([s["t1"] for s in sprites]),
        "t2": f32([s["t2"] for s in sprites]),
        "light": i32([s["light"] for s in sprites]),
        "atlas": f32([_bounds6(s["bounds"]) for s in sprites]).reshape(D, 6),
    }
    return PortalTable(
        p1=f32(cols["p1"]).reshape(S, 2),
        p2=f32(cols["p2"]).reshape(S, 2),
        has_back=b_(cols["has_back"]),
        f_floor=f32(cols["f_floor"]),
        f_ceil=f32(cols["f_ceil"]),
        b_floor=f32(cols["b_floor"]),
        b_ceil=f32(cols["b_ceil"]),
        f_floor_obj=i32(cols["f_floor_obj"]),
        f_ceil_obj=i32(cols["f_ceil_obj"]),
        b_floor_obj=i32(cols["b_floor_obj"]),
        b_ceil_obj=i32(cols["b_ceil_obj"]),
        f_floor_sky=b_(cols["f_floor_sky"]),
        f_ceil_sky=b_(cols["f_ceil_sky"]),
        b_floor_sky=b_(cols["b_floor_sky"]),
        b_ceil_sky=b_(cols["b_ceil_sky"]),
        flat_light=i32(cols["flat_light"]),
        floor_atlas=f32(cols["floor_atlas"]).reshape(S, 6),
        ceil_atlas=f32(cols["ceil_atlas"]).reshape(S, 6),
        piece_exists=b_(pieces["exists"]).reshape(S, 3),
        piece_low=f32(pieces["low"]).reshape(S, 3),
        piece_high=f32(pieces["high"]).reshape(S, 3),
        piece_obj=i32(pieces["obj"]).reshape(S, 3),
        piece_s1=f32(pieces["s1"]).reshape(S, 3),
        piece_s2=f32(pieces["s2"]).reshape(S, 3),
        piece_t1=f32(pieces["t1"]).reshape(S, 3),
        piece_t2=f32(pieces["t2"]).reshape(S, 3),
        piece_light=i32(pieces["light"]).reshape(S, 3),
        piece_scroll=f32(pieces["scroll"]).reshape(S, 3),
        piece_atlas=f32(pieces["atlas"]).reshape(S, 3, 6),
        piece_transparent=b_(pieces["transparent"]).reshape(S, 3),
        hmin=np.float32(hmin_g),
        hmax=np.float32(hmax_g),
        sprite_center=sp["center"],
        sprite_half=sp["half"],
        sprite_low=sp["low"],
        sprite_high=sp["high"],
        sprite_obj=sp["obj"],
        sprite_s2=sp["s2"],
        sprite_t1=sp["t1"],
        sprite_t2=sp["t2"],
        sprite_light=sp["light"],
        sprite_atlas=sp["atlas"],
    )
