"""On-disk WAD lump layouts as NumPy structured dtypes (all little-endian).

Reference: rust-doom's wad/src/types.rs:19-196 (bincode structs). Instead
of per-element decoding we `np.frombuffer` whole lumps -- the dense-array form
is also exactly what the TPU data model wants.

Coordinate conventions (ref wad/src/util.rs:12-26):
  from_wad_height(h) = h / 100.0
  from_wad_coords(x, y) -> game-space 2D point (-y/100, -x/100)
so game axes are (x_game, y_game=up, z_game) with x_game = -y_wad/100 and
z_game = -x_wad/100.
"""

from __future__ import annotations

import numpy as np

WAD_INFO_DTYPE = np.dtype(
    [("identifier", "S4"), ("num_lumps", "<i4"), ("info_table_offset", "<i4")]
)

LUMP_INFO_DTYPE = np.dtype([("file_pos", "<i4"), ("size", "<i4"), ("name", "S8")])

THING_DTYPE = np.dtype(
    [
        ("x", "<i2"),
        ("y", "<i2"),
        ("angle", "<i2"),
        ("thing_type", "<u2"),
        ("flags", "<u2"),
    ]
)

VERTEX_DTYPE = np.dtype([("x", "<i2"), ("y", "<i2")])

LINEDEF_DTYPE = np.dtype(
    [
        ("start_vertex", "<u2"),
        ("end_vertex", "<u2"),
        ("flags", "<u2"),
        ("special_type", "<u2"),
        ("sector_tag", "<u2"),
        ("right_side", "<i2"),
        ("left_side", "<i2"),
    ]
)

SIDEDEF_DTYPE = np.dtype(
    [
        ("x_offset", "<i2"),
        ("y_offset", "<i2"),
        ("upper_texture", "S8"),
        ("lower_texture", "S8"),
        ("middle_texture", "S8"),
        ("sector", "<u2"),
    ]
)

SECTOR_DTYPE = np.dtype(
    [
        ("floor_height", "<i2"),
        ("ceiling_height", "<i2"),
        ("floor_texture", "S8"),
        ("ceiling_texture", "S8"),
        ("light", "<i2"),
        ("sector_type", "<u2"),
        ("tag", "<u2"),
    ]
)

SUBSECTOR_DTYPE = np.dtype([("num_segs", "<u2"), ("first_seg", "<u2")])

SEG_DTYPE = np.dtype(
    [
        ("start_vertex", "<u2"),
        ("end_vertex", "<u2"),
        ("angle", "<u2"),
        ("linedef", "<u2"),
        ("direction", "<u2"),
        ("offset", "<u2"),
    ]
)

NODE_DTYPE = np.dtype(
    [
        ("line_x", "<i2"),
        ("line_y", "<i2"),
        ("step_x", "<i2"),
        ("step_y", "<i2"),
        ("right_y_max", "<i2"),
        ("right_y_min", "<i2"),
        ("right_x_max", "<i2"),
        ("right_x_min", "<i2"),
        ("left_y_max", "<i2"),
        ("left_y_min", "<i2"),
        ("left_x_max", "<i2"),
        ("left_x_min", "<i2"),
        ("right", "<u2"),
        ("left", "<u2"),
    ]
)

TEXTURE_HEADER_DTYPE = np.dtype(
    [
        ("name", "S8"),
        ("masked", "<u4"),
        ("width", "<u2"),
        ("height", "<u2"),
        ("column_directory", "<u4"),
        ("num_patches", "<u2"),
    ]
)

TEXTURE_PATCH_REF_DTYPE = np.dtype(
    [
        ("origin_x", "<i2"),
        ("origin_y", "<i2"),
        ("patch", "<u2"),
        ("stepdir", "<u2"),
        ("colormap", "<u2"),
    ]
)

PALETTE_SIZE = 256 * 3
COLORMAP_SIZE = 256

# Linedef flag bits (ref wad/src/types.rs:59-95).
LINEDEF_IMPASSABLE = 0x0001
LINEDEF_BLOCKS_MONSTERS = 0x0002
LINEDEF_TWO_SIDED = 0x0004
LINEDEF_UPPER_UNPEGGED = 0x0008
LINEDEF_LOWER_UNPEGGED = 0x0010
LINEDEF_SECRET = 0x0020
LINEDEF_BLOCKS_SOUND = 0x0040
LINEDEF_ALWAYS_ON_MAP = 0x0080
LINEDEF_NEVER_ON_MAP = 0x0100


def from_wad_height(x):
    """WAD i16 height -> game float (ref wad/src/util.rs:12-14)."""
    return np.asarray(x, dtype=np.float32) / np.float32(100.0)


def to_wad_height(x):
    return np.asarray(x, dtype=np.float32) * np.float32(100.0)


def from_wad_coords(x, y):
    """(x_wad, y_wad) -> game (x, z) = (-y/100, -x/100) (ref util.rs:20-22)."""
    return np.stack(
        [from_wad_height(y) * -1.0, from_wad_height(x) * -1.0], axis=-1
    )


def parse_child_id(child_id):
    """BSP child id -> (index, is_leaf) (ref wad/src/util.rs:24-26)."""
    child_id = np.asarray(child_id).astype(np.int64)
    return child_id & 0x7FFF, (child_id & 0x8000) != 0
