"""Synthetic IWAD generator (test fixture).

No copyrighted WAD ships with this repo (and the build environment has no
network), so tests and benchmarks run on procedurally generated IWADs that
exercise the same code paths as the real thing: picture-format patches and
sprites, composite TEXTURE1 textures, flats, PLAYPAL/COLORMAP, and a
multi-sector level (door, lift, nukage pool with animated flats, sky
ceiling, light-effect sectors, scrolling wall, exit switch, transparent
grate) with a real BSP built by a small axis-aligned node builder.

The generated WAD is compatible with the reference's loader conventions
(rust-doom's wad/src): level lumps at fixed offsets from the marker,
BSP child sides matching vanilla Doom's R_PointOnSide so that the engine's
`sector_at`/LevelWalker descend correctly, and metadata-compatible names
(SKY1, NUKAGE1-3, barrel/candle things) so assets/meta/doom.toml applies.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

import numpy as np

from . import types as T

# ---------------------------------------------------------------------------
# Picture-format encoding (inverse of image.py's decoder).
# ---------------------------------------------------------------------------


def encode_picture(
    index: np.ndarray, opaque: np.ndarray, x_offset: int = 0, y_offset: int = 0
) -> bytes:
    """Encode (H, W) palette indices + opaque mask into the Doom picture
    format (column RLE "posts")."""
    h, w = index.shape
    header = struct.pack("<HHhh", w, h, x_offset, y_offset)
    columns = []
    for x in range(w):
        posts = bytearray()
        y = 0
        while y < h:
            if not opaque[y, x]:
                y += 1
                continue
            start = y
            while y < h and opaque[y, x] and (y - start) < 254 and y < 254:
                y += 1
            run = index[start:y, x].astype(np.uint8).tobytes()
            posts += bytes([start, y - start, 0]) + run + b"\0"
        posts += b"\xff"
        columns.append(bytes(posts))
    dir_size = 8 + 4 * w
    offsets = []
    pos = dir_size
    for col in columns:
        offsets.append(pos)
        pos += len(col)
    return header + struct.pack(f"<{w}I", *offsets) + b"".join(columns)


# ---------------------------------------------------------------------------
# Palette / colormap / texture patterns.
# ---------------------------------------------------------------------------


def make_playpal() -> bytes:
    """One grayscale palette: index i -> (i, i, i). Makes colormap math exact
    and index-level parity easy to eyeball."""
    ramp = np.arange(256, dtype=np.uint8)
    return np.stack([ramp, ramp, ramp], axis=-1).tobytes()


def make_colormap() -> bytes:
    """34 colormaps: rows 0..31 darken by (32-m)/32 (exact on the grayscale
    palette), row 32 inverts (invulnerability), row 33 is black."""
    i = np.arange(256, dtype=np.int32)
    rows = [((i * (32 - m)) // 32).astype(np.uint8) for m in range(32)]
    rows.append((255 - i).astype(np.uint8))
    rows.append(np.zeros(256, dtype=np.uint8))
    return np.stack(rows).tobytes()


def _checker(h, w, a, b, size=8):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.where(((yy // size + xx // size) % 2) == 0, a, b).astype(np.uint8)


def _vgrad(h, w, lo, hi):
    col = np.linspace(lo, hi, h).astype(np.uint8)
    return np.repeat(col[:, None], w, axis=1)


def make_patches() -> dict[bytes, bytes]:
    full = np.ones((128, 64), dtype=bool)
    patches = {}
    patches[b"PWALL1\0\0"] = encode_picture(_checker(128, 64, 96, 192), full)
    patches[b"PWALL2\0\0"] = encode_picture(_vgrad(128, 64, 32, 224), full)
    door = _checker(128, 64, 140, 150, 16)
    door[:8, :] = 60
    door[-8:, :] = 60
    door[:, :8] = 60
    door[:, -8:] = 60
    patches[b"PDOOR1\0\0"] = encode_picture(door, full)
    sw = _vgrad(128, 64, 100, 180)
    sw[48:80, 16:48] = 250
    patches[b"PSW1S\0\0\0"] = encode_picture(sw, np.ones_like(sw, dtype=bool))
    grate = _checker(128, 64, 30, 40, 4)
    mask = np.ones((128, 64), dtype=bool)
    mask[:, 8:16] = False
    mask[:, 24:32] = False
    mask[:, 40:48] = False
    mask[:, 56:64] = False
    patches[b"PGRATE1\0"] = encode_picture(grate, mask)
    yy, xx = np.mgrid[0:128, 0:256]
    sky = ((xx * 255) // 256).astype(np.uint8)
    sky[96:, :] = 40  # "mountains" band at the bottom
    patches[b"PSKY1\0\0\0"] = encode_picture(sky, np.ones_like(sky, dtype=bool))
    return patches


def make_stress_patches(n: int, seed: int = 7) -> dict[bytes, bytes]:
    """``n`` DISTINCT 64x128 wall patches for the texstress fixture.

    A real IWAD's TextureDirectory packs hundreds of distinct wall
    textures into a multi-megatexel atlas (ref wad/src/tex.rs:168-271);
    the synthetic base fixture has only 6, so every compact texel table
    it produces is tiny. These procedurally varied patches (checkers,
    gradients, stripes, rings at per-patch scales and palette bands)
    recreate that texel volume so the renderer's large-table path is
    exercised and benchmarked at realistic scale."""
    rng = np.random.default_rng(seed)
    full = np.ones((128, 64), dtype=bool)
    yy, xx = np.mgrid[0:128, 0:64]
    out = {}
    for i in range(n):
        a = int(rng.integers(16, 200))
        b = int(rng.integers(24, 100))
        size = int(rng.choice([4, 8, 16, 32]))
        kind = i % 4
        if kind == 0:
            img = np.where(((yy // size + xx // size) % 2) == 0, a, a + b)
        elif kind == 1:
            img = a + (yy * int(rng.integers(1, 4))
                       + xx * int(rng.integers(0, 3))) % max(b, 2)
        elif kind == 2:
            img = a + ((xx // size) % 2) * (b // 2) + yy % 8
        else:
            img = a + ((xx - 32) ** 2 + (yy - 64) ** 2) // (size * 8) % max(b, 2)
        out[b"PSTR%04d" % i] = encode_picture(
            (img % 256).astype(np.uint8), full)
    return out


def make_stress_flats(n: int, seed: int = 11) -> dict[bytes, bytes]:
    """``n`` distinct 64x64 flats for the texstress fixture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64]
    out = {}
    for i in range(n):
        a = int(rng.integers(40, 200))
        size = int(rng.choice([4, 8, 16]))
        img = a + ((yy // size + xx // size + i) % 4) * 12
        out[b"FSTR%03d\0" % i] = (img % 256).astype(np.uint8).tobytes()
    return out


def _texture_lump(texdefs: list[tuple[bytes, int, int, int]]) -> bytes:
    """Serialize a TEXTURE1/TEXTURE2 lump from (name, w, h, patch_index)."""
    headers = []
    for name, w, h, ipatch in texdefs:
        headers.append(
            struct.pack("<8sIHHIH", name, 0, w, h, 0, 1)
            + struct.pack("<hhHHH", 0, 0, ipatch, 0, 0)
        )
    n = len(texdefs)
    dir_size = 4 + 4 * n
    out = struct.pack("<I", n)
    pos = dir_size
    offs = []
    for hd in headers:
        offs.append(pos)
        pos += len(hd)
    out += struct.pack(f"<{n}I", *offs)
    return out + b"".join(headers)


def make_texture1(
    patch_names: list[bytes],
    extra: list[tuple[bytes, int, int, bytes]] | None = None,
) -> bytes:
    """TEXTURE1 lump: each texture = one full-size patch blit. ``extra``
    appends more (name, w, h, patch_name) single-patch textures (used by
    the texstress fixture's real-WAD-volume texture pool)."""
    def tex(name, w, h, patch):
        return (name, w, h, patch_names.index(patch))

    return _texture_lump([
        tex(b"WALL1\0\0\0", 64, 128, b"PWALL1\0\0"),
        tex(b"WALL2\0\0\0", 64, 128, b"PWALL2\0\0"),
        tex(b"DOOR1\0\0\0", 64, 128, b"PDOOR1\0\0"),
        tex(b"SW1S\0\0\0\0", 64, 128, b"PSW1S\0\0\0"),
        tex(b"GRATE1\0\0", 64, 128, b"PGRATE1\0"),
        tex(b"SKY1\0\0\0\0", 256, 128, b"PSKY1\0\0\0"),
    ] + [tex(*e) for e in (extra or [])])


def make_texture2(patch_names: list[bytes]) -> bytes:
    """TEXTURE2 lump (the Doom2-format secondary texture table,
    ref wad/src/tex.rs TEXTURE1/2 handling): extra textures the MAP01
    fixture uses, proving TEXTURE2 resolution end to end."""
    def tex(name, w, h, patch):
        return (name, w, h, patch_names.index(patch))

    return _texture_lump([
        tex(b"BRICK2\0\0", 64, 128, b"PWALL2\0\0"),
        tex(b"EXITSW\0\0", 64, 128, b"PSW1S\0\0\0"),
    ])


def make_flats() -> dict[bytes, bytes]:
    def flat(fn):
        yy, xx = np.mgrid[0:64, 0:64]
        return fn(yy, xx).astype(np.uint8).tobytes()

    return {
        b"FLOOR1\0\0": flat(lambda y, x: 120 + ((y // 8 + x // 8) % 2) * 40),
        b"CEIL1\0\0\0": flat(lambda y, x: 70 + ((x // 16) % 2) * 20),
        b"NUKAGE1\0": flat(lambda y, x: 200 + (x % 8)),
        b"NUKAGE2\0": flat(lambda y, x: 210 + (y % 8)),
        b"NUKAGE3\0": flat(lambda y, x: 220 + ((x + y) % 8)),
        b"F_SKY1\0\0": flat(lambda y, x: 0 * x),
        b"STEP1\0\0\0": flat(lambda y, x: 160 + (y % 4) * 8),
    }


def make_sprites() -> dict[bytes, bytes]:
    # Barrel: 24x32 with transparent margins.
    idx = np.zeros((32, 24), dtype=np.uint8)
    mask = np.zeros((32, 24), dtype=bool)
    yy, xx = np.mgrid[0:32, 0:24]
    body = (np.abs(xx - 11.5) < (8 + 2 * np.sin(yy / 5.0))) & (yy > 2)
    idx[body] = (90 + (yy[body] % 16) * 4).astype(np.uint8)
    mask |= body
    barrel = encode_picture(idx, mask, x_offset=12, y_offset=32)
    # Candle: 8x16.
    cidx = np.zeros((16, 8), dtype=np.uint8)
    cmask = np.zeros((16, 8), dtype=bool)
    cmask[4:, 2:6] = True
    cidx[4:, 2:6] = 230
    cmask[2:4, 3:5] = True
    cidx[2:4, 3:5] = 254
    candle = encode_picture(cidx, cmask, x_offset=4, y_offset=16)
    # Hanging victim (thing type 63, sprite GOR1, hanging=true in
    # doom.toml): a dangling shape with a thin rope at the top.
    gidx = np.zeros((48, 16), dtype=np.uint8)
    gmask = np.zeros((48, 16), dtype=bool)
    gmask[0:12, 7:9] = True  # rope
    gidx[0:12, 7:9] = 100
    yy, xx = np.mgrid[0:48, 0:16]
    body = (np.abs(xx - 7.5) < 5) & (yy >= 12) & (yy < 44)
    gmask |= body
    gidx[body] = (60 + (yy[body] % 8) * 3).astype(np.uint8)
    gor5 = encode_picture(gidx, gmask, x_offset=8, y_offset=48)
    return {b"BAR1A0\0\0": barrel, b"CANDA0\0\0": candle, b"GOR1A0\0\0": gor5}


# ---------------------------------------------------------------------------
# Map construction: rectangles -> grid -> linedefs/sidedefs/vertices.
# ---------------------------------------------------------------------------

CELL = 32


@dataclass
class SectorDef:
    floor: int
    ceil: int
    light: int
    floor_tex: bytes
    ceil_tex: bytes
    sector_type: int = 0
    tag: int = 0
    rects: list[tuple[int, int, int, int]] = field(default_factory=list)  # x1,y1,x2,y2
    # Default wall texture for edges fronting this sector (one-sided
    # middle / two-sided upper+lower) when no EdgeSpec overrides it;
    # empty = the fixture-wide WALL1/WALL2 defaults. Lets the texstress
    # fixture spread hundreds of distinct textures across the level.
    wall_tex: bytes = b""


@dataclass
class EdgeSpec:
    """Attributes for boundary edges between two sectors (or sector/solid)."""

    front: int  # sector index that must be on the right side
    back: int  # sector index behind (-1 for solid)
    special: int = 0
    tag: int = 0
    upper: bytes = b""
    lower: bytes = b""
    middle: bytes = b""
    flags: int = 0


@dataclass
class ExtraLine:
    """A hand-placed linedef (e.g. a free-standing transparent grate)."""

    v1: tuple[int, int]
    v2: tuple[int, int]
    front: int
    back: int
    middle: bytes = b""
    flags: int = 0
    special: int = 0
    tag: int = 0


@dataclass
class MapSpec:
    sectors: list[SectorDef]
    edges: list[EdgeSpec]
    extra_lines: list[ExtraLine]
    things: list[tuple[int, int, int, int, int]]  # x, y, angle, type, flags

    def grid(self) -> tuple[np.ndarray, int, int]:
        xs = [r[0] for s in self.sectors for r in s.rects] + [
            r[2] for s in self.sectors for r in s.rects
        ]
        ys = [r[1] for s in self.sectors for r in s.rects] + [
            r[3] for s in self.sectors for r in s.rects
        ]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        nx, ny = (x1 - x0) // CELL, (y1 - y0) // CELL
        g = np.full((nx, ny), -1, dtype=np.int32)
        for i, s in enumerate(self.sectors):
            for (rx1, ry1, rx2, ry2) in s.rects:
                g[
                    (rx1 - x0) // CELL : (rx2 - x0) // CELL,
                    (ry1 - y0) // CELL : (ry2 - y0) // CELL,
                ] = i
        return g, x0, y0


DEFAULT_ONESIDED_MIDDLE = b"WALL1\0\0\0"
DEFAULT_TWOSIDED_UPPER = b"WALL2\0\0\0"
DEFAULT_TWOSIDED_LOWER = b"WALL2\0\0\0"
NO_TEX = b"-\0\0\0\0\0\0\0"


def build_map_lumps(spec: MapSpec) -> dict[bytes, bytes]:
    grid, x0, y0 = spec.grid()
    nx, ny = grid.shape

    edge_spec: dict[frozenset, EdgeSpec] = {}
    for e in spec.edges:
        edge_spec[frozenset((e.front, e.back))] = e

    vertices: dict[tuple[int, int], int] = {}
    vert_list: list[tuple[int, int]] = []

    def vid(p):
        if p not in vertices:
            vertices[p] = len(vert_list)
            vert_list.append(p)
        return vertices[p]

    linedefs = []  # (v1, v2, flags, special, tag, right_side, left_side)
    sidedefs = []  # (x_off, y_off, upper, lower, middle, sector)

    def add_side(sector, upper=NO_TEX, lower=NO_TEX, middle=NO_TEX):
        sidedefs.append((0, 0, _pad(upper), _pad(lower), _pad(middle), sector))
        return len(sidedefs) - 1

    def wall_of(sector, fallback):
        wt = spec.sectors[sector].wall_tex
        return wt if wt else fallback

    def emit(p1, p2, front, back, es: EdgeSpec | None):
        flags = 0
        special = tag = 0
        if es is not None:
            special, tag, flags = es.special, es.tag, es.flags
        if back == -1:
            mid = (es.middle if es and es.middle
                   else wall_of(front, DEFAULT_ONESIDED_MIDDLE))
            right = add_side(front, middle=mid)
            left = -1
            flags |= T.LINEDEF_IMPASSABLE
        else:
            up_f = es.upper if es and es.upper else wall_of(front, DEFAULT_TWOSIDED_UPPER)
            lo_f = es.lower if es and es.lower else wall_of(front, DEFAULT_TWOSIDED_LOWER)
            up_b = es.upper if es and es.upper else wall_of(back, DEFAULT_TWOSIDED_UPPER)
            lo_b = es.lower if es and es.lower else wall_of(back, DEFAULT_TWOSIDED_LOWER)
            mid = es.middle if es and es.middle else NO_TEX
            right = add_side(front, upper=up_f, lower=lo_f, middle=mid)
            left = add_side(back, upper=up_b, lower=lo_b, middle=mid)
            flags |= T.LINEDEF_TWO_SIDED
        linedefs.append((vid(p1), vid(p2), flags, special, tag, right, left))

    def oriented(a, b, p_lo, p_hi, southward: bool):
        """Emit an edge between cells a (west/south) and b (east/north).

        ``southward``: for vertical edges the default front=a orientation
        points south (hi->lo); for horizontal edges front=a points east
        (lo->hi)."""
        es = edge_spec.get(frozenset((a, b)))
        if b == -1:
            front, back = a, -1
            flip = False
        elif a == -1:
            front, back = b, -1
            flip = True
        else:
            front, back = a, b
            flip = False
            if es is not None and es.front == b:
                front, back = b, a
                flip = True
        if southward:
            p1, p2 = (p_hi, p_lo) if not flip else (p_lo, p_hi)
        else:
            p1, p2 = (p_lo, p_hi) if not flip else (p_hi, p_lo)
        emit(p1, p2, front, back, es)

    # Vertical boundaries (between west cell a and east cell b).
    for i in range(nx + 1):
        j = 0
        while j < ny:
            a = int(grid[i - 1, j]) if i > 0 else -1
            b = int(grid[i, j]) if i < nx else -1
            if a == b:
                j += 1
                continue
            j2 = j
            while j2 < ny:
                a2 = int(grid[i - 1, j2]) if i > 0 else -1
                b2 = int(grid[i, j2]) if i < nx else -1
                if (a2, b2) != (a, b):
                    break
                j2 += 1
            x = x0 + i * CELL
            oriented(a, b, (x, y0 + j * CELL), (x, y0 + j2 * CELL), southward=True)
            j = j2
    # Horizontal boundaries (between south cell a and north cell b).
    for j in range(ny + 1):
        i = 0
        while i < nx:
            a = int(grid[i, j - 1]) if j > 0 else -1
            b = int(grid[i, j]) if j < ny else -1
            if a == b:
                i += 1
                continue
            i2 = i
            while i2 < nx:
                a2 = int(grid[i2, j - 1]) if j > 0 else -1
                b2 = int(grid[i2, j]) if j < ny else -1
                if (a2, b2) != (a, b):
                    break
                i2 += 1
            y = y0 + j * CELL
            oriented(a, b, (x0 + i * CELL, y), (x0 + i2 * CELL, y), southward=False)
            i = i2

    for xl in spec.extra_lines:
        flags = xl.flags
        if xl.back != -1:
            flags |= T.LINEDEF_TWO_SIDED
            right = add_side(xl.front, middle=xl.middle or NO_TEX)
            left = add_side(xl.back, middle=xl.middle or NO_TEX)
        else:
            right = add_side(xl.front, middle=xl.middle or DEFAULT_ONESIDED_MIDDLE)
            left = -1
            flags |= T.LINEDEF_IMPASSABLE
        linedefs.append(
            (vid(xl.v1), vid(xl.v2), flags, xl.special, xl.tag, right, left)
        )

    # --- BSP build ------------------------------------------------------
    segs, ssectors, nodes = _build_bsp(vert_list, vertices, linedefs, sidedefs)

    # --- pack lumps ------------------------------------------------------
    things = np.zeros(len(spec.things), dtype=T.THING_DTYPE)
    for i, (x, y, angle, ttype, flags) in enumerate(spec.things):
        things[i] = (x, y, angle, ttype, flags)

    ld = np.zeros(len(linedefs), dtype=T.LINEDEF_DTYPE)
    for i, (v1, v2, flags, special, tag, right, left) in enumerate(linedefs):
        ld[i] = (v1, v2, flags, special, tag, right, left)

    sd = np.zeros(len(sidedefs), dtype=T.SIDEDEF_DTYPE)
    for i, (xo, yo, up, lo, mid, sec) in enumerate(sidedefs):
        sd[i] = (xo, yo, up, lo, mid, sec)

    vt = np.zeros(len(vert_list), dtype=T.VERTEX_DTYPE)
    for i, (x, y) in enumerate(vert_list):
        vt[i] = (x, y)

    sc = np.zeros(len(spec.sectors), dtype=T.SECTOR_DTYPE)
    for i, s in enumerate(spec.sectors):
        sc[i] = (
            s.floor,
            s.ceil,
            _pad(s.floor_tex),
            _pad(s.ceil_tex),
            s.light,
            s.sector_type,
            s.tag,
        )

    return {
        b"THINGS\0\0": things.tobytes(),
        b"LINEDEFS": ld.tobytes(),
        b"SIDEDEFS": sd.tobytes(),
        b"VERTEXES": vt.tobytes(),
        b"SEGS\0\0\0\0": segs.tobytes(),
        b"SSECTORS": ssectors.tobytes(),
        b"NODES\0\0\0": nodes.tobytes(),
        b"SECTORS\0": sc.tobytes(),
    }


def _pad(name: bytes) -> bytes:
    return name.ljust(8, b"\0")[:8]


# ---------------------------------------------------------------------------
# Axis-aligned BSP builder (vanilla side conventions).
# ---------------------------------------------------------------------------


@dataclass
class _Seg:
    v1: tuple[int, int]
    v2: tuple[int, int]
    linedef: int
    direction: int
    offset: int


def _sd(o, d, p) -> int:
    """Vanilla R_PointOnSide numerator: <0 front (side 0 / right child),
    >0 back (side 1 / left child)."""
    return d[0] * (p[1] - o[1]) - d[1] * (p[0] - o[0])


def _build_bsp(vert_list, vert_ids, linedefs, sidedefs):
    segs0: list[_Seg] = []
    for i, (v1, v2, flags, special, tag, right, left) in enumerate(linedefs):
        p1, p2 = vert_list[v1], vert_list[v2]
        segs0.append(_Seg(p1, p2, i, 0, 0))
        if left != -1:
            segs0.append(_Seg(p2, p1, i, 1, 0))

    all_segs: list[_Seg] = []
    ssectors: list[tuple[int, int]] = []
    nodes: list[list] = []  # [lx, ly, dx, dy, rbbox(4), lbbox(4), right, left]

    def seg_front_sector(seg: _Seg) -> int:
        line = linedefs[seg.linedef]
        side = line[5] if seg.direction == 0 else line[6]
        return sidedefs[side][5]

    def is_convex(segs: list[_Seg]) -> bool:
        for s in segs:
            o, d = s.v1, (s.v2[0] - s.v1[0], s.v2[1] - s.v1[1])
            for t in segs:
                if t is s:
                    continue
                if _sd(o, d, t.v1) > 0 or _sd(o, d, t.v2) > 0:
                    return False
        return True

    def classify(o, d, s: _Seg):
        s1, s2 = _sd(o, d, s.v1), _sd(o, d, s.v2)
        if s1 == 0 and s2 == 0:
            dot = d[0] * (s.v2[0] - s.v1[0]) + d[1] * (s.v2[1] - s.v1[1])
            return "front" if dot > 0 else "back"
        if s1 <= 0 and s2 <= 0:
            return "front"
        if s1 >= 0 and s2 >= 0:
            return "back"
        return "split"

    def split_seg(o, d, s: _Seg) -> tuple[_Seg, _Seg]:
        s1, s2 = _sd(o, d, s.v1), _sd(o, d, s.v2)
        t = s1 / (s1 - s2)
        mx = s.v1[0] + (s.v2[0] - s.v1[0]) * t
        my = s.v1[1] + (s.v2[1] - s.v1[1]) * t
        m = (int(round(mx)), int(round(my)))
        assert abs(mx - m[0]) < 1e-6 and abs(my - m[1]) < 1e-6, "non-integer split"
        dist = int(
            round(math.hypot(m[0] - s.v1[0], m[1] - s.v1[1]))
        )
        first = _Seg(s.v1, m, s.linedef, s.direction, s.offset)
        second = _Seg(m, s.v2, s.linedef, s.direction, s.offset + dist)
        if s1 < 0 or (s1 == 0 and s2 < 0):
            return first, second  # (front, back)
        return second, first

    def pick_partition(segs: list[_Seg]):
        best = None
        best_score = None
        seen = set()
        for s in segs:
            o = s.v1
            d = (s.v2[0] - s.v1[0], s.v2[1] - s.v1[1])
            axis = 0 if d[1] == 0 else (1 if d[0] == 0 else 2)
            key = (axis, o[1] if axis == 0 else o[0]) if axis != 2 else (2, o, d)
            if key in seen:
                continue
            seen.add(key)
            nf = nb = nsplit = 0
            for t in segs:
                c = classify(o, d, t)
                if c == "front":
                    nf += 1
                elif c == "back":
                    nb += 1
                else:
                    nsplit += 1
            if nb == 0 and nsplit == 0:
                continue
            score = abs(nf - nb) + 8 * nsplit
            if best_score is None or score < best_score:
                best_score = score
                best = (o, d)
        return best

    def bbox(segs: list[_Seg]):
        xs = [p[0] for s in segs for p in (s.v1, s.v2)]
        ys = [p[1] for s in segs for p in (s.v1, s.v2)]
        return (max(ys), min(ys), max(xs), min(xs))  # y_max, y_min, x_max, x_min

    def make_leaf(segs: list[_Seg]) -> int:
        sectors = {seg_front_sector(s) for s in segs}
        assert len(sectors) == 1, f"leaf with mixed sectors: {sectors}"
        first = len(all_segs)
        all_segs.extend(segs)
        ssectors.append((len(segs), first))
        return 0x8000 | (len(ssectors) - 1)

    def build(segs: list[_Seg]) -> int:
        assert segs, "empty BSP region"
        if is_convex(segs):
            return make_leaf(segs)
        part = pick_partition(segs)
        assert part is not None, "no valid partition for non-convex region"
        o, d = part
        front: list[_Seg] = []
        back: list[_Seg] = []
        for s in segs:
            c = classify(o, d, s)
            if c == "front":
                front.append(s)
            elif c == "back":
                back.append(s)
            else:
                f, b = split_seg(o, d, s)
                front.append(f)
                back.append(b)
        assert front and back, "degenerate partition"
        rbb = bbox(front)
        lbb = bbox(back)
        right = build(front)
        left = build(back)
        nodes.append([o[0], o[1], d[0], d[1], *rbb, *lbb, right, left])
        return len(nodes) - 1

    build(segs0)

    # Pack segs (need vertex ids; splits may have created new vertices).
    def vid(p):
        if p not in vert_ids:
            vert_ids[p] = len(vert_list)
            vert_list.append(p)
        return vert_ids[p]

    seg_arr = np.zeros(len(all_segs), dtype=T.SEG_DTYPE)
    for i, s in enumerate(all_segs):
        dx, dy = s.v2[0] - s.v1[0], s.v2[1] - s.v1[1]
        angle = int(round(math.atan2(dy, dx) / (2 * math.pi) * 65536)) & 0xFFFF
        seg_arr[i] = (vid(s.v1), vid(s.v2), angle, s.linedef, s.direction, s.offset)

    ss_arr = np.zeros(len(ssectors), dtype=T.SUBSECTOR_DTYPE)
    for i, (n, first) in enumerate(ssectors):
        ss_arr[i] = (n, first)

    node_arr = np.zeros(len(nodes), dtype=T.NODE_DTYPE)
    for i, n in enumerate(nodes):
        node_arr[i] = tuple(n)

    return seg_arr, ss_arr, node_arr


# ---------------------------------------------------------------------------
# The standard test level.
# ---------------------------------------------------------------------------


def test_map_spec() -> MapSpec:
    F1, C1 = b"FLOOR1\0\0", b"CEIL1\0\0\0"
    SKY = b"F_SKY1\0\0"
    NUK = b"NUKAGE1\0"
    sectors = [
        # 0: start room
        SectorDef(0, 128, 160, F1, C1, rects=[(0, 0, 512, 512)]),
        # 1: glow alcove (north of start room)
        SectorDef(0, 128, 224, F1, C1, sector_type=8, rects=[(192, 512, 320, 576)]),
        # 2: corridor west
        SectorDef(0, 96, 144, F1, C1, rects=[(512, 192, 608, 320)]),
        # 3: door (closed: ceiling == floor)
        SectorDef(0, 0, 144, F1, C1, rects=[(608, 192, 672, 320)]),
        # 4: corridor east
        SectorDef(0, 96, 144, F1, C1, rects=[(672, 192, 768, 320)]),
        # 5: big room with sky ceiling
        SectorDef(-32, 192, 144, F1, SKY, rects=[(768, 64, 1280, 448)]),
        # 6: nukage pool (animated flat)
        SectorDef(-48, 192, 144, NUK, SKY, rects=[(832, 128, 960, 256)]),
        # 7: flicker zone
        SectorDef(-32, 192, 192, F1, SKY, sector_type=17, rects=[(1024, 320, 1152, 448)]),
        # 8: lift (tag 5)
        SectorDef(32, 192, 160, b"STEP1\0\0\0", C1, tag=5, rects=[(1280, 192, 1376, 320)]),
        # 9: ledge room with exit switch
        SectorDef(32, 192, 160, F1, C1, rects=[(1376, 192, 1504, 320)]),
    ]
    D1 = b"DOOR1\0\0\0"
    edges = [
        # Push door (special 1, tag 0): left sidedef must be the door sector,
        # so the *front* must be the corridor.
        EdgeSpec(front=2, back=3, special=1, upper=D1),
        EdgeSpec(front=4, back=3, special=1, upper=D1),
        # Lift walkover (special 88 -> tag 5) on the big-room/lift boundary.
        EdgeSpec(front=5, back=8, special=88, tag=5),
        # Door tracks: lower-unpegged so they stay attached to the static
        # floor object instead of riding the door ceiling (vanilla idiom;
        # ref wad/src/visitor.rs:735-752 one-sided object_id selection).
        EdgeSpec(front=3, back=-1, flags=T.LINEDEF_LOWER_UNPEGGED),
    ]
    extra = [
        # Free-standing transparent grate inside the big room.
        ExtraLine(
            v1=(1000, 448),
            v2=(1000, 256),
            front=5,
            back=5,
            middle=b"GRATE1\0\0",
            flags=T.LINEDEF_IMPASSABLE,
        ),
    ]
    things = [
        (256, 256, 0, 1, 7),  # player 1 start, facing east
        (1100, 380, 0, 2035, 7),  # barrel
        (400, 400, 0, 34, 7),  # candle
    ]
    spec = MapSpec(sectors, edges, extra, things)
    # Scrolling wall (special 48) + exit switch (special 11) are single
    # linedefs, not whole-pair specs; patch them in afterwards below.
    return spec


def test_map_spec_2() -> MapSpec:
    """E1M2: staircase (neighbour-height climbing), slow-strobe sector,
    gun-activated door (G1 special 46), S1 exit."""
    F1, C1, ST = b"FLOOR1\0\0", b"CEIL1\0\0\0", b"STEP1\0\0\0"
    sectors = [
        # 0: start room
        SectorDef(0, 160, 176, F1, C1, rects=[(0, 0, 448, 448)]),
        # 1-3: stairs up (the last one darker so the strobe room has a
        # lower-light neighbour to alternate against)
        SectorDef(16, 160, 160, ST, C1, rects=[(448, 128, 512, 320)]),
        SectorDef(32, 160, 160, ST, C1, rects=[(512, 128, 576, 320)]),
        SectorDef(48, 160, 112, ST, C1, rects=[(576, 128, 640, 320)]),
        # 4: upper room, slow strobe (sector type 3)
        SectorDef(48, 224, 144, F1, C1, sector_type=3, rects=[(640, 64, 1088, 448)]),
        # 5: gun door (closed; G1 special 46 opens it, stays open)
        SectorDef(48, 48, 144, F1, C1, rects=[(1088, 192, 1120, 320)]),
        # 6: exit alcove
        SectorDef(48, 224, 192, F1, C1, rects=[(1120, 192, 1248, 320)]),
    ]
    D1 = b"DOOR1\0\0\0"
    edges = [
        # Gun door: left sidedef must be the door sector (manual, tag 0).
        EdgeSpec(front=4, back=5, special=46, upper=D1),
        EdgeSpec(front=6, back=5, special=46, upper=D1),
        EdgeSpec(front=5, back=-1, flags=T.LINEDEF_LOWER_UNPEGGED),
    ]
    things = [
        (224, 224, 0, 1, 7),  # player 1 start
        (800, 380, 0, 2035, 7),  # barrel
        (900, 120, 0, 2035, 7),  # barrel
        (300, 100, 0, 34, 7),  # candle
    ]
    return MapSpec(sectors, edges, [], things)


def doom2_map_spec() -> MapSpec:
    """MAP01: the Doom2-format fixture. A central hall ringed by pocket
    sectors, each driven by a distinct linedef special, exercising every
    HeightRef branch of the LevelAnalysis (LowestFloor, NextFloor,
    HighestFloor, LowestCeiling, HighestCeiling, Floor, absolute offsets),
    plus a hanging decor thing, TEXTURE2 wall textures, and (via the
    patcher) normal + secret exits and a scroll wall.

    Pocket layout (sector index: special / tag):
      north wall  1:1  2:117  3:118  4:2/14  5:3/15  6:103/16
                  7:40/17(+8 back cell)  9:43/19  10:70/20
      east wall   11:10/21  12:62/22  13:123/23  14:18/24(+15 back)
                  16:23/25  17:36/26(+18 back)  19:38/27  20:58/28
    """
    F1, C1, ST = b"FLOOR1\0\0", b"CEIL1\0\0\0", b"STEP1\0\0\0"
    B2 = b"BRICK2\0\0"  # defined in TEXTURE2
    D1 = b"DOOR1\0\0\0"

    def north(i, *a, **kw):  # pocket i on the north wall, 64 wide, 64-gap
        return SectorDef(*a, **kw, rects=[(128 * i, 1024, 128 * i + 64, 1088)])

    def east(j, *a, **kw):  # pocket j on the east wall
        return SectorDef(*a, **kw, rects=[(1280, 128 * j, 1344, 128 * j + 64)])

    sectors = [
        # 0: hall
        SectorDef(0, 128, 160, F1, C1, rects=[(0, 0, 1280, 1024)]),
        # North pockets (separated by solid gaps so each one's only
        # neighbours are the hall and its own back cell).
        north(0, 0, 0, 144, F1, C1),             # 1: push door (1)
        north(1, 0, 0, 144, F1, C1),             # 2: blaze door repeat (117)
        north(2, 0, 0, 144, F1, C1),             # 3: blaze door once (118)
        north(3, 0, 0, 144, F1, C1, tag=14),     # 4: W1 open (2)
        north(4, 0, 128, 144, F1, C1, tag=15),   # 5: W1 close (3)
        north(5, 0, 0, 144, F1, C1, tag=16),     # 6: S1 open (103)
        north(6, 0, 128, 144, F1, C1, tag=17),   # 7: W1 ceil->highest (40)
        SectorDef(0, 192, 144, F1, C1, rects=[(768, 1088, 832, 1152)]),  # 8 back
        north(7, 0, 128, 144, F1, C1, tag=19),   # 9: SR ceil->floor (43)
        north(8, 32, 128, 144, ST, C1, tag=20),  # 10: SR floor->HF+8 (70)
        # East pockets.
        east(0, 64, 128, 144, ST, C1, tag=21),   # 11: W1 lift (10)
        east(1, 64, 128, 144, ST, C1, tag=22),   # 12: SR lift (62)
        east(2, 64, 128, 144, ST, C1, tag=23),   # 13: SR blaze lift (123)
        east(3, 0, 128, 144, F1, C1, tag=24),    # 14: S1 floor->next (18)
        SectorDef(48, 128, 144, ST, C1, rects=[(1344, 384, 1408, 448)]),  # 15 back
        east(4, 32, 128, 144, ST, C1, tag=25),   # 16: S1 floor->lowest (23)
        east(5, 96, 160, 144, ST, C1, tag=26),   # 17: W1 floor->HF+8 fast (36)
        SectorDef(64, 160, 144, ST, C1, rects=[(1344, 640, 1408, 704)]),  # 18 back
        east(6, 32, 128, 144, ST, C1, tag=27),   # 19: W1 floor->lowest (38)
        east(7, 0, 128, 144, F1, C1, tag=28),    # 20: W1 floor+24 (58)
    ]
    edges = [
        # Manual doors (tag 0; the dynamic sector is behind the LEFT side).
        EdgeSpec(front=0, back=1, special=1, upper=D1),
        EdgeSpec(front=0, back=2, special=117, upper=D1),
        EdgeSpec(front=0, back=3, special=118, upper=D1),
        # Tagged switch specials on the pocket boundary (TEXTURE2 uppers).
        EdgeSpec(front=0, back=6, special=103, tag=16, upper=B2),
        EdgeSpec(front=0, back=9, special=43, tag=19, upper=B2),
        EdgeSpec(front=0, back=10, special=70, tag=20),
        EdgeSpec(front=0, back=12, special=62, tag=22),
        EdgeSpec(front=0, back=13, special=123, tag=23),
        EdgeSpec(front=0, back=14, special=18, tag=24),
        EdgeSpec(front=0, back=16, special=23, tag=25),
        # W1 pockets' boundary edges carry no special (triggers are the
        # free-standing walkover lines below).
        EdgeSpec(front=0, back=4, upper=D1),
        EdgeSpec(front=0, back=5, upper=B2),
    ]
    extra = [
        # Walkover trigger lines inside the hall (two-sided, untextured).
        ExtraLine(v1=(384, 992), v2=(448, 992), front=0, back=0, special=2, tag=14),
        ExtraLine(v1=(512, 984), v2=(576, 984), front=0, back=0, special=3, tag=15),
        ExtraLine(v1=(768, 992), v2=(832, 992), front=0, back=0, special=40, tag=17),
        ExtraLine(v1=(1216, 8), v2=(1216, 56), front=0, back=0, special=10, tag=21),
        ExtraLine(v1=(1216, 648), v2=(1216, 696), front=0, back=0, special=36, tag=26),
        ExtraLine(v1=(1216, 776), v2=(1216, 824), front=0, back=0, special=38, tag=27),
        ExtraLine(v1=(1216, 904), v2=(1216, 952), front=0, back=0, special=58, tag=28),
        # Secret exit switch (S1 51) on a free-standing pillar line by the
        # west wall (the wall itself is the normal exit via the patcher).
        # v1->v2 chosen so the FRONT (right) side faces +x into the hall.
        ExtraLine(v1=(8, 128), v2=(8, 64), front=0, back=0, special=51),
    ]
    things = [
        (64, 64, 0, 1, 7),  # player 1 start
        (400, 256, 0, 63, 7),  # hanging victim (GOR5, hanging=true)
        (200, 200, 0, 2035, 7),  # barrel
        (600, 100, 0, 34, 7),  # candle
    ]
    return MapSpec(sectors, edges, extra, things)


def _apply_single_line_specials_map01(lumps: dict[bytes, bytes]) -> dict[bytes, bytes]:
    """MAP01's single-line specials: the west wall (x = 0) is the normal
    exit switch (11); the south wall (y = 0) scrolls (48). The secret
    exit is an ExtraLine in doom2_map_spec."""
    ld = np.frombuffer(lumps[b"LINEDEFS"], dtype=T.LINEDEF_DTYPE).copy()
    vt = np.frombuffer(lumps[b"VERTEXES"], dtype=T.VERTEX_DTYPE)
    sd = np.frombuffer(lumps[b"SIDEDEFS"], dtype=T.SIDEDEF_DTYPE).copy()
    for i in range(len(ld)):
        v1, v2 = ld[i]["start_vertex"], ld[i]["end_vertex"]
        if vt[v1]["x"] == 0 and vt[v2]["x"] == 0:
            ld[i]["special_type"] = 11
            sd[ld[i]["right_side"]]["middle_texture"] = b"SW1S\0\0\0\0"
        elif (
            vt[v1]["y"] == 0 and vt[v2]["y"] == 0
            and ld[i]["special_type"] == 0
        ):
            ld[i]["special_type"] = 48
    lumps = dict(lumps)
    lumps[b"LINEDEFS"] = ld.tobytes()
    lumps[b"SIDEDEFS"] = sd.tobytes()
    return lumps


def stress_map_spec(
    seed: int = 0,
    cells: int = 12,
    wall_texs: list[bytes] | None = None,
    flat_texs: list[bytes] | None = None,
) -> MapSpec:
    """A procedurally generated many-sector level approximating real-WAD
    scale (hundreds of linedefs): a cells x cells grid of rooms with
    random floor/ceiling heights, lights, light effects, and randomly
    removed walls. Used by benchmarks and scale tests.

    ``wall_texs`` / ``flat_texs`` (texstress): per-sector random draws
    from texture pools, so the level references the whole pool and the
    compact texel table reaches real-WAD volume."""
    rng = np.random.default_rng(seed)
    room = 128  # wad units per room
    sectors: list[SectorDef] = []
    F1, C1 = b"FLOOR1\0\0", b"CEIL1\0\0\0"
    grid_ids = np.full((cells, cells), -1, dtype=np.int32)
    # Random rectangular rooms: carve the grid into rects of 1x1..2x2 rooms.
    for cy in range(cells):
        for cx in range(cells):
            if grid_ids[cx, cy] != -1:
                continue
            w = int(rng.integers(1, 3))
            h = int(rng.integers(1, 3))
            w = min(w, cells - cx)
            h = min(h, cells - cy)
            floor = int(rng.integers(-4, 5)) * 8
            ceil = floor + 96 + int(rng.integers(0, 5)) * 16
            light = int(rng.integers(8, 28)) * 8
            stype = int(rng.choice([0, 0, 0, 0, 0, 1, 2, 3, 8, 17]))
            idx = len(sectors)
            # Cycle (not random-draw) so a pool sized <= #sectors is
            # fully referenced and the texel table hits its design size.
            ftex = flat_texs[idx % len(flat_texs)] if flat_texs else F1
            wtex = wall_texs[idx % len(wall_texs)] if wall_texs else b""
            sectors.append(
                SectorDef(
                    floor, ceil, light, ftex, C1, sector_type=stype,
                    wall_tex=wtex,
                    rects=[(cx * room, cy * room, (cx + w) * room, (cy + h) * room)],
                )
            )
            grid_ids[cx : cx + w, cy : cy + h] = idx
    things = [(64, 64, 0, 1, 7)]
    # Sprinkle decor.
    for _ in range(10):
        tx = int(rng.integers(1, cells)) * room - 64
        ty = int(rng.integers(1, cells)) * room - 64
        things.append((tx, ty, 0, int(rng.choice([2035, 34])), 7))
    return MapSpec(sectors, [], [], things)


def _apply_single_line_specials_2(lumps: dict[bytes, bytes]) -> dict[bytes, bytes]:
    """E1M2's single-line specials: the exit switch on the alcove's east
    wall (x = 1248)."""
    ld = np.frombuffer(lumps[b"LINEDEFS"], dtype=T.LINEDEF_DTYPE).copy()
    vt = np.frombuffer(lumps[b"VERTEXES"], dtype=T.VERTEX_DTYPE)
    sd = np.frombuffer(lumps[b"SIDEDEFS"], dtype=T.SIDEDEF_DTYPE).copy()
    for i in range(len(ld)):
        x1 = vt[ld[i]["start_vertex"]]["x"]
        x2 = vt[ld[i]["end_vertex"]]["x"]
        if x1 == 1248 and x2 == 1248:
            ld[i]["special_type"] = 11
            sd[ld[i]["right_side"]]["middle_texture"] = b"SW1S\0\0\0\0"
    lumps = dict(lumps)
    lumps[b"LINEDEFS"] = ld.tobytes()
    lumps[b"SIDEDEFS"] = sd.tobytes()
    return lumps


def _apply_single_line_specials(lumps: dict[bytes, bytes]) -> dict[bytes, bytes]:
    ld = np.frombuffer(lumps[b"LINEDEFS"], dtype=T.LINEDEF_DTYPE).copy()
    vt = np.frombuffer(lumps[b"VERTEXES"], dtype=T.VERTEX_DTYPE)
    sd = np.frombuffer(lumps[b"SIDEDEFS"], dtype=T.SIDEDEF_DTYPE).copy()
    for i in range(len(ld)):
        x1, y1 = vt[ld[i]["start_vertex"]]["x"], vt[ld[i]["start_vertex"]]["y"]
        x2, y2 = vt[ld[i]["end_vertex"]]["x"], vt[ld[i]["end_vertex"]]["y"]
        # West wall of the start room scrolls (special 48 = 0x30).
        if x1 == 0 and x2 == 0 and ld[i]["special_type"] == 0:
            ld[i]["special_type"] = 48
        # East wall of the ledge room is the exit switch (special 11).
        if x1 == 1504 and x2 == 1504:
            ld[i]["special_type"] = 11
            sd[ld[i]["right_side"]]["middle_texture"] = b"SW1S\0\0\0\0"
    lumps = dict(lumps)
    lumps[b"LINEDEFS"] = ld.tobytes()
    lumps[b"SIDEDEFS"] = sd.tobytes()
    return lumps


# ---------------------------------------------------------------------------
# WAD assembly.
# ---------------------------------------------------------------------------


def build_wad(lump_list: list[tuple[bytes, bytes]]) -> bytes:
    """Assemble an IWAD from (name, data) pairs."""
    header_size = 12
    pos = header_size
    directory = b""
    body = b""
    for name, data in lump_list:
        directory += struct.pack("<ii8s", pos, len(data), _pad(name))
        body += data
        pos += len(data)
    header = struct.pack("<4sii", b"IWAD", len(lump_list), pos)
    return header + body + directory


def build_doom2_wad() -> bytes:
    """The Doom2-format fixture IWAD: MAPxx level names (exercising the
    Doom2 sky regex in doom.toml), TEXTURE2, a secret exit, hanging decor
    and 18 distinct linedef specials (doom2_map_spec)."""
    return build_test_wad([
        (b"MAP01\0\0\0", doom2_map_spec()),
        (b"MAP02\0\0\0", test_map_spec_2()),
    ])


def build_stress_wad(seed: int = 0, cells: int = 20, n_textures: int = 0,
                     n_flats: int = 0) -> bytes:
    """The stress / texstress fixture IWAD: a procedurally generated
    ``cells x cells`` maze (E1M1), optionally texture-stressed with
    ``n_textures`` distinct 64x128 wall textures and ``n_flats`` distinct
    flats cycled across its sectors. With a few hundred textures the
    compact texel table reaches the multi-megatexel volume of a real
    IWAD's atlases (ref wad/src/tex.rs:168-271), forcing the renderer's
    per-env active-cell path instead of the small-table global path."""
    if n_flats == 0 and n_textures:
        n_flats = max(8, n_textures // 8)
    wall_texs = [b"STR%04d\0" % i for i in range(n_textures)]
    flat_texs = [_pad(b"FSTR%03d" % i) for i in range(n_flats)]
    return build_test_wad(
        [(b"E1M1\0\0\0\0",
          stress_map_spec(seed, cells, wall_texs or None, flat_texs or None))],
        extra_patches=make_stress_patches(n_textures) if n_textures else None,
        extra_textures=[
            (wall_texs[i], 64, 128, b"PSTR%04d" % i) for i in range(n_textures)
        ],
        extra_flats=make_stress_flats(n_flats) if n_flats else None,
    )


_LINE_PATCHERS = {
    b"E1M2": _apply_single_line_specials_2,
    b"MAP01": _apply_single_line_specials_map01,
    b"MAP02": lambda lumps: lumps,
}


def build_test_wad(
    map_specs: list[tuple[bytes, MapSpec]] | None = None,
    extra_patches: dict[bytes, bytes] | None = None,
    extra_textures: list[tuple[bytes, int, int, bytes]] | None = None,
    extra_flats: dict[bytes, bytes] | None = None,
) -> bytes:
    """Build the synthetic IWAD used by tests and benchmarks (two levels)."""
    if map_specs is None:
        map_specs = [
            (b"E1M1\0\0\0\0", test_map_spec()),
            (b"E1M2\0\0\0\0", test_map_spec_2()),
        ]
    patches = make_patches()
    patches.update(extra_patches or {})
    flats = make_flats()
    flats.update(extra_flats or {})
    sprites = make_sprites()
    lumps: list[tuple[bytes, bytes]] = [
        (b"PLAYPAL\0", make_playpal()),
        (b"COLORMAP", make_colormap()),
        (b"PNAMES\0\0", struct.pack("<I", len(patches)) + b"".join(patches)),
        (b"TEXTURE1", make_texture1(list(patches), extra_textures)),
        (b"TEXTURE2", make_texture2(list(patches))),
    ]
    lumps += [(name, data) for name, data in patches.items()]
    lumps.append((b"F_START\0", b""))
    lumps += [(name, data) for name, data in flats.items()]
    lumps.append((b"F_END\0\0\0", b""))
    lumps.append((b"S_START\0", b""))
    lumps += [(name, data) for name, data in sprites.items()]
    lumps.append((b"S_END\0\0\0", b""))
    for level_name, spec in map_specs:
        patcher = _apply_single_line_specials
        for prefix, fn in _LINE_PATCHERS.items():
            if level_name.startswith(prefix):
                patcher = fn
                break
        map_lumps = patcher(build_map_lumps(spec))
        lumps.append((level_name, b""))
        for lname in (
            b"THINGS\0\0",
            b"LINEDEFS",
            b"SIDEDEFS",
            b"VERTEXES",
            b"SEGS\0\0\0\0",
            b"SSECTORS",
            b"NODES\0\0\0",
            b"SECTORS\0",
        ):
            lumps.append((lname, map_lumps[lname]))
    return build_wad(lumps)
