"""Texture directory: palettes, colormaps, patches, composite textures,
flats, sprites, and the two atlas packers.

Reference behavior: rust-doom's wad/src/tex.rs. The atlas packing
algorithms are reproduced faithfully (row packing with pow2 growth and
transpose retry; 64x64 grid for flats; animation frames placed contiguously)
because the renderer's animation-frame-select formula depends on the layout
(assets/shaders/static.vert:30-39).

Soft resilience matches the reference: corrupt patches/textures/sprites are
logged and skipped (tex.rs:376-394, 489-492, 534-543).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from . import types as T
from .archive import Archive, CorruptWad
from .image import CorruptImage, Image
from .meta import WadMetadata
from .name import wad_name

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Bounds:
    """Atlas placement of one texture (ref tex.rs:16-23)."""

    pos: tuple[float, float]
    size: tuple[float, float]
    num_frames: int
    row_height: int


class TextureDirectory:
    """All graphic assets of a WAD, decoded to NumPy."""

    def __init__(self, wad: Archive, meta: WadMetadata):
        # Palettes: (N, 256, 3) u8; colormaps: (M, 256) u8 (tex.rs:57-58).
        playpal = wad.required_lump_bytes(b"PLAYPAL")
        if len(playpal) == 0 or len(playpal) % T.PALETTE_SIZE != 0:
            raise CorruptWad("bad PLAYPAL size")
        self.palettes = np.frombuffer(playpal, dtype=np.uint8).reshape(-1, 256, 3)
        colormap = wad.required_lump_bytes(b"COLORMAP")
        if len(colormap) == 0 or len(colormap) % T.COLORMAP_SIZE != 0:
            raise CorruptWad("bad COLORMAP size")
        self.colormaps = np.frombuffer(colormap, dtype=np.uint8).reshape(-1, 256)

        self.patches = _read_patches(wad)
        self.textures: dict[bytes, Image] = {}
        for lump_name in (b"TEXTURE1", b"TEXTURE2"):
            buf = wad.named_lump_bytes(lump_name)
            if buf is not None:
                _read_textures(buf, self.patches, self.textures)
        self.flats = _read_flats(wad)
        _read_sprites(wad, self.textures)

        self.animated_walls = meta.animated_walls
        self.animated_flats = meta.animated_flats

    def texture(self, name: bytes) -> Image | None:
        return self.textures.get(name)

    def flat(self, name: bytes) -> np.ndarray | None:
        return self.flats.get(name)

    # -- palette LUT -----------------------------------------------------

    def build_palette_texture(
        self, palette: int = 0, colormap_start: int = 0, colormap_end: int = 32
    ) -> np.ndarray:
        """(num_colormaps, 256, 3) u8 RGB LUT: row c, column i =
        palette[colormap[c][i]] (ref tex.rs:137-166)."""
        pal = self.palettes[palette]
        maps = self.colormaps[colormap_start:colormap_end]
        return pal[maps]  # fancy-gather: (C, 256, 3)

    # -- atlases -----------------------------------------------------------

    def build_texture_atlas(self, names) -> tuple[Image, dict[bytes, Bounds]]:
        """Row-packing atlas with pow2 growth + transpose retry
        (ref tex.rs:168-271). ``names`` is an iterable of wall/sprite
        texture names; animation frames are pulled in and placed
        contiguously."""
        entries = _ordered_atlas_entries(self.animated_walls, self.texture, names)
        if not entries:
            return Image(np.zeros((0, 0), dtype=np.uint16)), {}
        max_image_width = max(e.image.width for e in entries)
        num_pixels = sum(e.image.width * e.image.height for e in entries)
        max_size = 4096

        size = [min(128, _next_pow2(max_image_width)), 128]

        def next_size(size):
            while True:
                if size[0] <= size[1]:
                    if size[0] == max_size:
                        raise CorruptWad("could not fit wall atlas")
                    size[0] *= 2
                    size[1] = 128
                else:
                    size[1] *= 2
                if size[0] * size[1] >= num_pixels:
                    return

        next_size(size)
        transposed = False
        while True:
            positions = []
            offset = [0, 0]
            row_height = 0
            failed = False
            for e in entries:
                w, h = e.image.width, e.image.height
                if offset[0] + w > size[0]:
                    offset[0] = 0
                    offset[1] += row_height
                    row_height = 0
                if h > row_height:
                    row_height = h
                if offset[1] + h > size[1]:
                    failed = True
                    break
                positions.append(((offset[0], offset[1]), row_height))
                offset[0] += w
            if failed:
                size = [size[1], size[0]]
                transposed = not transposed
                if transposed and size[0] != size[1]:
                    continue
                transposed = False
                next_size(size)
            else:
                break

        atlas = Image.blank(size[0], size[1])
        bounds: dict[bytes, Bounds] = {}
        for i, e in enumerate(entries):
            atlas.blit(e.image, positions[i][0], ignore_transparency=True)
            # Bounds point at the first frame of the animation (tex.rs:256-261).
            pos, row_h = positions[i - e.frame_offset]
            bounds[e.name] = Bounds(
                pos=(float(pos[0]), float(pos[1])),
                size=(float(e.image.width), float(e.image.height)),
                num_frames=e.num_frames,
                row_height=row_h,
            )
        log.info("texture atlas size: %dx%d", size[0], size[1])
        return atlas, bounds

    def build_flat_atlas(self, names) -> tuple[np.ndarray, dict[bytes, Bounds]]:
        """64x64-grid flat atlas (ref tex.rs:273-333). Returns
        ((H, W) u8 array, bounds)."""
        entries = _ordered_atlas_entries(self.animated_flats, self.flat, names)
        num_names = len(entries)
        width = _next_pow2(int(np.ceil(np.sqrt(max(num_names, 1)))) * 64)
        flats_per_row = width // 64
        num_rows = int(np.ceil(num_names / flats_per_row)) if num_names else 0
        height = _next_pow2(max(num_rows, 1) * 64)

        data = np.full((height, width), 255, dtype=np.uint8)
        bounds: dict[bytes, Bounds] = {}
        row = column = 0
        anim_start = (0.0, 0.0)
        for e in entries:
            ox, oy = column * 64, row * 64
            if e.frame_offset == 0:
                anim_start = (float(ox), float(oy))
            bounds[e.name] = Bounds(
                pos=anim_start, size=(64.0, 64.0), num_frames=e.num_frames,
                row_height=64,
            )
            flat = np.asarray(e.image, dtype=np.uint8)
            npix = min(flat.size, 64 * 64)
            tile = np.zeros(64 * 64, dtype=np.uint8)
            tile[:npix] = flat.ravel()[:npix]
            data[oy : oy + 64, ox : ox + 64] = tile.reshape(64, 64)
            column += 1
            if column == flats_per_row:
                column = 0
                row += 1
        log.info("flat atlas size: %dx%d", width, height)
        return data, bounds


@dataclass
class _AtlasEntry:
    name: bytes
    image: object
    frame_offset: int
    num_frames: int


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _search_for_frames(name: bytes, animations) -> list[bytes] | None:
    for frames in animations:
        if name in frames:
            return frames
    return None


def _ordered_atlas_entries(animations, lookup, names) -> list[_AtlasEntry]:
    """Dedup by animation-first-frame, expanding animations so frames are
    contiguous in the atlas (ref tex.rs:421-466)."""
    by_first: dict[bytes, list[bytes] | None] = {}
    for name in names:
        frames = _search_for_frames(name, animations)
        first = frames[0] if frames else name
        by_first[first] = frames
    entries: list[_AtlasEntry] = []
    for name, frames in by_first.items():
        if frames is not None:
            for off, frame in enumerate(frames):
                image = lookup(frame)
                if image is not None:
                    entries.append(_AtlasEntry(frame, image, off, len(frames)))
                else:
                    log.error("unable to find texture/sprite: %r", frame)
        else:
            image = lookup(name)
            if image is not None:
                entries.append(_AtlasEntry(name, image, 0, 1))
    return entries


def _read_patches(wad: Archive) -> list[tuple[bytes, Image | None]]:
    """PNAMES + patch picture lumps (ref tex.rs:358-410)."""
    buf = wad.required_lump_bytes(b"PNAMES")
    num = int(np.frombuffer(buf[:4], dtype="<u4")[0])
    patches: list[tuple[bytes, Image | None]] = []
    missing = 0
    for i in range(num):
        raw = buf[4 + i * 8 : 4 + (i + 1) * 8]
        if len(raw) < 8:
            log.error("failed to read patch name with index %d", i)
            continue
        name = wad_name(raw, strict=False)
        lump = wad.named_lump_bytes(name)
        if lump is None:
            missing += 1
            patches.append((name, None))
            continue
        try:
            patches.append((name, Image.from_buffer(lump)))
        except CorruptImage as e:
            log.error("skipping patch %r: %s", name, e)
            patches.append((name, None))
    if missing:
        log.info("%d missing patches", missing)
    return patches


def _read_textures(
    buf: bytes, patches: list[tuple[bytes, Image | None]], out: dict[bytes, Image]
):
    """TEXTURE1/2: composite textures assembled by blitting patches
    (ref tex.rs:499-592)."""
    num = int(np.frombuffer(buf[:4], dtype="<u4")[0])
    offsets_end = 4 + num * 4
    if offsets_end > len(buf):
        raise CorruptWad("textures lump too small for offsets")
    offsets = np.frombuffer(buf[4:offsets_end], dtype="<u4")
    for i in range(num):
        off = int(offsets[i])
        if off >= len(buf):
            raise CorruptWad("texture offset out of bounds")
        hdr_end = off + T.TEXTURE_HEADER_DTYPE.itemsize
        if hdr_end > len(buf):
            log.error("skipping texture %d: truncated header", i)
            continue
        header = np.frombuffer(buf[off:hdr_end], dtype=T.TEXTURE_HEADER_DTYPE)[0]
        name = wad_name(bytes(header["name"]), strict=False)
        try:
            image = Image.blank(int(header["width"]), int(header["height"]))
        except CorruptImage as e:
            log.error("skipping texture %r: %s", name, e)
            continue
        prefs_end = hdr_end + int(header["num_patches"]) * T.TEXTURE_PATCH_REF_DTYPE.itemsize
        prefs = np.frombuffer(
            buf[hdr_end : min(prefs_end, len(buf))], dtype=T.TEXTURE_PATCH_REF_DTYPE
        )
        for i_patch, pref in enumerate(prefs):
            origin_y = int(pref["origin_y"])
            offset = (int(pref["origin_x"]), 0 if origin_y <= 0 else origin_y)
            idx = int(pref["patch"])
            if idx >= len(patches):
                log.error(
                    "patch ref index %d out of bounds (%d) in %r",
                    idx, len(patches), name,
                )
                continue
            pname, patch = patches[idx]
            if patch is None:
                log.error("patch %r, required by %r is missing", pname, name)
                continue
            image.blit(patch, offset, ignore_transparency=(i_patch == 0))
        out[name] = image


def _read_flats(wad: Archive) -> dict[bytes, np.ndarray]:
    """F_START..F_END raw 64x64 flats (ref tex.rs:594-606)."""
    start = wad.index_of(b"F_START")
    end = wad.index_of(b"F_END")
    flats: dict[bytes, np.ndarray] = {}
    if start is None or end is None:
        raise CorruptWad("missing F_START/F_END")
    for i in range(start, end):
        if wad.lump_is_virtual(i):
            continue
        flats[wad.lump_name(i)] = np.frombuffer(wad.lump_bytes(i), dtype=np.uint8)
    return flats


def _read_sprites(wad: Archive, textures: dict[bytes, Image]):
    """S_START..S_END sprite pictures, merged into the texture map
    (ref tex.rs:475-497)."""
    start = wad.index_of(b"S_START")
    end = wad.index_of(b"S_END")
    if start is None or end is None:
        raise CorruptWad("missing S_START/S_END")
    for i in range(start + 1, end):
        name = wad.lump_name(i)
        try:
            textures[name] = Image.from_buffer(wad.lump_bytes(i))
        except CorruptImage as e:
            log.error("skipping sprite %r: %s", name, e)
