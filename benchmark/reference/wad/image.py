"""Doom picture-format decoding and composition.

Reference behavior: rust-doom's wad/src/image.rs. Pixels are u16:
low byte = palette/colormap index, high bit set = transparent (blank init
is 0xff00 for composite canvases, 0xffff for decoded pictures). Decoding
walks per-column RLE "posts"; `blit` merges with branchless transparency.
"""

from __future__ import annotations

import numpy as np

MAX_IMAGE_SIZE = 4096

TRANSPARENT_CANVAS = 0xFF00  # image.rs:30 (Image::new)
TRANSPARENT_DECODE = 0xFFFF  # image.rs:63 (Image::from_buffer)


class CorruptImage(ValueError):
    pass


class Image:
    """A paletted image with transparency in the high byte."""

    __slots__ = ("pixels", "x_offset", "y_offset")

    def __init__(self, pixels: np.ndarray, x_offset: int = 0, y_offset: int = 0):
        assert pixels.dtype == np.uint16 and pixels.ndim == 2
        self.pixels = pixels  # (H, W)
        self.x_offset = x_offset
        self.y_offset = y_offset

    @classmethod
    def blank(cls, width: int, height: int) -> "Image":
        if width > MAX_IMAGE_SIZE or height > MAX_IMAGE_SIZE:
            raise CorruptImage(f"image too large: {width}x{height}")
        return cls(np.full((height, width), TRANSPARENT_CANVAS, dtype=np.uint16))

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def size(self) -> tuple[int, int]:
        return (self.width, self.height)

    @classmethod
    def from_buffer(cls, buffer: bytes) -> "Image":
        """Decode the column-run picture format (ref image.rs:39-169)."""
        return cls._from_buffer_py(buffer)

    @classmethod
    def _from_buffer_py(cls, buffer: bytes) -> "Image":
        """Pure-Python decoder (reference implementation + fallback)."""
        buf = np.frombuffer(buffer, dtype=np.uint8)
        if len(buf) < 8:
            raise CorruptImage("image header truncated")
        header = np.frombuffer(buffer[:8], dtype="<i2")
        width, height = int(header[0]) & 0xFFFF, int(header[1]) & 0xFFFF
        if width > MAX_IMAGE_SIZE or height > MAX_IMAGE_SIZE:
            raise CorruptImage(f"image too large: {width}x{height}")
        x_offset, y_offset = int(header[2]), int(header[3])
        if len(buf) < 8 + 4 * width:
            raise CorruptImage("image column directory truncated")
        col_offsets = np.frombuffer(buffer[8 : 8 + 4 * width], dtype="<u4")

        pixels = np.full((height, width), TRANSPARENT_DECODE, dtype=np.uint16)
        n = len(buf)
        for i_col in range(width):
            off = int(col_offsets[i_col])
            if off >= n:
                raise CorruptImage(
                    f"invalid column offset {off} in column {i_col} (size {n})"
                )
            while True:
                if off >= n:
                    raise CorruptImage(f"unfinished column {i_col}")
                row_start = int(buf[off])
                if row_start == 255:
                    break
                if off + 2 >= n:
                    raise CorruptImage(f"missing run length in column {i_col}")
                run_length = int(buf[off + 1])
                if row_start + run_length > height:
                    raise CorruptImage(
                        f"run too big in column {i_col}: {row_start}+{run_length} "
                        f"> {height}"
                    )
                # layout: row_start, run_length, pad, <run pixels>, pad
                data_start = off + 3
                data_end = data_start + run_length
                if data_end + 1 > n:
                    raise CorruptImage(f"source underrun in column {i_col}")
                pixels[row_start : row_start + run_length, i_col] = buf[
                    data_start:data_end
                ].astype(np.uint16)
                off = data_end + 1
        return cls(pixels, x_offset, y_offset)

    def blit(self, source: "Image", offset: tuple[int, int], ignore_transparency: bool):
        """Copy ``source`` into self at ``offset`` (x, y), clipping at the
        edges; transparent source pixels (high bit set) are skipped unless
        ``ignore_transparency`` (ref image.rs:171-252)."""
        ox, oy = int(offset[0]), int(offset[1])
        if ox >= self.width or oy >= self.height:
            return
        x_start = max(0, -ox)
        y_start = max(0, -oy)
        x_end = min(source.width, self.width - ox)
        y_end = min(source.height, self.height - oy)
        if x_end <= x_start or y_end <= y_start:
            return
        src = source.pixels[y_start:y_end, x_start:x_end]
        dst = self.pixels[
            y_start + oy : y_end + oy, x_start + ox : x_end + ox
        ]
        if ignore_transparency:
            dst[...] = src
        else:
            opaque = (src >> 15) == 0
            np.copyto(dst, src, where=opaque)

    def to_index_alpha(self) -> tuple[np.ndarray, np.ndarray]:
        """(H, W) uint8 palette-index plane + bool opaque-mask plane."""
        return (self.pixels & 0xFF).astype(np.uint8), (self.pixels >> 15) == 0
