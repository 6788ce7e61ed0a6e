"""WAD archive reader: header, lump directory, level detection.

Reference behavior: rust-doom's wad/src/archive.rs. The whole file is
read into memory once (WADs are ~4-12MB) and lumps are zero-copy slices.
Level lumps are detected as the lump preceding a ``THINGS`` lump
(archive.rs:94-97). Named lookup keeps the *last* lump with a given name,
matching the reference's IndexMap insert semantics (archive.rs:85).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import types as T
from .name import wad_name


class CorruptWad(ValueError):
    pass


class Archive:
    """An opened WAD file: lump directory + raw bytes."""

    def __init__(self, data: bytes, *, source: str = "<memory>"):
        self.source = source
        self.data = data
        if len(data) < 12:
            raise CorruptWad(f"{source}: too small for WAD header")
        header = np.frombuffer(data[:12], dtype=T.WAD_INFO_DTYPE)[0]
        if bytes(header["identifier"]) != b"IWAD":
            raise CorruptWad(
                f"{source}: bad header identifier {bytes(header['identifier'])!r}"
            )
        num_lumps = int(header["num_lumps"])
        off = int(header["info_table_offset"])
        end = off + num_lumps * T.LUMP_INFO_DTYPE.itemsize
        if off < 0 or end > len(data):
            raise CorruptWad(f"{source}: lump directory out of bounds")
        self.lumps = np.frombuffer(data[off:end], dtype=T.LUMP_INFO_DTYPE)

        self._index_by_name: dict[bytes, int] = {}
        self.levels: list[int] = []
        for i in range(num_lumps):
            name = self._lump_name(i)
            self._index_by_name[name] = i
            # Heuristic: a level marker lump immediately precedes THINGS
            # (ref archive.rs:94-97).
            if name == b"THINGS\0\0":
                if i == 0:
                    raise CorruptWad(f"{source}: THINGS as first lump")
                self.levels.append(i - 1)

    @classmethod
    def open(cls, path: str | os.PathLike) -> "Archive":
        with open(path, "rb") as f:
            return cls(f.read(), source=str(path))

    # -- lump access ---------------------------------------------------

    def _lump_name(self, index: int) -> bytes:
        raw = bytes(self.lumps[index]["name"])
        # Tolerant normalization: uppercase, truncate at NUL, pad.
        return wad_name(raw.ljust(8, b"\0"), strict=False)

    @property
    def num_lumps(self) -> int:
        return len(self.lumps)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_name(self, level_index: int) -> bytes:
        return self._lump_name(self.levels[level_index])

    def level_index_of(self, level_index: int) -> int:
        return self.levels[level_index]

    def lump_name(self, index: int) -> bytes:
        return self._lump_name(index)

    def index_of(self, name: bytes | str) -> Optional[int]:
        return self._index_by_name.get(wad_name(name, strict=False))

    def lump_bytes(self, index: int) -> bytes:
        info = self.lumps[index]
        pos, size = int(info["file_pos"]), int(info["size"])
        if pos < 0 or pos + size > len(self.data):
            raise CorruptWad(f"{self.source}: lump {index} out of bounds")
        return self.data[pos : pos + size]

    def lump_is_virtual(self, index: int) -> bool:
        return int(self.lumps[index]["size"]) == 0

    def named_lump_bytes(self, name: bytes | str) -> Optional[bytes]:
        idx = self.index_of(name)
        return None if idx is None else self.lump_bytes(idx)

    def required_lump_bytes(self, name: bytes | str) -> bytes:
        data = self.named_lump_bytes(name)
        if data is None:
            raise CorruptWad(f"{self.source}: missing required lump {name!r}")
        return data

    def decode_lump(self, index: int, dtype: np.dtype) -> np.ndarray:
        """Decode a whole lump as an array of fixed-size records
        (ref archive.rs:172-190 ``decode_vec``)."""
        data = self.lump_bytes(index)
        if len(data) == 0 or len(data) % dtype.itemsize != 0:
            raise CorruptWad(
                f"{self.source}: lump {index} ({self._lump_name(index)!r}) has "
                f"size {len(data)}, not a positive multiple of {dtype.itemsize}"
            )
        return np.frombuffer(data, dtype=dtype)
