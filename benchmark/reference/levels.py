"""Levels of the reference, compiled from WAD files by its own compiler."""

from __future__ import annotations

from .geom.builder import compile_level
from .wad.archive import Archive
from .wad.meta import WadMetadata
from .wad.tex import TextureDirectory


def compile_levels(specs, metadata_file: str) -> list:
    """The LevelArrays of (wad path, level index) specs."""
    meta = WadMetadata.from_file(metadata_file)
    wads, out = {}, []
    for path, level in specs:
        if path not in wads:
            wad = Archive.open(path)
            wads[path] = (wad, TextureDirectory(wad, meta))
        out.append(compile_level(*wads[path], meta, level))
    return out
