"""Host-side WAD asset & level loading (NumPy). Reference: the `wad` crate."""

from .name import wad_name, is_untextured, is_sky_flat
from .types import (
    THING_DTYPE,
    VERTEX_DTYPE,
    LINEDEF_DTYPE,
    SIDEDEF_DTYPE,
    SECTOR_DTYPE,
    SUBSECTOR_DTYPE,
    SEG_DTYPE,
    NODE_DTYPE,
)
from .archive import Archive
from .level import LevelData
from .image import Image
from .tex import TextureDirectory, Bounds
from .meta import WadMetadata
from .light import LightInfo, light_info_for_sector, with_contrast

__all__ = [
    "wad_name",
    "is_untextured",
    "is_sky_flat",
    "Archive",
    "LevelData",
    "Image",
    "TextureDirectory",
    "Bounds",
    "WadMetadata",
    "LightInfo",
    "light_info_for_sector",
    "with_contrast",
    "THING_DTYPE",
    "VERTEX_DTYPE",
    "LINEDEF_DTYPE",
    "SIDEDEF_DTYPE",
    "SECTOR_DTYPE",
    "SUBSECTOR_DTYPE",
    "SEG_DTYPE",
    "NODE_DTYPE",
]
