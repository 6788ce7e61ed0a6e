"""Device-resident scene: one level's arrays uploaded once.

Port of `tpu_doom/sim/scene.py`: a NamedTuple of tensors built from the
shared numpy `LevelArrays`. `combo_atlas` is widened from uint16 to int32
because PyTorch has no `take` for uint16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geom.builder import LevelArrays

_FIELDS = (
    "static_pos", "static_atlas_uv", "static_tile_uv", "static_tile_size",
    "static_scroll", "static_row_height", "static_num_frames",
    "static_light", "static_object", "wall_tris", "wall_tri_transparent",
    "flat_tris", "sky_pos", "sky_object", "sky_tris", "decor_pos",
    "decor_local_x", "decor_atlas_uv", "decor_tile_uv", "decor_tile_size",
    "decor_num_frames", "decor_light", "decor_object", "decor_tris",
    "coll_v0", "coll_v1", "coll_v2", "coll_normal", "coll_object",
    "bp_origin", "bp_inv_cell", "bp_dims", "bp_cells", "trig_origin",
    "trig_displace", "trig_length", "trig_type", "trig_only_once",
    "trig_exit", "eff_trigger", "eff_object", "eff_first_offset",
    "eff_second_offset", "eff_has_second", "eff_speed", "eff_wait",
    "light_level", "light_kind", "light_alt", "light_speed",
    "light_duration", "light_sync", "palette", "palette_lut", "colormaps",
    "walls_atlas_index", "walls_atlas_alpha", "flats_atlas",
    "decor_atlas_index", "decor_atlas_alpha", "combo_atlas", "combo_dims",
    "sky_index", "tiled_band_size", "start_pos", "start_yaw",
)


class Scene(NamedTuple):
    """All per-level device tensors (same fields as `tpu_doom`'s Scene)."""

    static_pos: torch.Tensor
    static_atlas_uv: torch.Tensor
    static_tile_uv: torch.Tensor
    static_tile_size: torch.Tensor
    static_scroll: torch.Tensor
    static_row_height: torch.Tensor
    static_num_frames: torch.Tensor
    static_light: torch.Tensor
    static_object: torch.Tensor
    wall_tris: torch.Tensor
    wall_tri_transparent: torch.Tensor
    flat_tris: torch.Tensor
    sky_pos: torch.Tensor
    sky_object: torch.Tensor
    sky_tris: torch.Tensor
    decor_pos: torch.Tensor
    decor_local_x: torch.Tensor
    decor_atlas_uv: torch.Tensor
    decor_tile_uv: torch.Tensor
    decor_tile_size: torch.Tensor
    decor_num_frames: torch.Tensor
    decor_light: torch.Tensor
    decor_object: torch.Tensor
    decor_tris: torch.Tensor
    coll_v0: torch.Tensor
    coll_v1: torch.Tensor
    coll_v2: torch.Tensor
    coll_normal: torch.Tensor
    coll_object: torch.Tensor
    bp_origin: torch.Tensor
    bp_inv_cell: torch.Tensor
    bp_dims: torch.Tensor
    bp_cells: torch.Tensor
    trig_origin: torch.Tensor
    trig_displace: torch.Tensor
    trig_length: torch.Tensor
    trig_type: torch.Tensor
    trig_only_once: torch.Tensor
    trig_exit: torch.Tensor
    eff_trigger: torch.Tensor
    eff_object: torch.Tensor
    eff_first_offset: torch.Tensor
    eff_second_offset: torch.Tensor
    eff_has_second: torch.Tensor
    eff_speed: torch.Tensor
    eff_wait: torch.Tensor
    light_level: torch.Tensor
    light_kind: torch.Tensor
    light_alt: torch.Tensor
    light_speed: torch.Tensor
    light_duration: torch.Tensor
    light_sync: torch.Tensor
    palette: torch.Tensor
    palette_lut: torch.Tensor
    colormaps: torch.Tensor
    walls_atlas_index: torch.Tensor
    walls_atlas_alpha: torch.Tensor
    flats_atlas: torch.Tensor
    decor_atlas_index: torch.Tensor
    decor_atlas_alpha: torch.Tensor
    combo_atlas: torch.Tensor  # int32 (uint16 in the level arrays)
    combo_dims: torch.Tensor
    sky_index: torch.Tensor
    tiled_band_size: torch.Tensor  # () f32
    start_pos: torch.Tensor
    start_yaw: torch.Tensor  # () f32

    @property
    def device(self) -> torch.device:
        return self.start_pos.device

    @property
    def num_triggers(self) -> int:
        return self.trig_origin.shape[0]


def scene_from_arrays(arrays: LevelArrays, device) -> tuple[Scene, int]:
    """Upload a compiled level to `device`; returns (scene, num_objects)."""
    vals = {}
    for name in _FIELDS:
        x = np.asarray(getattr(arrays, name))
        if name in ("tiled_band_size", "start_yaw"):
            x = x.astype(np.float32)
        elif name == "combo_atlas":
            x = x.astype(np.int32)
        vals[name] = torch.as_tensor(np.ascontiguousarray(x), device=device)
    return Scene(**vals), arrays.num_objects
