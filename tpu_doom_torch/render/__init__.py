"""Renderers (port of `tpu_doom.render`): the portal column path with its
triangle-path fallback, and the triangle path alone."""

import torch

from .camera import camera_matrices, perspective
from .raster import check_raster_backend, frames_to_rgb, render_frames


def render_dispatch(scene, pscene, cfg, state, width, height):
    """The portal path when configured and a portal scene exists, the
    triangle path otherwise -> (indices (B, H, W) u8, covered (B, H, W)
    bool).

    A positive `cfg.render_env_chunk` renders the batch as a loop over env
    slices of that size (the last may be smaller), each through the same
    path; every env renders on its own, so the frames equal those of one
    piece, and the slices bound the per-pass intermediates. 0 renders one
    piece, and so does -1 (AUTO): the JAX package's AUTO sizes were tuned
    on a TPU, and no size has been chosen for the card yet.
    `cfg.render_group_unroll` and `cfg.portal_tile_h` shape the JAX
    package's TPU programs and have no effect here."""
    check_raster_backend(cfg.raster_backend)
    batch = state.pos.shape[0]
    chunk = int(cfg.render_env_chunk)
    if chunk <= 0 or batch <= chunk:
        return _render_one(scene, pscene, cfg, state, width, height)
    parts = [
        _render_one(scene, pscene, cfg, state._make(x[i:i + chunk] for x in state),
                    width, height)
        for i in range(0, batch, chunk)
    ]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _render_one(scene, pscene, cfg, state, width, height):
    if cfg.raster_backend.startswith("portal") and pscene is not None:
        from .portal import render_frames_portal

        return render_frames_portal(pscene, scene, cfg, state, width, height)
    return render_frames(scene, cfg, state, width, height)


__all__ = [
    "camera_matrices",
    "perspective",
    "render_frames",
    "render_dispatch",
    "frames_to_rgb",
]
