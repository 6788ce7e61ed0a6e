"""Renderers (port of `tpu_doom.render`): the portal column path with its
triangle-path fallback, and the triangle path alone."""

import torch

from .. import trace
from .camera import camera_matrices, perspective
from .raster import check_raster_backend, frames_to_rgb, render_frames


def env_chunk(cfg, batch: int, width: int, height: int) -> int:
    """The envs `render_dispatch` renders at once for this batch and image
    size: a positive `cfg.render_env_chunk`, else the whole batch.

    AUTO (-1) renders one piece, as 0 does. On an NVIDIA H100 80GB HBM3
    at 700 W (`tools/profile_tick.py --bank 5 --chunks`, PERF.md), config
    5's bank (4 x 1,024 envs at 640x400) took 226.3 / 209.5 / 202.9 /
    198.4 device ms per replayed bank tick at slices of 128 / 256 / 512
    envs and in one piece, its captured tick holding 4.3 / 4.3 / 6.1 /
    10.3 GiB, and one level's eager render 55.9 / 51.4 / 49.7 / 48.6 busy
    ms. One piece was the fastest at every size measured, and fits."""
    chunk = int(cfg.render_env_chunk)
    return batch if chunk <= 0 or batch <= chunk else chunk


def render_dispatch(scene, pscene, cfg, state, width, height):
    """The portal path when configured and a portal scene exists, the
    triangle path otherwise -> (indices (B, H, W) u8, covered (B, H, W)
    bool).

    The batch renders as a loop over env slices of `env_chunk` envs (the
    last may be smaller), each through the same path; every env renders
    on its own, so the frames equal those of one piece, and the slices
    bound the per-pass intermediates: the walk's (B, W, S+D) tensors and
    records, B4's output, B5's tables. `cfg.render_group_unroll` and
    `cfg.portal_tile_h` shape the JAX package's TPU programs and have no
    effect here."""
    check_raster_backend(cfg.raster_backend)
    batch = state.pos.shape[0]
    chunk = env_chunk(cfg, batch, width, height)
    with trace.span("render"):
        if batch <= chunk:
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
    "env_chunk",
    "frames_to_rgb",
]
