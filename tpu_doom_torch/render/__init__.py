"""Renderers (port of `tpu_doom.render`): the portal column path with its
triangle-path fallback, and the triangle path alone."""

from .camera import camera_matrices, perspective
from .raster import check_raster_backend, frames_to_rgb, render_frames


def render_dispatch(scene, pscene, cfg, state, width, height):
    """The portal path when configured and a portal scene exists, the
    triangle path otherwise. The whole batch renders in one piece (the
    TPU-tuned env chunking of the JAX package is not carried over)."""
    backend = check_raster_backend(cfg.raster_backend)
    if backend.startswith("portal") and pscene is not None:
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
