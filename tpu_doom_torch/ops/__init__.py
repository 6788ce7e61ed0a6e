"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
runs its plain version for CPU tensors; `wrapper.launches` counts kernel
launches and nothing else. Kernel modules build nothing at import: the
nvcc build runs at the first launch (`tpu_doom_torch._build.load`).
"""

from .collision import player_move, player_move_ref
from .raster import (
    classify_alpha,
    classify_alpha_ref,
    depth_peel,
    depth_peel_ref,
    gather_cells,
    gather_cells_ref,
    pack_triangle_rows,
    peel_resolve,
    peel_resolve_ref,
    render_portal_fused,
    render_portal_fused_ref,
    scatter_live,
    scatter_live_ref,
    select_rows,
    select_rows_ref,
    shade_portal,
    shade_portal_ref,
)

# name -> wrapper, for resetting and reading the launch counts.
KERNELS = {
    "player_move": player_move,
    "render_portal_fused": render_portal_fused,
    "peel_resolve": peel_resolve,
    "select_rows": select_rows,
    "gather_cells": gather_cells,
    "scatter_live": scatter_live,
    "classify_alpha": classify_alpha,
    "shade_portal": shade_portal,
    "depth_peel": depth_peel,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    render_portal_fused.per_env_launches = 0


def launch_counts() -> dict:
    """Launches per kernel; B2's per-env-table launches also count on
    their own, as `render_portal_fused_per_env`."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["render_portal_fused_per_env"] = render_portal_fused.per_env_launches
    return counts


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "player_move",
    "player_move_ref",
    "render_portal_fused",
    "render_portal_fused_ref",
    "peel_resolve",
    "peel_resolve_ref",
    "select_rows",
    "select_rows_ref",
    "gather_cells",
    "gather_cells_ref",
    "scatter_live",
    "scatter_live_ref",
    "classify_alpha",
    "classify_alpha_ref",
    "shade_portal",
    "shade_portal_ref",
    "pack_triangle_rows",
    "depth_peel",
    "depth_peel_ref",
]
