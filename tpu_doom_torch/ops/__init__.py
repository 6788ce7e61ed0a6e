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
from .step import effects_rows, effects_rows_ref, player_triggers, player_triggers_ref
from .walk import walk_cross, walk_cross_ref, walk_records, walk_records_ref, walk_table

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
    "walk_table": walk_table,
    "walk_cross": walk_cross,
    "walk_records": walk_records,
    "effects_rows": effects_rows,
    "player_triggers": player_triggers,
}


def reset_launch_counts() -> None:
    from ..graphs import reset_conditional_runs

    for fn in KERNELS.values():
        fn.launches = 0
    render_portal_fused.per_env_launches = 0
    reset_conditional_runs()


def host_launch_counts() -> dict:
    """The wrappers' own counts: launches made eagerly, plus each replayed
    CUDA graph's launches outside its conditional nodes (`graphs.py`).
    B2's per-env-table launches also count on their own, as
    `render_portal_fused_per_env`."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["render_portal_fused_per_env"] = render_portal_fused.per_env_launches
    return counts


def add_launches(delta: dict) -> None:
    """Add {name: launches} (names as in `host_launch_counts`) to the
    wrappers' counts: what a graph replay launched."""
    for name, n in delta.items():
        if name == "render_portal_fused_per_env":
            render_portal_fused.per_env_launches += n
        else:
            KERNELS[name].launches += n


def launch_counts() -> dict:
    """Launches per kernel: `host_launch_counts` plus the launches of the
    conditional nodes' bodies in the replayed graphs, counted on the
    device where each body ran (read here, so this synchronises)."""
    from ..graphs import conditional_launches

    counts = host_launch_counts()
    for name, n in conditional_launches().items():
        counts[name] += n
    return counts


__all__ = [
    "KERNELS",
    "add_launches",
    "host_launch_counts",
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
    "walk_table",
    "walk_cross",
    "walk_cross_ref",
    "walk_records",
    "walk_records_ref",
    "effects_rows",
    "effects_rows_ref",
    "player_triggers",
    "player_triggers_ref",
]
