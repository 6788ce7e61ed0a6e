"""Configuration dataclasses.

Reference: game/src/game.rs:26-34 (GameConfig), game/src/player.rs:54-92
(player physics constants), engine/src/tick.rs + game/src/game.rs:40-42
(fixed 1/60 timestep). All constants kept bit-identical for behavior parity.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PlayerConfig:
    move_force: float = 60.0
    spring_const_p: float = 200.0
    spring_const_d: float = 22.4
    radius: float = 0.19
    height: float = 0.21
    air_drag: float = 0.02
    ground_drag: float = 0.7
    friction: float = 30.0

    fov: float = 65.0  # degrees, horizontal-ish (see Projection)
    near: float = 0.01
    far: float = 100.0
    aspect_ratio_correction: float = 1.2

    camera_height: float = 0.12

    # Collision knobs (no reference counterpart). The reference's clip loop
    # runs up to 100 variable iterations (player.rs:142-166); in lockstep
    # batch mode kernel B1 (ops/collision.py) runs at most this many clip
    # substeps per env, and stops an env's loop at its first substep that
    # is not blocked.
    clip_substeps: int = 4
    # Off: B1 skips the noclip probe sweep (its output slot reads inf), for
    # runs that never toggle noclip.
    enable_noclip: bool = True
    # Collision broad-phase: sweep only the player's XZ grid cell's
    # triangle list instead of the whole level (geom/broadphase.py).
    # False sweeps every triangle through the `legacy` oracle (sim/step.py).
    collision_broadphase: bool = True
    # "auto": kernel B1 for CUDA tensors, its plain PyTorch version for
    # CPU tensors. "legacy": the per-env sweep_sphere oracle
    # (sim/collision.py), plain PyTorch on any device. The JAX package's
    # other names pick a TPU kernel and raise here
    # (sim/step.py:check_collision_config).
    collision_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class GameConfig:
    wad_file: str = "doom1.wad"
    metadata_file: str = "assets/meta/doom.toml"
    fov: float = 65.0
    width: int = 320
    height: int = 200
    initial_level_index: int = 0
    version: str = "0.1.0"

    timestep: float = 1.0 / 60.0
    batch_size: int = 1
    player: PlayerConfig = dataclasses.field(default_factory=PlayerConfig)

    # Renderer knobs.
    depth_layers: int = 3  # transparency depth-peeling layers (B3, B9)
    # "portal"|"portal_jnp"|"auto"|"jnp" (see
    # render.raster.check_raster_backend for what each runs)
    raster_backend: str = "auto"
    # B3's window-y cull (render_frames' "auto" path): a chunk of
    # raster_chunk_t consecutive y-sorted triangles is tested against a
    # run of raster_tile_p consecutive pixels only where their window-y
    # bounds overlap. Both the plain version and the kernel apply it per
    # pixel, so it shapes no launch: B3 and B9 render fixed 32 x 32 pixel
    # tiles (csrc/peel.cuh). B9 (the "jnp" path) reads neither.
    raster_tile_p: int = 1024
    raster_chunk_t: int = 64
    # Portal renderer: max ray/seg crossings walked per column.
    portal_crossings: int = 24
    # Crossing compaction in the walk (render/portal.py:walk): only the
    # crossings live in some column of an env's frame are kept, at most
    # this many; an env with more renders through the exact triangle
    # path (B3, or B9 under portal_jnp). 0 disables. -1 = AUTO: 8 on
    # small levels (S+D <= 192 walk rows), off on big ones, whose corridor
    # views carry more live crossings than any small budget.
    portal_compact_crossings: int = -1
    # Per-env VISIBLE-SEG cull before the (W x S) crossing math: each env
    # conservatively tests every wall seg / sprite against its view
    # (front-facing, inside the frustum wedge, within near/far) and keeps
    # at most this many rows, so the walk runs at the visible count and
    # not the level's seg count. A culled seg cannot produce a valid
    # crossing, so frames within budget are unchanged; an env with more
    # visible segs renders through the exact triangle path. 0 disables;
    # -1 = AUTO: off on small levels, else sized from the seg count
    # (render/portal.py:visible_segs).
    portal_visible_segs: int = -1
    # Attribute select of the walk on big levels. "auto": kernel B4
    # (ops/raster.py:select_rows) selects every attribute column at every
    # crossing when S+D > 192 and crossing compaction is off, and kernel
    # W2 builds the records from that selection; "off": W2 reads the
    # attribute table at each crossing's row instead (the same values).
    portal_select_rows: str = "auto"
    # No effect on the port. The JAX package tiles its TPU render kernel
    # in (portal_tile_h, W) row tiles; B2 and B8 pick their own launch
    # shape. Any value is accepted, so a config shared with the JAX
    # package keeps working, and no value changes a frame there either.
    portal_tile_h: int = -1
    # Texel-table knobs. Levels whose compact texel table fits
    # portal_global_segs_max rows (x128 texels) render with B2 reading
    # the one global int8 table; bigger levels take the ACTIVE-SET path:
    # per frame, B6 (scatter_live) marks the texture cells each env sees,
    # B5 (gather_cells) copies them into a portal_active_segs-row int16
    # table per env, and B2 reads that table in its per-env mode, so the
    # per-pixel work follows the visible working set, not the level's
    # texel count. An env whose visible cells exceed the active budget
    # renders through the exact triangle path.
    portal_global_segs_max: int = 12288
    # Rows of each env's active table (128 int16 texels a row). A
    # maze-like view shows some tens of distinct texture cells of ~65 rows
    # each; the budget costs device memory and B5's copy per frame, and an
    # env over it falls back to the triangle path, so it trades speed,
    # not correctness.
    portal_active_segs: int = 9216
    # Free-look handling on the portal path. "shear" (default): pitched
    # envs render with y-shear (classic source-port look-up/down: exact
    # sky + exact pitched camera position, walls stay screen-vertical)
    # and stay on the portal path at any legal pitch. "triangle":
    # pitched envs render through the exact triangle path (B3, or B9
    # under portal_jnp). Zero-pitch frames are bit-identical across modes.
    portal_pitch: str = "shear"
    # Render at most this many envs per render pass: a positive value
    # renders the batch as a loop over env slices of this size (the last
    # may be smaller), each through the same path, which bounds the
    # per-slice intermediates (the walk's records, B4's output, B5's
    # tables) for large batches. Frames are the same as in one piece.
    # 0: one piece. -1 = AUTO, on the port also one piece: the fastest
    # at every size measured on an H100 (render/__init__.py:env_chunk).
    render_env_chunk: int = -1
    # No effect on the port. The JAX package unrolls this many env chunks
    # per step of its compiled chunk loop; the port loops over slices in
    # Python. Any value is accepted, and no value changes a frame.
    render_group_unroll: int = -1

    @property
    def fov_radians(self) -> float:
        return math.radians(self.fov)
