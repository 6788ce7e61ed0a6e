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

    # TPU-native knobs (no reference counterpart): the reference's clip loop
    # runs up to 100 variable iterations (player.rs:142-166); in lockstep
    # batch mode we run a fixed masked number of substeps.
    clip_substeps: int = 4
    # Disable to skip the noclip ground-probe sweep entirely (saves ~25% of
    # collision cost when noclip mode is never used, e.g. RL benchmarks).
    enable_noclip: bool = True
    # Collision broad-phase: sweep only the player's XZ grid cell's
    # triangle list instead of the whole level (geom/broadphase.py).
    collision_broadphase: bool = True
    # Collision sweep backend. "pallas" = the fused movement kernel
    # (ops/collision_pallas.py); "xla" = the SAME op graph evaluated as
    # plain XLA (bit-identical trajectories to the kernel); "auto" =
    # pallas on TPU, xla elsewhere; "legacy" = the original per-env
    # sweep_sphere path (the analytically-tested oracle). The fused
    # paths need the broad-phase row layout, so they only engage when
    # collision_broadphase is on.
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
    depth_layers: int = 3  # transparency depth-peeling layers
    # "portal"|"portal_jnp"|"auto"|"jnp" (see
    # render.raster.check_raster_backend for what each runs)
    raster_backend: str = "auto"
    # Pallas kernel tiling (swept on the target chip; tile_p=1024/chunk_t=64
    # balances per-tile overhead against sorted-chunk y-culling granularity).
    raster_tile_p: int = 1024
    raster_chunk_t: int = 64
    # Portal renderer: max ray/seg crossings walked per column.
    portal_crossings: int = 24
    # Kernel-side crossing compaction: the fused render kernel walks
    # only the crossings that are LIVE somewhere in the frame (typical
    # scenes have 2-4 of the portal_crossings budget live), compacted
    # to this many crossing blocks. Frames with more live crossings
    # fall back to the exact triangle path (slow). 0 disables.
    # -1 = AUTO: 8 on small levels (live counts 2-4 there, compaction
    # pays), OFF on deep levels (S+D > 192) -- corridor views on the
    # :texstress: maze carry 16-23 live crossings, so ANY budget below
    # the walk's 24 overflows most poses onto the triangle fallback
    # (the r4 default-config trap: 8 overflowed 71-100% of bench poses
    # and the "fast path" ran at fallback speed; the rolled classify
    # loop handles the uncompacted 120-record program fine).
    portal_compact_crossings: int = -1
    # Per-env VISIBLE-SEG compaction: before the (W x S) crossing math,
    # each env conservatively tests every wall seg / sprite against its
    # view (front-facing, inside the frustum wedge, within near/far) and
    # compacts the survivors to this many rows with one one-hot MXU
    # select. The walk then runs at the visible count instead of the
    # level's seg count -- the lever that restores triangle-count
    # independence on real-WAD-scale levels (S=590 on :texstress: vs 54
    # on :test:). The test is exactly conservative (a culled seg cannot
    # produce a valid crossing), so frames within budget are bit-exact;
    # frames with more visible segs than the budget fall back to the
    # exact triangle path (like crossing overflow). 0 disables; -1 =
    # AUTO: off for small levels (S+D <= 192, where the walk is cheap
    # and compaction overhead nets negative), else sized from the seg
    # count (see _resolve_visible_segs in render/portal.py).
    portal_visible_segs: int = -1
    # Attribute-selection backend for the walk on big-seg levels.
    # "auto": the Pallas VMEM select kernel replaces the HBM-
    # materialized one-hot einsums when S+D > 192 and crossing
    # compaction is off; "off": always the einsum path (A/B lever and
    # hardware-bisect fallback).
    portal_select_rows: str = "auto"
    # Render-kernel h-tile rows (the fused classify+shade kernel works
    # the frame in (portal_tile_h, W) tiles). -1 = AUTO: 40 when the
    # height divides evenly (5 exact tiles at 200 rows measured 8129
    # env-fps vs 7456 for 32, which pads 200 to 224), else 32.
    portal_tile_h: int = -1
    # Texture-scale knobs. Levels whose compact texel table fits
    # portal_global_segs_max rows (x128 texels) use the direct global
    # MXU lookup; bigger levels (real-WAD texture volume) switch to the
    # ACTIVE-SET path: the cells visible per env are gathered into a
    # portal_active_segs-row per-env table each frame (gather kernel +
    # per-env lookup), so per-pixel cost is bounded by the visible
    # working set, not the level's texel count. Frames whose visible
    # cells exceed the active budget fall back to the exact triangle
    # path (per-env, like crossing-compaction overflow).
    # Default 12288 rows = 1.5 MB int8 in VMEM (+192 KB hole bits):
    # above ~900 rows the global lookup runs SMEM-plan-GATED, so its
    # per-pixel cost follows the blocks a row group touches, not the
    # table size -- measured 2.06x faster than the active-set gather on
    # :texstress: (1415 vs 688 env-fps at bench defaults, r5). The
    # active path still serves beyond-VMEM tables (a full real-WAD
    # multi-episode atlas set).
    portal_global_segs_max: int = 12288
    # Active budget sizing: a maze/real-WAD view shows 20-110 distinct
    # texture cells x ~65 segs each (64x128 texture + guard, 8-seg
    # aligned). Budget cost is VMEM (bf16 table = act*256 bytes/env) +
    # per-frame gather traffic, NOT lookup compute -- the active path
    # always runs the SMEM-planned gated lookup, whose matmul work
    # scales with the blocks a row group actually touches. Measured on
    # :texstress: (random texture per sector, harsher than real WADs):
    # corridor views need 2300-3640 visible segs at the default
    # compaction budget and a MAX of 8472 at portal_compact_crossings=24
    # over the bench trajectory (64 envs x 40 ticks; p50 6024, p99
    # 8472); 9216 covers the measured max with a 744-seg margin
    # (2.4 MB VMEM per env in the kernel). Overflowing envs fall back
    # to the exact triangle path per frame, so the budget trades
    # throughput, not correctness.
    portal_active_segs: int = 9216
    # (r3: the walk-fused render kernel -- records built in-kernel --
    # was REMOVED: tools/perfcmp timed it 12% slower than the two-stage
    # path at the main bench point (5595 vs 6330 env-fps) AND bench.py
    # --verify caught it miscompiling on real TPU hardware, ~50% wrong
    # pixels on every pose while interpret-mode equality held.)
    # Free-look handling on the portal path. "shear" (default): pitched
    # envs render with y-shear (classic source-port look-up/down: exact
    # sky + exact pitched camera position, walls stay screen-vertical)
    # and remain on the fast path at any legal pitch. "triangle":
    # pitched envs fall back to the exact triangle path (r2 behavior;
    # ~5x slower whenever any env pitches). Zero-pitch frames are
    # bit-identical across modes.
    portal_pitch: str = "shear"
    # Render at most this many envs per render invocation; larger
    # batches run as unrolled chunks inside one jit. This (a) bounds the
    # (B, R, NCH, W) record / classify intermediates so 1024-4096-env
    # batches fit HBM, and (b) small per-chunk shapes schedule MUCH
    # better (B=256 rendered as 32 unrolled 8-env chunks measured 5900
    # env-fps vs 3300 in one piece -- independent chunk pipelines let
    # the scheduler overlap DMA with compute; the sim step is NOT
    # chunked, it is op-bound and nearly flat in batch).
    # -1 = AUTO: a constant 32 (re-swept r5 with the fused kernel:
    # 8905 env-fps vs 8501 at the r2-era 8; batches beyond the group
    # unroll scan over unrolled chunk groups). 0 disables chunking.
    render_env_chunk: int = -1
    # Chunks unrolled per group of the chunked-render scan. -1 = AUTO
    # (32; an outer lax.scan covers larger batches). Big-seg levels may
    # prefer a smaller unroll: each unrolled chunk body carries the
    # whole walk + select + gather + fused-kernel pipeline, and at
    # :texstress: scale the 32-body program pushes XLA compile past 20
    # minutes (scan at group granularity measured flat on throughput).
    render_group_unroll: int = -1

    @property
    def fov_radians(self) -> float:
        return math.radians(self.fov)
