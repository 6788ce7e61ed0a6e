"""LevelBank: mixed-level batches on one device.

Port of `tpu_doom/models/level_bank.py`. Every level's arrays are padded
to common shapes and stacked on a leading level axis; the batch is
organised as (L, E): L levels x E envs each. Padding is inert by
construction:
  * render triangles pad to (0, 0, 0): degenerate, det = 0, culled;
  * collision triangles pad to a distant degenerate point with a unit
    normal, rejected by the behind-plane test;
  * triggers pad to zero-length lines, which no segment test hits;
  * effect defs pad to (trigger 0, object 0, offset 0, speed 1), which
    deactivates in one tick without moving anything;
  * portal segs pad to zero-length segs (the walk's |denom| >= 1e-12 test
    rejects them) and sprites to zero-half-width billboards.

`step` and `render` unroll the level loop: each level runs the port's
single-level `sim.step.step` and `render.render_dispatch` on its view of
the stacked tensors (`_at`), so every kernel sees a level's own shapes,
as the JAX package does. `step_with_exits` moves envs whose exit fired
to the next level's group on the device, with no host read, so that a
bank tick (it, then `render`) can be captured as one CUDA graph
(`graphs.CapturedTick`).

Under a process mesh (`parallel.make_mesh`) each rank holds a 'dp' block
of the env axis. The migration fills the first free slots of a whole
group, which may lie on another rank, so the bank all-gathers the
(L, E) exit and occupancy masks over 'dp' (`parallel.gather_envs`, 2 L E
bytes), runs the same migration on the global masks on every rank and
keeps its own block: bitwise the unsharded bank by construction. (The
JAX package gets the same from XLA's partitioner.)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..geom.builder import LevelArrays
from ..render import render_dispatch
from ..render.raster import check_raster_backend
from ..sim.scene import Scene, scene_from_arrays
from ..sim.state import SimState, initial_state
from ..sim.step import check_collision_config
from ..sim.step import step as sim_step
from .doom_sim import checked_device


def _pad_to(a: np.ndarray, shape, fill) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 0:
        return a
    pads = [(0, s - c) for s, c in zip(shape, a.shape)]
    return np.pad(a, pads, constant_values=fill)


_FILLS = dict(
    static_num_frames=1,
    decor_num_frames=1,
    coll_v0=1e6,
    coll_v1=1e6,
    coll_v2=1e6,
    flats_atlas=255,
    walls_atlas_index=255,
    decor_atlas_index=255,
    sky_index=0,
    eff_speed=1.0,
    combo_atlas=256,  # padded texels read as transparent holes
    bp_cells=-1,
)


def pad_level_arrays(levels: Sequence[LevelArrays]) -> list[LevelArrays]:
    """Pad every array field to the max shape across levels."""
    fields = [
        f.name
        for f in dataclasses.fields(LevelArrays)
        if f.name not in ("name", "num_objects", "tiled_band_size", "start_yaw", "stats", "portal")
    ]
    max_shape = {}
    for name in fields:
        shapes = [getattr(lv, name).shape for lv in levels]
        max_shape[name] = tuple(max(s[i] for s in shapes) for i in range(len(shapes[0])))
    out = []
    for lv in levels:
        kw = {}
        for name in fields:
            a = getattr(lv, name)
            kw[name] = _pad_to(a, max_shape[name], _FILLS.get(name, 0))
            # Collision normals need unit length even in padding.
            if name == "coll_normal":
                pad_rows = max_shape[name][0] - a.shape[0]
                if pad_rows:
                    kw[name][a.shape[0]:, 1] = 1.0
        out.append(dataclasses.replace(
            lv, **kw, num_objects=max(x.num_objects for x in levels)))
    return out


def _pad_portal_table(table, max_segs, max_sprites):
    """Pad a PortalTable's seg axis (zero-length segs are never crossed:
    the walk's |denom| >= 1e-12 test rejects them) and its sprite axis
    (zero-half-width billboards are equally degenerate)."""
    kw = {}
    for f in dataclasses.fields(table):
        a = getattr(table, f.name)
        if np.ndim(a) == 0:
            kw[f.name] = a
            continue
        n = max_sprites if f.name.startswith("sprite_") else max_segs
        pads = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        kw[f.name] = np.pad(a, pads)
    return dataclasses.replace(table, **kw)


def _pad_rows(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """Pad the first axis of a 2-D tensor to `rows` with `fill`."""
    return F.pad(t, (0, 0, 0, rows - t.shape[0]), value=fill) if t.shape[0] < rows else t


def stack_portal_scenes(padded_levels: Sequence[LevelArrays], device="cuda") -> dict:
    """The port's portal scene (`render.portal.portal_scene_from_table`)
    with a leading level axis on `device`: one tensor per key, and "hc"
    (each level's alpha-plane height, a Python int the kernels take) as a
    tuple of L ints. The seg and sprite axes were padded in the tables;
    the rest here:
      * `alpha_words` (2 wc, n_words): zero words (rows beyond a level's
        plane height are never addressed by its own texels);
      * `tex_i8` and `tex_full`: zero rows (each level's bases stay in its
        own table; `tex_full` keeps its +8-row guard);
      * `hole_bytes`: when any level has holes, every level gets ceil(S1 /
        8) rows of -128 (byte 0: no holes), S1 the padded `tex_i8` rows,
        so that kernel B8 can read a hole byte for every texel the padded
        table holds (the JAX package pads to the largest member's table,
        which B8 refuses when a holeless member is the largest);
      * `sky_tex`: zero texels (sky coordinates wrap by the level's own
        `combo_dims`);
      * the cell axis of `cell_m`, `cell_gseg0`, `cell_nsegs`: cells with no
        segment, which no row selects and the gather copies nothing of.
    The port has no `hole_ranges`: it did not port the TPU's per-tile
    transparency gate."""
    from ..render.portal import portal_scene_from_table

    max_segs = max(len(lv.portal.p1) for lv in padded_levels)
    max_sprites = max(len(lv.portal.sprite_half) for lv in padded_levels)
    pscenes = [
        portal_scene_from_table(_pad_portal_table(lv.portal, max_segs, max_sprites),
                                lv, "cpu")
        for lv in padded_levels
    ]
    aw = max(p["alpha_words"].shape[1] for p in pscenes)
    ts = max(p["tex_i8"].shape[0] for p in pscenes)
    sh = max(p["sky_tex"].shape[0] for p in pscenes)
    sw = max(p["sky_tex"].shape[1] for p in pscenes)
    tf = max(p["tex_full"].shape[0] for p in pscenes)
    nc = max(p["cell_m"].shape[1] for p in pscenes)
    holes = any("hole_bytes" in p for p in pscenes)
    for p in pscenes:
        p["alpha_words"] = F.pad(p["alpha_words"], (0, aw - p["alpha_words"].shape[1]))
        p["tex_i8"] = _pad_rows(p["tex_i8"], ts)
        p["tex_full"] = _pad_rows(p["tex_full"], tf)
        sk = p["sky_tex"]
        p["sky_tex"] = F.pad(sk, (0, sw - sk.shape[1], 0, sh - sk.shape[0]))
        if holes:
            # s8 tables store byte - 128: -128 is byte 0, no holes.
            hb = p.get("hole_bytes", torch.full((0, 128), -128, dtype=torch.int8))
            p["hole_bytes"] = _pad_rows(hb, -(-ts // 8), -128)
        c = p["cell_m"].shape[1]
        p["cell_m"] = F.pad(p["cell_m"], (0, nc - c))
        p["cell_gseg0"] = F.pad(p["cell_gseg0"], (0, nc - c))
        p["cell_nsegs"] = F.pad(p["cell_nsegs"], (0, nc - c))
    out = {k: torch.stack([p[k] for p in pscenes]).to(device)
           for k in pscenes[0] if k != "hc"}
    out["hc"] = tuple(p["hc"] for p in pscenes)
    return out


def migrate_slots(exited: torch.Tensor, active: torch.Tensor):
    """The bank's slot migration on (L, E) bool masks -> (active after,
    moved, spawn), each (L, E). Exits from level g-1 fill the first free
    slots of group g in env order (migration moves no data, only slot
    occupancy); an exit that finds its target group full stays, to reset
    in place in its own level (the capacity fallback). The groups go in
    order: level L-1's free slots depend on what g = 0 vacated."""
    L = exited.shape[0]
    act = list(active.unbind(0))
    moved = [torch.zeros_like(exited[0])] * L
    spawn = [torch.zeros_like(exited[0])] * L
    for g in range(L if L > 1 else 0):
        src = g - 1 if g > 0 else L - 1  # exits from level g-1 land in g
        incoming = exited[src]
        free = ~act[g]
        recv = free & (torch.cumsum(free, 0) - 1 < incoming.sum())
        departed = incoming & (torch.cumsum(incoming, 0) - 1 < recv.sum())
        moved[src] = departed
        act[g] = act[g] | recv
        act[src] = act[src] & ~departed
        spawn[g] = recv
    return torch.stack(act), torch.stack(moved), torch.stack(spawn)


def _stack(trees):
    """Stack NamedTuples of tensors field by field on a new leading axis."""
    return type(trees[0])(*(torch.stack(xs) for xs in zip(*trees)))


class LevelBank:
    """Stacked scenes and per-(level, env) lockstep stepping and rendering
    on `device`: the card by default; `device="cpu"` runs the kernels'
    plain versions."""

    def __init__(self, levels: Sequence[LevelArrays], cfg, device="cuda", mesh=None):
        assert levels, "empty level bank"
        check_raster_backend(cfg.raster_backend)
        check_collision_config(cfg.player)
        self.cfg = cfg
        self.device = checked_device(device)
        padded = pad_level_arrays(levels)
        self.num_objects = padded[0].num_objects
        self.scenes = _stack([scene_from_arrays(a, self.device)[0] for a in padded])
        self.level_names = [lv.name for lv in levels]
        self.palettes = np.stack([lv.palette for lv in padded])
        self.pscenes = (stack_portal_scenes(padded, self.device)
                        if cfg.raster_backend.startswith("portal") else None)
        self.mesh = mesh

    @property
    def num_levels(self) -> int:
        return len(self.level_names)

    def reset(self, envs_per_level: int) -> SimState:
        """(L, E, ...) stacked initial states."""
        return _stack([initial_state(self._at(self.scenes, lv), self.num_objects,
                                     envs_per_level)
                       for lv in range(self.num_levels)])

    def initial_states(self, envs_per_level: int) -> SimState:
        """(L, E) stacked per-level initial states (the respawn template)."""
        return self.reset(envs_per_level)

    @staticmethod
    def _at(tree, lv: int):
        """Level `lv`'s view of a stacked Scene, SimState, Actions or
        portal-scene dict."""
        if isinstance(tree, dict):
            return {k: v[lv] for k, v in tree.items()}
        return type(tree)(*(x[lv] for x in tree))

    @torch.no_grad()
    def step(self, state: SimState, actions, scenes: Scene = None) -> SimState:
        """One tick of every level; state and actions have leading (L, E)
        axes. The level axis is unrolled: each level runs the
        single-level step on its own view."""
        scenes = self.scenes if scenes is None else scenes
        return _stack([sim_step(self._at(scenes, lv), self.cfg, self._at(state, lv),
                                self._at(actions, lv))
                       for lv in range(self.num_levels)])

    @torch.no_grad()
    def step_with_exits(self, state: SimState, active, actions, scenes: Scene = None):
        """One tick + per-env level exits on the device (ref
        game/src/level.rs:194-199: exit -> next level + full player reset,
        player.rs:119-133 / game_shaders.rs:77-96 reset time).

        Envs occupy (L, E) slots gated by the bool mask `active`. An env
        whose exit fires respawns at the NEXT level's start in a free slot
        of that level's group (`migrate_slots`). Every exit flag is
        cleared. Returns (state, active, moved): moved[l] = envs that left
        level l this tick. Counts and ranks stay tensors: nothing is read
        back. Under a mesh, the (L, E) arguments are this rank's 'dp'
        block: the masks are gathered, migrated whole and cut back."""
        state = self.step(state, actions, scenes=scenes)
        init = self.initial_states(state.pos.shape[1])
        exited = (state.exit_triggered > 0) & active  # (L, E)
        if self.mesh is None:
            act, moved, spawn = migrate_slots(exited, active)
        else:
            from ..parallel.mesh import block, gather_envs

            masks = gather_envs(torch.stack([exited, active]), self.mesh, axis=2)
            mine = block(masks.shape[2], self.mesh, "dp")
            act, moved, spawn = (m[:, mine] for m in migrate_slots(masks[0], masks[1]))
        # Receiving slots take their level's initial state; every exited
        # slot resets in place (capacity-blocked envs restart their level,
        # departed slots, now inactive, are left clean).
        fresh = spawn | exited
        state = SimState(*(
            torch.where(fresh.view(fresh.shape + (1,) * (s.dim() - 2)), i, s)
            for i, s in zip(init, state)))
        state = state._replace(exit_triggered=torch.zeros_like(state.exit_triggered))
        return state, act, moved

    @torch.no_grad()
    def render(self, state: SimState, width=None, height=None, scenes: Scene = None,
               pscenes: dict = None):
        """Render all (L, E) envs through the configured backend, one
        level at a time -> (indices (L, E, H, W) u8, covered (L, E, H, W)
        bool)."""
        outs = [self.render_level(state, lv, width, height, scenes, pscenes)
                for lv in range(self.num_levels)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    @torch.no_grad()
    def render_level(self, state: SimState, lv: int, width=None, height=None,
                     scenes: Scene = None, pscenes: dict = None):
        """Render level `lv`'s E envs of the (L, E) `state` -> (indices (E,
        H, W) u8, covered (E, H, W) bool): one level's frames, so that a
        caller reducing them as they come never holds every level's."""
        scenes = self.scenes if scenes is None else scenes
        pscenes = self.pscenes if pscenes is None else pscenes
        return render_dispatch(self._at(scenes, lv),
                               None if pscenes is None else self._at(pscenes, lv),
                               self.cfg, self._at(state, lv), width or self.cfg.width,
                               height or self.cfg.height)
