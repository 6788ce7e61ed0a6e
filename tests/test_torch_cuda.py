"""Kernels on the card against their plain PyTorch versions (marked
`cuda`; they skip without a CUDA card). This file imports neither JAX nor
the JAX package, so it also runs on the GPU machine, which has neither:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX.) chip_smoke.py runs
the full-size checks.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from trigger_scenarios import FIRING, SCENARIOS

from tpu_doom_torch.models import DoomSim as TorchSim
from tpu_doom_torch.utils.config import GameConfig


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see this file's docstring)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    """On the card: B1 and B2 bit-equal to their plain versions after a
    few main-path ticks (chip_smoke.py runs the full-size check)."""
    from tpu_doom_torch.ops import (
        player_move,
        player_move_ref,
        render_portal_fused,
        render_portal_fused_ref,
    )
    from tpu_doom_torch.render.portal import fused_inputs
    from tpu_doom_torch.sim.collision import broadphase_rows

    sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40,
                              batch_size=4, raster_backend="portal"), cuda_device)
    s = sim.reset()
    a = sim.null_actions()._replace(movement=torch.tensor(
        [[0.0, 1.0]] * 4, device=cuda_device))
    for _ in range(4):
        s = sim.step(s, a)
    rows = broadphase_rows(sim.scene, s.object_offset, s.pos)
    st8 = torch.cat([s.pos, s.vel, torch.zeros_like(s.pos[:, :2])], 1)
    kw = dict(radius=0.19, height=0.21, dt=1 / 60, substeps=4)
    assert torch.equal(player_move(rows, st8, **kw), player_move_ref(rows, st8, **kw))
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, 64, 40, s)
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)


@pytest.mark.cuda
def test_peel_resolve_matches_plain_version_on_card(cuda_device):
    """On the card: B3 equals its plain version on a pitched frame."""
    from tpu_doom_torch.ops import peel_resolve, peel_resolve_ref
    from tpu_doom_torch.render import raster as R

    sim = TorchSim(GameConfig(wad_file=":test:", batch_size=2,
                              raster_backend="auto"), cuda_device)
    s = sim.reset()._replace(
        pos=torch.tensor([[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0]], device=cuda_device),
        pitch=torch.tensor([0.3, 1e-8], device=cuda_device))
    rows, attrs, grid, yb, _ = R.peel_inputs(sim.scene, sim.config, 64, 40, s)
    got = peel_resolve(rows, attrs, grid, yb, 3, tile_p=256, chunk_t=64, width=64)
    want = peel_resolve_ref(rows, attrs, grid, yb, 3, tile_p=256, chunk_t=64)
    assert torch.equal(got, want)


def _peel_inputs(case, device):
    """(rows (2, T, 24), attrs, grid, ybounds, rows16 (2, T, 16), width,
    tile_p, chunk_t) of a case of test_peel_kernels_match_plain_versions_on_card,
    from tests/test_torch_peel.py's makers (loaded by path: this file runs
    with --noconftest)."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_peel", os.path.join(os.path.dirname(__file__), "test_torch_peel.py"))
    tp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tp)
    if case in ("test", "texstress"):
        wad = {"test": ":test:", "texstress": ":texstress:10x16"}[case]
        return (*tp.level_inputs(wad, device=device), 64, 256, 64)
    if case == "ragged":  # P fills no whole tile row, bin or run; T no whole chunk
        rows, attrs, grid, yb, rows16 = tp.level_inputs(":test:", 160, 100, device)
        return rows, attrs, grid[:, :-37], yb, rows16, 160, 1024, 48
    rows16, rows, attrs, yb = tp.synthetic_rows(0, width=160, height=100)
    if case == "invalid":
        rows16[..., 15] = 0.0
        rows[..., 15] = 0.0
    grid = tp.R.pixel_grid(160, 100, device)
    return (*(x.to(device) for x in (rows, attrs)), grid, yb.to(device),
            rows16.to(device), 160, 256, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 4, 9])
@pytest.mark.parametrize("case", ["test", "texstress", "synthetic", "ragged", "invalid"])
def test_peel_kernels_match_plain_versions_on_card(cuda_device, case, K):
    """On the card: B3 equal to its plain version, B9's ids equal and z
    bitwise, at K = 1, 3, 4 and 9 (two sweeps), on pitched views of :test:
    and :texstress:10x16 at 64x40, on tests/test_torch_peel.py's synthetic
    rows at 160x100 (ties, +-0, edges through pixel centres, arbitrary
    window-y bounds, T = 300: two row groups, six bins, two with no row),
    on a 160x100 view whose last row, bin and run are cut short with T no
    whole chunk, and on rows that are all invalid."""
    from tpu_doom_torch.ops import depth_peel, depth_peel_ref, peel_resolve, peel_resolve_ref

    rows, attrs, grid, yb, rows16, width, tile_p, chunk_t = _peel_inputs(case, cuda_device)
    got = peel_resolve(rows, attrs, grid, yb, K, tile_p, chunk_t, width=width)
    want = peel_resolve_ref(rows, attrs, grid, yb, K, tile_p, chunk_t)
    assert torch.equal(got, want)
    assert bool(want[:, :, 13].any()) == (case != "invalid")
    z, ids = depth_peel(rows16, grid, K, width=width)
    zr, idr = depth_peel_ref(rows16, grid, K)
    assert torch.equal(ids, idr) and torch.equal(z.view(torch.int32), zr.view(torch.int32))


@pytest.mark.cuda
def test_big_walk_kernels_match_plain_versions_on_card(cuda_device):
    """On the card: B4 and B6 bitwise equal to their plain versions on
    random inputs (with -0.0 and out-of-range rows), and B5 and B2's
    per-env mode on the active-set walk of :texstress:10x16."""
    from tpu_doom_torch.ops import (
        gather_cells,
        gather_cells_ref,
        render_portal_fused,
        render_portal_fused_ref,
        scatter_live,
        scatter_live_ref,
        select_rows,
        select_rows_ref,
    )
    from tpu_doom_torch.render import portal as P

    g = torch.Generator().manual_seed(0)
    tab = torch.randn((3, 448, 74), generator=g)
    tab[:, :4, :4] = -0.0
    idx = torch.randint(-2, 450, (3, 960), generator=g, dtype=torch.int32)
    tab, idx = tab.to(cuda_device), idx.to(cuda_device)
    got, want = select_rows(idx, tab), select_rows_ref(idx, tab)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    live = (torch.rand((3, 960), generator=g) < 0.3).float().to(cuda_device)
    assert torch.equal(scatter_live(idx, live, 448), scatter_live_ref(idx, live, 448))
    big = torch.randint(0, 20000, (3, 960), generator=g, dtype=torch.int32).to(cuda_device)
    # 20000 counters outgrow shared memory: the global-atomics variant.
    assert torch.equal(scatter_live(big, live, 20000), scatter_live_ref(big, live, 20000))

    sim = TorchSim(GameConfig(wad_file=":texstress:10x16", width=64, height=40,
                              batch_size=2, raster_backend="portal",
                              portal_global_segs_max=1024), cuda_device)
    s = sim.reset()._replace(yaw=torch.tensor([0.0, 2.2], device=cuda_device))
    act = P.active_segs(sim.portal_scene(), sim.config)
    _, _, aux = P.walk(sim.portal_scene(), sim.scene, sim.config, 64, 40, 24, s,
                       active_segs=act)
    meta, tex_full = aux["gather_meta"], sim.portal_scene()["tex_full"]
    assert torch.equal(gather_cells(meta, tex_full, act),
                       gather_cells_ref(meta, tex_full, act))
    args, kw, _ = P.fused_inputs(sim.portal_scene(), sim.scene, sim.config, 64, 40, s)
    assert args[8].dim() == 3
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)


# Walk cases at 64x40 on 4 envs, two of them pitched: wad, config, whether
# W2 reads B4's selection (big levels without crossing compaction; else
# the attribute table).
WALK_CASES = {
    "test": (":test:", {}, False),
    "doom2": (":doom2:", {}, False),
    "overflow": (":test:", dict(portal_compact_crossings=1), False),
    "no_compaction": (":test:", dict(portal_compact_crossings=0), False),
    "crossings12": (":test:", dict(portal_crossings=12), False),
    "small_active_set": (":test:", dict(portal_global_segs_max=64), False),
    "big": (":texstress:10x16", {}, True),
    "big_cull": (":texstress:", dict(portal_visible_segs=208), True),
    "big_select_off": (":texstress:10x16", dict(portal_select_rows="off"), False),
}


def _bitwise(a, b):
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _walk_calls(case, device):
    """The arguments the walk of WALK_CASES[case] gives W0, W1 and W2 (a
    list each, empty where it does not run) and the sim and state it
    walked."""
    from tpu_doom_torch.render import portal as P

    wad, extra, _ = WALK_CASES[case]
    sim = TorchSim(GameConfig(wad_file=wad, width=64, height=40, batch_size=4,
                              raster_backend="portal", **extra), device)
    s = sim.reset()
    a = sim.null_actions()._replace(movement=torch.tensor([[0.0, 1.0]] * 4, device=device))
    for _ in range(3):
        s = sim.step(s, a)
    s = s._replace(yaw=s.yaw + torch.tensor([0.0, 0.7, 2.1, -1.3], device=device),
                   pitch=torch.tensor([0.0, 0.3, 0.0, -0.2], device=device))
    calls = {"walk_table": [], "walk_cross": [], "walk_records": []}
    origs = {n: getattr(P, n) for n in calls}

    def spy(name):
        def f(*args):
            calls[name].append(args)
            return origs[name](*args)
        return f

    try:
        for n in calls:
            setattr(P, n, spy(n))
        act = P.active_segs(sim.portal_scene(), sim.config)
        out = P.walk(sim.portal_scene(), sim.scene, sim.config, 64, 40,
                     int(sim.config.portal_crossings), s, active_segs=act)
    finally:
        for n, f in origs.items():
            setattr(P, n, f)
    return calls, out, sim, s, act


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walk_kernels_match_plain_versions_on_card(cuda_device, case):
    """On the card: W0, W1 and W2 bit-equal to their plain versions on
    every walk branch (W0 with and without the visible-row cull, W2
    reading the table or B4's selection), and the walk on the card
    bit-equal to the plain walk on the CPU (records, words, overflow)."""
    from tpu_doom_torch.ops import (
        walk_cross,
        walk_cross_ref,
        walk_records,
        walk_records_ref,
        walk_table,
    )
    from tpu_doom_torch.render import portal as P
    from tpu_doom_torch.sim.state import SimState

    calls, (rec, words, aux), sim, s, act = _walk_calls(case, cuda_device)
    assert all(len(c) == 1 for c in calls.values())
    targs = calls["walk_table"][0]
    got, want = walk_table(*targs), P.walk_table_ref(*targs)
    assert (got[3] is None) == (want[3] is None) == (targs[10] == 0)
    assert all(_bitwise(x, y) for x, y in zip(got, want) if x is not None)
    if case == "big_cull":
        assert targs[10] == 208 and bool(got[4].any())
    got, want = walk_cross(*calls["walk_cross"][0]), walk_cross_ref(*calls["walk_cross"][0])
    assert all(_bitwise(x, y) for x, y in zip(got, want))
    args = calls["walk_records"][0]
    assert (args[16] is not None) == WALK_CASES[case][2]  # sel, B4's selection
    got, want = walk_records(*args), walk_records_ref(*args)
    assert all(_bitwise(x, y) for x, y in zip(got, want))
    cpu = TorchSim(sim.config, "cpu")
    rc, wc, auxc = P.walk(cpu.portal_scene(), cpu.scene, cpu.config, 64, 40,
                          int(cpu.config.portal_crossings),
                          SimState(*(x.cpu() for x in s)), active_segs=act)
    assert _bitwise(rec.cpu(), rc) and _bitwise(words.cpu(), wc)
    assert torch.equal(aux["overflow"].cpu(), auxc["overflow"])
    if case == "overflow":
        assert bool(aux["overflow"].any())


@pytest.mark.cuda
def test_walk_cross_rays_not_a_sweep_on_card(cuda_device):
    """W1's per-warp cull assumes the walk's rays (a sweep of fwd + right *
    x); on rays that are not one it culls nothing and stays bit-equal to
    its plain version (random rays, and the walk's rays reversed)."""
    from tpu_doom_torch.ops import walk_cross, walk_cross_ref

    calls, *_ = _walk_calls("test", cuda_device)
    cross = list(calls["walk_cross"][0])
    g = torch.Generator().manual_seed(0)
    for d in (torch.randn(cross[3].shape, generator=g).to(cuda_device),
              cross[3].flip(1).contiguous()):
        cross[3] = d
        got, want = walk_cross(*cross), walk_cross_ref(*cross)
        assert all(_bitwise(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_walk_kernels_in_captured_graph_on_card(cuda_device):
    """W1 then W2 captured in one CUDA graph: a replay gives their plain
    versions' outputs, bitwise."""
    from tpu_doom_torch.ops import walk_cross, walk_cross_ref, walk_records, walk_records_ref

    calls, *_ = _walk_calls("test", cuda_device)
    cross = calls["walk_cross"][0]
    rest = calls["walk_records"][0][7:]  # overflow, table, aw, cyw, shear, ...
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        walk_records(*walk_cross(*cross), *rest)  # warm-up, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w1 = walk_cross(*cross)
        w2 = walk_records(*w1, *rest)
    graph.replay()
    torch.cuda.synchronize()
    want1 = walk_cross_ref(*cross)
    assert all(_bitwise(x, y) for x, y in zip(w1, want1))
    want2 = walk_records_ref(*want1, *rest)
    assert all(_bitwise(x, y) for x, y in zip(w2, want2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["test", "big_cull"])
def test_walk_table_in_captured_graph_on_card(cuda_device, case):
    """W0 captured in a CUDA graph, with and without the cull: its output
    shapes are static, it reads nothing back to the host, and a replay
    gives its plain version's outputs, bitwise."""
    from tpu_doom_torch.ops import walk_table
    from tpu_doom_torch.render.portal import walk_table_ref

    calls, *_ = _walk_calls(case, cuda_device)
    targs = calls["walk_table"][0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        walk_table(*targs)  # warm-up, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = walk_table(*targs)
    graph.replay()
    torch.cuda.synchronize()
    want = walk_table_ref(*targs)
    assert all(_bitwise(x, y) for x, y in zip(got, want) if x is not None)
    assert (got[3] is None) == (case == "test")


@pytest.mark.cuda
def test_walk_cross_refuses_more_crossings_than_it_keeps(cuda_device):
    """W1 keeps at most KMAX crossings per column: a larger K raises
    rather than falling back to the eager walk."""
    from tpu_doom_torch.ops.walk import KMAX, walk_cross

    calls, *_ = _walk_calls("test", cuda_device)
    args = list(calls["walk_cross"][0])
    args[-1] = KMAX + 1
    with pytest.raises(ValueError):
        walk_cross(*args)


@pytest.mark.cuda
def test_reference_config_kernels_match_plain_versions_on_card(cuda_device):
    """On the card: B7 and B8 bit-equal to their plain versions on the
    `portal_jnp` walk of a pitched and an unpitched env, and B9 equal to
    its plain version (ids and z) on the `jnp` path's rows."""
    from tpu_doom_torch.ops import (
        classify_alpha,
        classify_alpha_ref,
        depth_peel,
        depth_peel_ref,
        pack_triangle_rows,
        shade_portal,
        shade_portal_ref,
    )
    from tpu_doom_torch.render import portal as P
    from tpu_doom_torch.render import raster as R

    sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=2,
                              raster_backend="portal_jnp"), cuda_device)
    s = sim.reset()._replace(
        pos=torch.tensor([[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0]], device=cuda_device),
        yaw=torch.tensor([0.9, 0.0], device=cuda_device),
        pitch=torch.tensor([0.3, 1e-8], device=cuda_device))
    cargs, sargs, shear, _ = P.oracle_inputs(sim.portal_scene(), sim.scene,
                                             sim.config, 64, 40, s)
    ch = classify_alpha(*cargs, shear=shear)
    assert torch.equal(ch, classify_alpha_ref(*cargs, shear=shear))
    ch = ch.reshape(2, 11, -1)
    gi, gc = shade_portal(ch, *sargs, shear=shear)
    wi, wc = shade_portal_ref(ch, *sargs, shear=shear)
    assert torch.equal(gi, wi) and torch.equal(gc, wc) and float(gc.mean()) > 0.9

    prep = R.prepare(sim.scene, sim.config, 64, 40, s)
    rows = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    grid = R.pixel_grid(64, 40, cuda_device)
    z, ids = depth_peel(rows, grid, 3, width=64)
    zr, idr = depth_peel_ref(rows, grid, 3)
    assert torch.equal(ids, idr) and torch.equal(z.view(torch.int32), zr.view(torch.int32))


@pytest.mark.cuda
def test_onehot_lookup_matches_plain_version_on_card(cuda_device):
    """On the card: B10's three variants equal `lookup_ref` on the TPU
    tool's inputs at its table size, and `smem` refuses a table above the
    card's opt-in shared memory instead of reading it another way."""
    from tpu_doom_torch.tools import onehotbench as OH

    idx, tab = OH.make_inputs(534, 3072, cuda_device)
    for variant in OH.VARIANTS:
        got = OH.lookup(idx, tab, 16, 4, variant)
        assert torch.equal(got, OH.lookup_ref(idx, tab, 16, 4, variant)), variant
    big = torch.zeros((OH.smem_optin() // 128 + 1, 128), dtype=torch.int8,
                      device=cuda_device)
    with pytest.raises(ValueError, match="opt-in"):
        OH.lookup(idx, big, 1, 1, "smem")


@pytest.mark.cuda
def test_render_portal_ablated_matches_plain_versions_on_card(cuda_device):
    """On the card: every stage-budget variant of B2 equals its plain
    version, and `full` equals the production kernel bit for bit."""
    from tpu_doom_torch.ops import render_portal_fused
    from tpu_doom_torch.render.portal import fused_inputs
    from tpu_doom_torch.tools import kernelbudget as KB

    sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=3,
                              raster_backend="portal"), cuda_device)
    s = sim.reset()._replace(yaw=torch.tensor([0.0, 1.5, 4.0], device=cuda_device))
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, 64, 40, s)
    for name, stages in KB.ABLATIONS.items():
        gi, gc = KB.render_portal_ablated(*args, **kw, ablate=stages)
        wi, wc = KB.render_portal_ablated_ref(*args, **kw, ablate=stages)
        assert torch.equal(gi, wi) and torch.equal(gc, wc), name
    pi, pc = render_portal_fused(*args, **kw)
    gi, gc = KB.render_portal_ablated(*args, **kw)
    assert gi.dtype == pi.dtype == torch.uint8
    assert torch.equal(gi, pi) and torch.equal(gc, pc)


# ---------------------------------------------------------------------------
# B4 and B2 as redesigned for Hopper: shapes off the main path's, bitwise.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 13, 74, 100])
@pytest.mark.parametrize("N", [50, 300, 301])
def test_select_rows_shapes_on_card(cuda_device, C, N):
    """On the card: B4 bitwise equal to its plain version with N below one
    tile (50), not a multiple of the tile (300) and not of 4 either (301),
    at C in {1, 13, 74, 100}, with indices out of range on both sides and
    -0.0 entries (which come out +0.0)."""
    from tpu_doom_torch.ops import select_rows, select_rows_ref

    g = torch.Generator().manual_seed(1000 * C + N)
    tab = torch.randn((3, 37, C), generator=g)
    tab[tab.abs() < 0.3] = -0.0
    idx = torch.randint(-3, 40, (3, N), generator=g, dtype=torch.int32)
    tab, idx = tab.to(cuda_device), idx.to(cuda_device)
    got, want = select_rows(idx, tab), select_rows_ref(idx, tab)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((tab.view(torch.int32) == -2**31).any())
    assert not bool((got.view(torch.int32) == -2**31).any())


@pytest.mark.cuda
def test_select_rows_refuses_what_its_tile_cannot_hold(cuda_device):
    """On the card: a C whose tile exceeds the card's opt-in shared memory
    is refused by the kernel's opt-in, through the wrapper as a raise; the
    refusal launches nothing and leaves no error behind for the next
    launch."""
    from tpu_doom_torch._build import check, load
    from tpu_doom_torch.ops import select_rows, select_rows_ref

    idx = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    tab = torch.ones((1, 4, 480), device=cuda_device)
    with pytest.raises(RuntimeError, match="select_rows launch failed: cudaError"):
        select_rows(idx, tab)
    out = torch.zeros((1, 480, 8), device=cuda_device)
    err = load().tdt_select_rows(idx.data_ptr(), tab.data_ptr(), out.data_ptr(), 1, 8,
                                 4, 480, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="cudaError"):
        check(err, "select_rows")
    torch.cuda.synchronize()
    assert not bool(out.any())
    small = tab[:, :, :74].contiguous()
    assert torch.equal(select_rows(idx, small), select_rows_ref(idx, small))


GRATE_POS = [-3.5, 1.0, -9.0]  # a view of :test:'s masked grate


@pytest.mark.cuda
@pytest.mark.parametrize("wad, width, height, extra, R, per_env", [
    (":test:", 64, 40, {}, 40, False),
    (":test:", 72, 45, {}, 40, False),
    (":doom2:", 640, 400, {}, 40, False),  # config 5's MAP01 at its size
    (":test:", 72, 45, dict(portal_compact_crossings=1), 5, False),
    (":texstress:10x16", 72, 45, {}, 120, False),
    (":texstress:10x16", 64, 40, dict(portal_global_segs_max=1024), 120, True),
    (":texstress:10x16", 72, 45, dict(portal_global_segs_max=1024), 120, True),
    (":test:", 320, 200, {}, 40, False),  # the `synth` cells' shape: 3 bands
    (":test:", 72, 250, {}, 40, False),   # 3 bands, the last ragged
    (":test:", 64, 1100, {}, 40, False),  # rows staged twice: 960, then 140
])
def test_render_portal_fused_shapes_on_card(cuda_device, wad, width, height, extra, R,
                                            per_env):
    """On the card: B2 (sky coordinates in, u8 / bool frames out) equal
    to its plain version in both table modes, at 64x40, at 72x45 (W not a
    multiple of the 32-column strip, H not of the 12-row group), at
    config 5's 640x400 on MAP01 and at 320x200 (a block walks its strip's
    5 and 3 bands), at 72x250 (a ragged last band) and at 64x1100 (the
    rows' ndc and sky staged twice), at R = 5, 40 and 120 records per
    column, with masked records on :test: (one env at the grate), pitched
    envs and sky pixels."""
    from tpu_doom_torch.ops import render_portal_fused, render_portal_fused_ref
    from tpu_doom_torch.ops.raster import MASKED_FAMILY, RECORDS_PER_CROSSING
    from tpu_doom_torch.render.portal import fused_inputs

    sim = TorchSim(GameConfig(wad_file=wad, width=width, height=height, batch_size=4,
                              raster_backend="portal", **extra), cuda_device)
    s = sim.reset()
    s = s._replace(yaw=torch.tensor([0.0, 1.5, 3.0, 4.5], device=cuda_device),
                   pitch=torch.tensor([0.0, 0.3, 0.0, -0.2], device=cuda_device))
    if wad == ":test:":
        pos = s.pos.clone()
        pos[0] = torch.tensor(GRATE_POS, device=cuda_device)
        s = s._replace(pos=pos)
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, width, height, s)
    assert args[0].shape[1] == R and (args[8].dim() == 3) == per_env
    if wad == ":test:":
        assert bool((args[0][:, MASKED_FAMILY::RECORDS_PER_CROSSING, 13] > 0.5).any())
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert (gi.dtype, gc.dtype) == (wi.dtype, wc.dtype) == (torch.uint8, torch.bool)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)
    assert float(gc.float().mean()) > 0.5


def _a_winner_a_row(args, kw, height):
    """B2's records rebuilt, in the even envs, so that record r < min(R,
    H) covers row (r + column) % H alone, with the classified channels of
    that row's pixel: each of a column's rows won by another record (or,
    past R, by none), so that B2 loads a record at every row."""
    from tpu_doom_torch._numerics import f32
    from tpu_doom_torch.ops.raster import _classify, _ndc_rows

    src, words, cam, hc = args[:4]
    W = src.shape[3]
    y, ndc0 = _ndc_rows(height, src.device)
    ch = _classify(src, words, cam[:, 1, None, None], hc, ndc0 + kw["shear"][:, None, None],
                   y, f32(args[12]), done_on_kind=False)  # (B, 11, H, W)
    records = src.clone()
    cols = torch.arange(W, device=src.device)
    for r in range(min(src.shape[1], height)):
        rows = (r + cols) % height
        records[::2, r, 2:13] = ch[::2, :, rows, cols]
        records[::2, r, 0] = rows.float()
        records[::2, r, 1] = rows.float() + 1.0
    return records


@pytest.mark.cuda
@pytest.mark.parametrize("wad, extra, R, height", [
    (":test:", {}, 40, 45),
    (":texstress:10x16", dict(portal_global_segs_max=1024, portal_crossings=8), 40, 45),
    (":texstress:10x16", {}, 120, 45),
    (":texstress:10x16", dict(portal_global_segs_max=1024), 120, 45),
    (":test:", {}, 40, 96),
    (":test:", {}, 40, 97),
    (":texstress:10x16", {}, 120, 200),
], ids=["test_rows", "texstress_rows_per_env", "texstress_rows_r120",
        "texstress_rows_r120_per_env", "test_rows_h96", "test_rows_h97",
        "texstress_rows_r120_h200"])
def test_render_portal_fused_a_winner_a_row_on_card(cuda_device, wad, extra, R, height):
    """On the card: B2 equal to its plain version where a column's winner
    changes at every row (each of its rows won by another record, or by
    none past R, the masked ones where their alpha bit is set, in half the
    envs), at R = 40 and 120, in both table modes, at 72 columns by 45
    rows, by 96 (one band) and 97 (two), and by 200 with R = 120 (three
    bands, the 120 records' rows in all three)."""
    from tpu_doom_torch.ops import render_portal_fused, render_portal_fused_ref
    from tpu_doom_torch.render.portal import fused_inputs

    width = 72
    sim = TorchSim(GameConfig(wad_file=wad, width=width, height=height, batch_size=4,
                              raster_backend="portal", **extra), cuda_device)
    s = sim.reset()
    s = s._replace(yaw=torch.tensor([0.0, 1.5, 3.0, 4.5], device=cuda_device),
                   pitch=torch.tensor([0.0, 0.3, 0.0, -0.2], device=cuda_device))
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, width, height, s)
    assert args[0].shape[1] == R and (args[8].dim() == 3) == bool(extra)
    args = (_a_winner_a_row(args, kw, height), *args[1:])
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)
    assert float(gc.float().mean()) > 0.5


@pytest.mark.cuda
def test_render_portal_fused_entry_shape_on_card(cuda_device):
    """On the card: B2 equal to its plain version at entry()'s shape (2
    envs at 64x40: two 32-column strips, rows in 12-row groups with a
    ragged last one), after a few walking ticks, one env pitched."""
    from tpu_doom_torch.entry import entry_sim
    from tpu_doom_torch.ops import render_portal_fused, render_portal_fused_ref
    from tpu_doom_torch.render.portal import fused_inputs

    sim = entry_sim(cuda_device)
    s = sim.reset()
    a = sim.null_actions()._replace(movement=torch.tensor([[0.0, 1.0]] * 2,
                                                          device=cuda_device))
    for _ in range(4):
        s = sim.step(s, a)
    s = s._replace(pitch=torch.tensor([0.0, 0.25], device=cuda_device))
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, 64, 40, s)
    assert args[0].shape[0] == 2 and args[5].shape == (2, 64) and args[6].shape == (2, 40)
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert gi.shape == (2, 40, 64) and gi.dtype == torch.uint8 and gc.dtype == torch.bool
    assert torch.equal(gi, wi) and torch.equal(gc, wc)


@pytest.mark.cuda
def test_fmod_exact_is_fmodf_on_card(cuda_device):
    """On the card: B2's remainder (csrc/portal_shade.cuh fmod_exact) is
    fmodf bit for bit over texel coordinates near every multiple of the
    texture sizes up to quotients past its fast range (2^20), over random
    values of every magnitude and sign, and over the edge values (zeros,
    subnormals, FLT_MIN, FLT_MAX, 2^126, infinities, NaN)."""
    import numpy as np

    from tpu_doom_torch._build import check, load

    rng = np.random.default_rng(0)
    f32 = np.float32
    sizes = np.concatenate([np.arange(1, 257), [0.5, 1 / 3, 7.25, 100.0, 1024.0, 4096.0],
                            rng.uniform(1e-3, 2e3, 100)]).astype(f32)
    k = np.unique(np.concatenate([np.arange(-64, 65), rng.integers(-2**21, 2**21, 100),
                                  [2**20 - 1, 2**20, 2**20 + 1, -2**20]]))
    near = (k[None, :] * sizes[:, None].astype(np.float64)).astype(f32)
    xs = [np.nextafter(near, f32(np.inf) * s).ravel() for s in (-1, 1)] + [near.ravel()]
    xs += [np.nextafter(xs[0], -f32(np.inf)), np.nextafter(xs[1], f32(np.inf))]
    x_near = np.concatenate(xs)
    y_near = np.tile(np.repeat(sizes, k.size), 5)
    sign = rng.choice([-1.0, 1.0], size=(2, 2_000_000))
    mag = 10.0 ** rng.uniform(-45, 38.5, size=(2, 2_000_000))
    x_rand, y_rand = (sign * mag).astype(f32)
    x_walk = rng.uniform(-2e6, 2e6, 2_000_000).astype(f32)
    y_walk = rng.choice(np.concatenate([[8, 16, 32, 64, 128, 256],
                                        rng.uniform(0.5, 300, 64)]).astype(f32), x_walk.size)
    tiny, fmin, fmax = np.float32(1e-45), np.finfo(f32).tiny, np.finfo(f32).max
    edge = np.array([0.0, -0.0, tiny, -tiny, fmin, -fmin, 1.0, -1.0, 3.0, fmax, -fmax,
                     2.0**126, 2.0**127, 2.0**20, np.inf, -np.inf, np.nan], f32)
    x_edge, y_edge = (a.ravel() for a in np.meshgrid(edge, edge))
    x = np.concatenate([x_near, -x_near, x_rand, x_walk, x_edge]).astype(f32)
    y = np.concatenate([y_near, -y_near, y_rand, y_walk, y_edge]).astype(f32)
    xt, yt = torch.as_tensor(x, device=cuda_device), torch.as_tensor(y, device=cuda_device)
    fast, ref = torch.empty_like(xt), torch.empty_like(xt)
    check(load().tdt_fmod_check(xt.data_ptr(), yt.data_ptr(), fast.data_ptr(),
                                ref.data_ptr(), x.size,
                                torch.cuda.current_stream().cuda_stream), "fmod_check")
    bad = (fast.view(torch.int32) != ref.view(torch.int32)).nonzero().flatten()[:5].cpu()
    assert bad.numel() == 0, [(x[i], y[i], float(fast[i]), float(ref[i])) for i in bad]


# ---------------------------------------------------------------------------
# B1 and B10 as redesigned for Hopper: shapes off the main path's, bitwise.
# ---------------------------------------------------------------------------


def _random_rows(rng, B, M):
    """(B, 13, M) rows of random triangles around the origin (unit
    normals of the triangles' planes, a few masked out) and (B, 8) states
    with random positions and velocities, from numpy's generator."""
    import numpy as np

    v = rng.uniform(-1.5, 1.5, (B, M, 3, 3)).astype(np.float32)
    n = np.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
    mask = (rng.random((B, M)) > 0.1).astype(np.float32)
    rows = np.concatenate([v.reshape(B, M, 9), n, mask[..., None]], -1).transpose(0, 2, 1)
    st8 = np.zeros((B, 8), np.float32)
    st8[:, :3] = rng.uniform(-0.5, 0.5, (B, 3))
    st8[:, 3:6] = rng.uniform(-60.0, 60.0, (B, 3))
    return (torch.as_tensor(np.ascontiguousarray(rows, dtype=np.float32)),
            torch.as_tensor(st8))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 33, 102, 300])
def test_player_move_random_triangles_on_card(cuda_device, M):
    """On the card: B1 bitwise equal to its plain version on random
    triangles, B = 5 envs, M = 1, 33, 102 and 300 (above one thread group
    of 128), 4 substeps, noclip probe on and off."""
    import numpy as np

    from tpu_doom_torch.ops import player_move, player_move_ref

    rows, st8 = _random_rows(np.random.default_rng(M), 5, M)
    rows, st8 = rows.to(cuda_device), st8.to(cuda_device)
    for noclip in (True, False):
        kw = dict(radius=0.19, height=0.21, dt=1.0 / 60.0, substeps=4,
                  enable_noclip=noclip)
        got, want = player_move(rows, st8, **kw), player_move_ref(rows, st8, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), noclip
    if M > 1:
        assert bool(torch.isfinite(want[:, 0]).any())  # some sweeps hit


@pytest.mark.cuda
@pytest.mark.parametrize("enable_noclip", [True, False])
def test_player_move_walls_on_card(cuda_device, enable_noclip):
    """On the card: B1 bitwise equal to its plain version on :test:'s
    poses driven into walls, which stay blocked for 2-4 of 4 substeps
    (tests/test_torch_smoke.py), beside 16 ordinary poses."""
    from test_torch_smoke import MOVE_KW, _move_inputs

    from tpu_doom_torch.ops import player_move, player_move_ref

    rows, st8 = (x.to(cuda_device) for x in _move_inputs())
    kw = dict(MOVE_KW, substeps=4, enable_noclip=enable_noclip)
    got, want = player_move(rows, st8, **kw), player_move_ref(rows, st8, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4097])
def test_onehot_lookup_shapes_on_card(cuda_device, n, offset):
    """On the card: B10's three variants equal `lookup_ref` at n = 1, 3
    and 4097 (a ragged last quad), on idx at its allocation and on a view
    offset by 4 bytes (not 16-byte aligned: the scalar path), with one
    row and with several (rows not 16-byte aligned when n % 4 != 0),
    indices out of the table on both sides included."""
    from tpu_doom_torch.tools import onehotbench as OH

    g = torch.Generator().manual_seed(n + offset)
    S = 534
    base = torch.randint(-300, S * 128 + 300, (1, n + offset), generator=g,
                         dtype=torch.int32).to(cuda_device)
    idx = base[:, offset:]
    assert (idx.data_ptr() % 16 != 0) == bool(offset)
    tab = torch.randint(-128, 128, (S, 128), generator=g, dtype=torch.int8).to(cuda_device)
    for iters, grid in ((1, 1), (3, 5)):
        for variant in OH.VARIANTS:
            got = OH.lookup(idx, tab, iters, grid, variant)
            want = OH.lookup_ref(idx, tab, iters, grid, variant)
            assert torch.equal(got, want), (variant, iters, grid)


def _walk_idx(rng, B, K, W, S):
    """Seg ids in the walk's layout: K layers of W columns, W innermost,
    each layer runs of one seg over neighbouring columns, -1 and S (no
    seg) among them."""
    idx = np.empty((B, K, W), np.int32)
    for b in range(B):
        for k in range(K):
            cuts = np.sort(rng.choice(np.arange(1, W), rng.integers(3, 40), replace=False))
            segs = rng.integers(-1, S + 1, len(cuts) + 1)
            idx[b, k] = np.repeat(segs, np.diff(np.r_[0, cuts, W]))
    return idx.reshape(B, K * W)


SCATTER_CASES = ["walk", "same", "random", "ragged", "global"]


def scatter_live_case(name):
    """(idx (B, N) i32, live (B, N) f32, S) of a B6 case: the walk's
    (256, 7680) into 448 with 0/1 live values; every idx equal (the worst
    contention); random idx with negative and out-of-range values and
    live values 0-3 (no warp holds only 0/1, so the kernel adds per lane);
    N % 4 != 0 (rows off 16 bytes: the scalar head and tail); S above
    the shared-memory limit (the global-atomics kernel)."""
    rng = np.random.default_rng(SCATTER_CASES.index(name))
    if name == "walk":
        idx, S = _walk_idx(rng, 256, 24, 320, 448), 448
    elif name == "same":
        idx, S = np.full((256, 7680), 7, np.int32), 448
    elif name == "random":
        idx, S = rng.integers(-60, 500, (8, 1000)).astype(np.int32), 448
    elif name == "ragged":
        idx, S = rng.integers(-3, 450, (5, 7683)).astype(np.int32), 448
    else:
        idx, S = rng.integers(-5, 20005, (3, 3001)).astype(np.int32), 20000
    live = (rng.random(idx.shape) < 0.6).astype(np.float32)
    if name == "random":
        live *= rng.integers(1, 4, idx.shape)
    return idx, live, S


@pytest.mark.parametrize("name", SCATTER_CASES)
def test_scatter_live_ref_is_bincount(name):
    """B6's plain version equals numpy's bincount on every card case."""
    from tpu_doom_torch.ops import scatter_live_ref

    idx, live, S = scatter_live_case(name)
    got = scatter_live_ref(torch.as_tensor(idx), torch.as_tensor(live), S).numpy()
    ok = (idx >= 0) & (idx < S)
    want = np.stack([np.bincount(i[o], weights=v[o], minlength=S)
                     for i, v, o in zip(idx, live, ok)]).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCATTER_CASES)
def test_scatter_live_cases_on_card(cuda_device, name):
    """On the card: B6 bitwise equal to `scatter_live_ref` on each case."""
    from tpu_doom_torch.ops import scatter_live, scatter_live_ref

    idx, live, S = (torch.as_tensor(x).to(cuda_device) if isinstance(x, np.ndarray) else x
                    for x in scatter_live_case(name))
    got, want = scatter_live(idx, live, S), scatter_live_ref(idx, live, S)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


ROLLOUT_CASES = {
    "portal": (":test:", {}),
    "fallback": (":test:", dict(portal_pitch="triangle")),
    "portal_jnp_fallback": (":test:", dict(raster_backend="portal_jnp",
                                           portal_pitch="triangle")),
    "chunked": (":test:", dict(render_env_chunk=2)),
    "texstress_active_set": (":texstress:10x16", dict(portal_global_segs_max=1024)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_rollout_replays_equal_eager_ticks_on_card(cuda_device, case):
    """On the card: rollout (captured graphs, replayed) equals a loop of
    eager step_render bitwise, frames and state, with render_every 1 and
    2; half the envs pitched where the fallback is on. A second rollout
    only replays: each replay adds its launches to the counts."""
    from tpu_doom_torch.ops import launch_counts, reset_launch_counts
    from tpu_doom_torch.sim.state import Actions

    wad, extra = ROLLOUT_CASES[case]
    sim = TorchSim(GameConfig(wad_file=wad, width=64, height=40, batch_size=4,
                              raster_backend=extra.pop("raster_backend", "portal"),
                              **extra), cuda_device)
    s0 = sim.reset()
    s0 = s0._replace(pitch=torch.tensor([0.3, 1e-8, -0.2, 1e-8], device=cuda_device))
    g = torch.Generator().manual_seed(1)
    n = 5
    off = torch.zeros((n, 4), dtype=torch.bool)
    seq = Actions(movement=torch.rand((n, 4, 2), generator=g) * 2 - 1,
                  look=torch.rand((n, 4, 2), generator=g) * 0.1 - 0.05, jump=off,
                  fly_toggle=off, clip_toggle=off,
                  push=torch.rand((n, 4), generator=g) < 0.3, shoot=off)
    seq = Actions(*(x.to(cuda_device) for x in seq))
    for every in (1, 2):
        state, frames = sim.rollout(s0, seq, n, render_every=every)
        s, want = s0, []
        for t in range(n):
            s, idx, _ = sim.step_render(s, Actions(*(x[t] for x in seq)))
            if (t + 1) % every == 0 and t < n - n % every:
                want.append(idx)
        assert torch.equal(frames, torch.stack(want)), every
        assert all(torch.equal(a, b) for a, b in zip(state, s)), every
    reset_launch_counts()
    sim.rollout(s0, seq, n)
    counts = launch_counts()
    assert counts["player_move"] == n
    if case == "texstress_active_set":
        assert counts["scatter_live"] == n and counts["gather_cells"] == n
    if case in ("fallback", "portal_jnp_fallback"):
        peel = "depth_peel" if case == "portal_jnp_fallback" else "peel_resolve"
        assert counts[peel] == n  # some env falls back on every tick


@pytest.mark.cuda
@pytest.mark.parametrize("pitched", [1, 3], ids=["within_budget", "over_budget"])
def test_rollout_fallback_budget_on_card(cuda_device, monkeypatch, pitched):
    """On the card, with fallback blocks of two envs: rollout replays
    equal eager ticks bitwise where one env falls (the WHILE node's body
    runs once per tick) and where three do (twice), and the graph holds
    one conditional body."""
    from tpu_doom_torch.ops import launch_counts, reset_launch_counts
    from tpu_doom_torch.render import portal as P

    monkeypatch.setattr(P, "FALLBACK_ENVS", 2)
    sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=4,
                              raster_backend="portal", portal_pitch="triangle"),
                   cuda_device)
    s0 = sim.reset()
    pitch = torch.full((4,), 1e-8, device=cuda_device)
    pitch[:pitched] = 0.3
    s0 = s0._replace(pitch=pitch)
    state, frames = sim.rollout(s0, None, 3)
    s, want = s0, []
    for _ in range(3):
        s, idx, _ = sim.step_render(s, sim.null_actions())
        want.append(idx)
    assert torch.equal(frames, torch.stack(want))
    assert all(torch.equal(a, b) for a, b in zip(state, s))
    tick = sim.tick_graphs().ticks[("render", 4, 64, 40)]
    assert len(tick.bodies) == 1
    reset_launch_counts()
    sim.rollout(s0, None, 3)
    assert launch_counts()["peel_resolve"] == 3 * (1 if pitched == 1 else 2)


@pytest.mark.cuda
def test_rollout_capture_failure_raises(cuda_device):
    """On the card: a tick that reads back to the host cannot be captured,
    and rollout raises rather than running eagerly. In a process of its
    own: a failed capture leaves the allocator unusable."""
    code = (
        "import tpu_doom_torch.models.doom_sim as D\n"
        "from tpu_doom_torch.utils.config import GameConfig\n"
        "step = D.sim_step\n"
        "D.sim_step = lambda sc, cfg, s, a: (float(s.pos.sum()), step(sc, cfg, s, a))[1]\n"
        "sim = D.DoomSim(GameConfig(wad_file=':test:', width=64, height=40, batch_size=2))\n"
        "try:\n"
        "    sim.rollout(sim.reset(), None, 2)\n"
        "except RuntimeError as e:\n"
        "    print('raised', str(e).splitlines()[0])\n"
        "else:\n"
        "    print('ran')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert "raised" in out.stdout and "ran" not in out.stdout, out.stdout + out.stderr


def test_every_entry_point_is_bound():
    """Each `extern "C"` entry point of csrc/ has argument types in
    `_build.SIGNATURES`, as many as its parameters: without them ctypes
    passes every Python int as a C int and cuts pointers to 32 bits."""
    import re

    from tpu_doom_torch import _build

    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (tdt_\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {k: len(v) for k, v in _build.SIGNATURES.items()}


def _bank(specs, device, **kw):
    """A LevelBank of (wad, level) specs at 64x40."""
    from tpu_doom_torch.tools.banks import make_bank

    return make_bank(specs, device, width=64, height=40, **kw)


CONFIG5 = ((":test:", 0), (":test:", 1), (":doom2:", 0), (":doom2:", 1))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["portal", "portal_jnp"])
def test_bank_replays_equal_eager_ticks_on_card(cuda_device, backend):
    """On the card: config 5's four members, 4 envs each, the bank tick
    (step_with_exits, then every level's render) captured as one CUDA
    graph and replayed equals eager ticks bitwise in state, active mask
    and frames; an env parked at E1M1's exit switch migrates to E1M2's
    group on the device, and half the envs are pitched under
    portal_pitch="triangle" so that every level's fallback WHILE node runs."""
    from tpu_doom_torch.graphs import CapturedTick
    from tpu_doom_torch.sim.state import Actions, SimState, null_actions

    bank = _bank(CONFIG5, cuda_device, raster_backend=backend, portal_pitch="triangle")
    L, E = bank.num_levels, 4
    s = bank.reset(E)
    pos, pitch = s.pos.clone(), s.pitch.clone()
    pos[0, 0] = torch.tensor([-2.56, 0.68, -14.7])
    pitch[:, :2] = 0.3
    s = s._replace(pos=pos, pitch=pitch)
    active = torch.ones((L, E), dtype=torch.bool, device=cuda_device)
    active[1, 2:] = False
    push = torch.zeros((L, E), dtype=torch.bool, device=cuda_device)
    push[0, 0] = True
    acts = Actions(*(x.reshape((L, E) + x.shape[1:]) for x in null_actions(L * E, cuda_device)))
    acts = acts._replace(push=push)

    def tick(carry, a):
        st, act = carry
        st, act, _ = bank.step_with_exits(st, act, a)
        return (st, act), bank.render(st)[0]

    carry = (SimState(*(x.clone() for x in s)), active.clone())
    graph = CapturedTick(tick, carry, Actions(*(x.clone() for x in acts)))
    assert len(graph.bodies) == L
    for t in range(3):
        (s, active), frames = tick((s, active), acts)
        graph.replay()
        assert torch.equal(graph.outs[0], frames), t
        assert torch.equal(carry[1], active), t
        assert all(torch.equal(a, b) for a, b in zip(carry[0], s)), t
    assert not bool(active[0, 0]) and int(active[1].sum()) == 3  # the env moved


@pytest.mark.cuda
def test_bank_padded_hole_table_on_card(cuda_device):
    """On the card: a bank of E1M1 (holes, 534 texel rows) and
    :texstress:6x24 (holeless, 1,353 rows) under portal_jnp: B8 takes the
    padded hole table (ceil(1,353 / 8) rows) and each level renders as
    it does alone."""
    bank = _bank(((":test:", 0), (":texstress:6x24", 0)), cuda_device,
                 raster_backend="portal_jnp")
    assert tuple(bank.pscenes["hole_bytes"].shape) == (2, 170, 128)
    s = bank.reset(2)
    s = s._replace(yaw=torch.tensor([[0.0, 2.0], [1.0, 4.0]], device=cuda_device))
    idx, cov = bank.render(s)
    for lv, wad in enumerate((":test:", ":texstress:6x24")):
        sim = TorchSim(GameConfig(wad_file=wad, width=64, height=40, batch_size=2,
                                  raster_backend="portal_jnp"), cuda_device)
        i1, c1 = sim.render(type(s)(*(x[lv] for x in s)))
        assert torch.equal(i1, idx[lv]) and torch.equal(c1, cov[lv]), wad


@pytest.mark.cuda
def test_legacy_step_on_card(cuda_device):
    """On the card: the `legacy` oracle's 150-tick trajectory stays within
    the drift ceiling (1e-3) of B1's path, and its brute force equals its
    broad phase bitwise."""
    from tpu_doom_torch.utils.config import PlayerConfig

    sims = [TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=8,
                                player=PlayerConfig(**pk)), cuda_device)
            for pk in ({}, dict(collision_backend="legacy"),
                       dict(collision_backend="legacy", collision_broadphase=False))]
    g = torch.Generator().manual_seed(2)
    a = sims[0].null_actions()._replace(
        movement=(torch.rand((8, 2), generator=g) * 2 - 1).to(cuda_device),
        look=(torch.rand((8, 2), generator=g) * 0.1 - 0.05).to(cuda_device))
    states = [sim.reset() for sim in sims]
    drift = 0.0
    for _ in range(150):
        states = [sim.step(s, a) for sim, s in zip(sims, states)]
        drift = max(drift, float((states[1].pos - states[0].pos).abs().max()))
        assert all(torch.equal(x, y) for x, y in zip(states[1], states[2]))
    assert drift <= 1e-3, drift


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sim", "bank"])
def test_bench_replays_equal_eager_ticks_on_card(cuda_device, which):
    """On the card: tpu_doom_torch.bench's timing (its tick captured as one
    graph, 1 warm-up replay, 3 timed) ends bitwise where 4 eager ticks
    end, checksum included: bench.py's tick on :test: with a pitched env
    on the triangle fallback, and bank_main's tick on config 5's members."""
    from tpu_doom_torch import bench
    from tpu_doom_torch.utils.config import PlayerConfig

    zero = torch.zeros((), dtype=torch.int64, device=cuda_device)
    if which == "sim":
        sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=4,
                                  raster_backend="portal", portal_pitch="triangle",
                                  player=PlayerConfig(clip_substeps=4)), cuda_device)
        s = sim.reset()
        s = s._replace(pitch=torch.tensor([1e-8, 0.3, 1e-8, 1e-8], device=cuda_device))
        tick, start, acts = bench.sim_tick(sim, 64, 40), (s, zero), bench.bench_actions(sim, 4)
    else:
        bank = _bank(CONFIG5, cuda_device)
        L, E = bank.num_levels, 4
        start = (bank.reset(E), torch.ones((L, E), dtype=torch.bool, device=cuda_device), zero)
        tick, acts = bench.bank_check_tick(bank, 64, 40), bench.bank_actions(L, E, cuda_device)
    carry = tuple(type(x)(*(y.clone() for y in x)) if isinstance(x, tuple) else x.clone()
                  for x in start)
    timing = bench.time_ticks(tick, carry, acts, 3, warmup=1)
    with torch.no_grad():
        for _ in range(4):
            (start,) = tick(start, acts)
    for got, want in zip(timing.state, start):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(timing.state[-1]) > 0 and timing.launches["player_move"] >= 3


@pytest.mark.cuda
def test_captured_tick_keeps_what_its_tick_reads(cuda_device):
    """On the card: a captured bank tick whose bank the caller dropped
    replays bitwise its eager tick after a second bank was built (the
    graph keeps its tick, and so the bank's scenes it reads; before it
    did, the second bank took the freed memory and the replay read out of
    bounds). In a process of its own: a graph reading freed memory may
    crash it."""
    code = (
        "import torch\n"
        "from tpu_doom_torch.bench import bank_actions, bank_tick\n"
        "from tpu_doom_torch.tools.banks import make_bank\n"
        "from tpu_doom_torch.tools.fixtures import capture_bank_tick\n"
        f"specs = {CONFIG5!r}\n"
        "def captured():\n"
        "    bank = make_bank(specs, width=64, height=40)\n"
        "    L, E = bank.num_levels, 4\n"
        "    s, a = bank.reset(E), torch.ones((L, E), dtype=torch.bool, device='cuda')\n"
        "    acts = bank_actions(L, E)\n"
        "    graph = capture_bank_tick(bank, s, a, acts, 64, 40)\n"
        "    with torch.no_grad():\n"
        "        return graph, bank_tick(bank, 64, 40)((s, a), acts)\n"
        "graph, ((s, a), frames) = captured()\n"
        "other = make_bank(specs[::-1], width=64, height=40)\n"
        "graph.replay()\n"
        "torch.cuda.synchronize()\n"
        "print('same', torch.equal(graph.outs[0], frames)\n"
        "      and torch.equal(graph.state_buf[1], a)\n"
        "      and all(torch.equal(x, y) for x, y in zip(graph.state_buf[0], s)))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and "same True" in out.stdout, out.stdout + out.stderr[-3000:]


@pytest.mark.cuda
def test_cos_sin_bitwise_on_card_and_cpu(cuda_device):
    """On the card: the camera's trig (`_numerics.cos_sin`, float64
    rounded once to float32) gives the CPU's bits over a sweep of
    angles: every f32 in [-4 pi, 4 pi] at a stride, the verify poses'
    yaws and pitches, and the edges."""
    from tpu_doom_torch._numerics import cos_sin
    from tpu_doom_torch.bench import _golden

    sweep = torch.linspace(-4 * np.pi, 4 * np.pi, 1_000_003, dtype=torch.float32)
    ref = _golden("verify_texstress_ref.npz")
    x = torch.cat([sweep, torch.as_tensor(ref["yaw"]).flatten(),
                   torch.as_tensor(ref["pitch"]).flatten(),
                   torch.tensor([0.0, -0.0, 1e-8, np.pi / 2, np.pi, 1e4, -1e4])])
    for got, want in zip(cos_sin(x.to(cuda_device)), cos_sin(x)):
        assert got.dtype == torch.float32 and torch.equal(got.cpu(), want)


def _sharded_dp1_ticks():
    """A rank of a world of one NCCL rank: dryrun_multichip's main-leg
    tick (with its mean_metric) and bank tick (an exit migrating through
    the bank's all-gather) under a (1, 1) mesh at 64x40, captured and
    replayed twice against two eager ticks -> {leg: bitwise equal, leg
    + "_moved": whether an env migrated}."""
    from tpu_doom_torch.entry import dryrun_bank, entry_sim, spread_yaw
    from tpu_doom_torch.graphs import CapturedTick
    from tpu_doom_torch.parallel import make_mesh, mean_metric
    from tpu_doom_torch.parallel.mesh import mesh_device
    from tpu_doom_torch.render import render_dispatch
    from tpu_doom_torch.sim.state import Actions, null_actions
    from tpu_doom_torch.sim.step import step as sim_step

    mesh = make_mesh(1, 1)
    dev = mesh_device(mesh)
    sim = entry_sim(dev, 64, 40, 2, crossings=8)
    pscene = sim.portal_scene()

    def main_tick(s, a):
        s = sim_step(sim.scene, sim.config, s, a)
        frames, cov = render_dispatch(sim.scene, pscene, sim.config, s, 64, 40)
        return s, frames, mean_metric(cov, mesh)

    bank = dryrun_bank(64, 40, dev, mesh)
    bstate = spread_yaw(bank.reset(4))
    pos = bstate.pos.clone()
    pos[0, 0] = torch.tensor([-2.56, 0.68, -14.7])  # E1M1's exit switch, unturned
    bstate = bstate._replace(pos=pos)
    active = torch.tensor([[True] * 4, [False, False, True, True]], device=dev)
    bacts = Actions(*(x.reshape((2, 4) + x.shape[1:]) for x in null_actions(8, dev)))
    push = bacts.push.clone()
    push[0, 0] = True
    bacts = bacts._replace(push=push)

    def bank_tick(carry, a):
        s, act = carry
        s, act, moved = bank.step_with_exits(s, act, a)
        return (s, act), bank.render(s, 64, 40)[0], moved

    def leaves(x):
        return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in leaves(y)]

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return (type(x)(*map(clone, x)) if hasattr(x, "_fields") else tuple(map(clone, x)))

    out = {}
    for leg, tick, start, acts in (
            ("main", main_tick, spread_yaw(sim.reset(2)), sim.null_actions(2)),
            ("bank", bank_tick, (bstate, active), bacts)):
        graph = CapturedTick(tick, clone(start), acts)
        same, moved_any = True, False
        for _ in range(2):
            with torch.no_grad():
                start, *outs = tick(start, acts)
            graph.replay()
            want, got = leaves((start, outs)), leaves((graph.state_buf, graph.outs))
            same = same and len(want) == len(got) and all(
                torch.equal(a, b) for a, b in zip(want, got))
            moved_any = moved_any or (leg == "bank" and bool(outs[1].any()))
        out[leg], out[leg + "_moved"] = same, moved_any
    return out


@pytest.mark.cuda
def test_sharded_tick_replays_equal_eager_ticks_at_dp1(cuda_device):
    """On the card, in a world of one NCCL rank: the dry run's main-leg
    and bank ticks under a (1, 1) mesh, captured with their collectives
    (mean_metric's all-reduce, the exit migration's all-gather) and
    replayed, bitwise their eager ticks; an exit migrates."""
    from tpu_doom_torch.parallel import launch

    (out,) = launch(1, _sharded_dp1_ticks)
    assert out == {"main": True, "main_moved": False, "bank": True, "bank_moved": True}


def _fallback_sim(device):
    """:test: at 64x40, 4 envs, two pitched under portal_pitch="triangle":
    the fallback's WHILE node runs every rendered tick."""
    sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=4,
                              raster_backend="portal", portal_pitch="triangle"), device)
    s0 = sim.reset()
    return sim, s0._replace(pitch=torch.tensor([0.3, 1e-8, -0.2, 1e-8], device=device))


@pytest.mark.cuda
def test_untraced_capture_has_the_nodes_of_one_without_trace(cuda_device, monkeypatch):
    """On the card: a tick captured with tracing off, before any counter
    of `trace` is made, has the top-level node count of one captured with
    every span and count of `trace` replaced by nothing, as before tracing
    existed; the untraced graph of a tick captured while tracing is on has
    that of one with the spans alone replaced (made counters count in
    every graph), so no stamp leaks into it; tracing on replays a traced
    twin whose frames and state equal the untraced graph's bitwise, and
    which stamps."""
    import contextlib
    import ctypes
    import functools

    from tpu_doom_torch import trace
    from tpu_doom_torch.graphs import CapturedTick

    monkeypatch.setattr(trace, "_counters", {})  # none made yet
    # Keep each capture's cudaGraph_t (`raw_cuda_graph`) to count its nodes.
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        functools.partial(torch.cuda.CUDAGraph, keep_graph=True))
    sim, s0 = _fallback_sim(cuda_device)
    graphs = sim.tick_graphs()

    def tick(s, a):
        s = graphs.step(s, a)
        return s, graphs.render(s, 64, 40)

    def capture():
        return CapturedTick(tick, type(s0)(*(x.clone() for x in s0)), sim.null_actions())

    def nodes(t):
        n = ctypes.c_size_t()
        rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(t.graph.raw_cuda_graph()), None, ctypes.byref(n))
        assert rc == 0, f"cuGraphGetNodes: CUresult {rc}"
        return n.value

    def spanless(m):
        for name in ("span", "host_span", "tick_span"):
            m.setattr(trace, name, lambda *a, **k: contextlib.nullcontext())

    with monkeypatch.context() as m:
        spanless(m)
        m.setattr(trace, "count", lambda *a, **k: None)
        before = nodes(capture())
    off = capture()
    assert nodes(off) == before, (before, nodes(off))
    trace.enable(cuda_device)
    try:
        with monkeypatch.context() as m:
            spanless(m)
            counted = nodes(capture())
        on = capture()
        assert nodes(on) == counted > before, (before, counted, nodes(on))
        trace.disable()
        off.replay()
        want = [x.clone() for x in (*off.state_buf, off.outs[0])]
        trace.enable(cuda_device)
        on.replay()
        got = [*on.state_buf, on.outs[0]]
        assert on.outs is not on._plain.outs  # the twin's
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rec = trace.spans()
        names = [s.name for s in rec.spans]
        for name in ("tick", "step", "player", "render", "walk", "raster", "fallback",
                     "host.replay"):
            assert names.count(name) == 1, (name, names)
        assert trace.counts()["overflow_envs"] == 2
    finally:
        trace.disable()


def _w0_args(sim, s, width, height):
    """The arguments the port's walk of state `s` gives W0."""
    from tpu_doom_torch.render import portal as P

    calls, walk_table = [], P.walk_table

    def spied(*args):
        calls.append(args)
        return walk_table(*args)

    P.walk_table = spied
    try:
        P.walk(sim.portal_scene(), sim.scene, sim.config, width, height,
               int(sim.config.portal_crossings), s,
               active_segs=P.active_segs(sim.portal_scene(), sim.config))
    finally:
        P.walk_table = walk_table
    (args,) = calls
    return args


@pytest.mark.cuda
def test_big_level_visible_rows_and_traced_tick_on_card(cuda_device, monkeypatch):
    """On the card at the :texstress: shape (256 envs at 320x200, 600 walk
    rows culled to 448): W0's outputs, its count of visible rows with
    them, bitwise its plain version's; a tick captured untraced and its
    traced twin give the same state and frames bitwise; the twin opens
    `select` once, under `walk`, and counts the visible rows and cull
    overflows of the plain cull of the state it rendered."""
    import math

    from tpu_doom_torch import trace
    from tpu_doom_torch.graphs import CapturedTick
    from tpu_doom_torch.ops import walk_table
    from tpu_doom_torch.render.portal import walk_table_ref

    W, H, B = 320, 200, 256
    sim = TorchSim(GameConfig(wad_file=":texstress:", width=W, height=H, batch_size=B,
                              raster_backend="portal"), cuda_device)
    s0 = sim.reset()
    s0 = s0._replace(yaw=torch.arange(B, dtype=torch.float32, device=cuda_device)
                     * (2 * math.pi / B))
    targs = _w0_args(sim, s0, W, H)
    got, want = walk_table(*targs), walk_table_ref(*targs)
    assert targs[10] == 448 and got[0].shape == (B, 448, 74)
    assert all(_bitwise(x, y) for x, y in zip(got, want))
    assert got[5].dtype == torch.int32 and bool((got[5] > 0).any())

    monkeypatch.setattr(trace, "_counters", {})  # none made yet
    graphs = sim.tick_graphs()

    def tick(s, a):
        s = graphs.step(s, a)
        return s, graphs.render(s, W, H)

    def capture():
        return CapturedTick(tick, type(s0)(*(x.clone() for x in s0)), sim.null_actions())

    off = capture()
    trace.enable(cuda_device)
    try:
        on = capture()
        trace.disable()
        off.replay()
        want = [x.clone() for x in (*off.state_buf, off.outs[0])]
        trace.enable(cuda_device)
        on.replay()
        got = [*on.state_buf, on.outs[0]]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rec = trace.spans()
        selects = [s for s in rec.spans if s.name == "select"]
        assert len(selects) == 1 and rec.spans[selects[0].parent].name == "walk"
        counts = trace.counts()
    finally:
        trace.disable()
    _, _, _, _, overflow, n_vis = walk_table_ref(
        *_w0_args(sim, type(s0)(*on.state_buf), W, H))
    assert counts["visible_rows"] == int(n_vis.sum()) > 0
    assert counts["cull_overflow_envs"] == int(overflow.sum())


@pytest.mark.cuda
def test_stamps_lie_inside_their_kernels_in_a_profiler_trace(cuda_device):
    """On the card: every device stamp of a traced rollout, mapped onto the
    host clock by the calibrated offset, lies inside its own stamp
    kernel's interval in a torch.profiler trace of the same ticks, mapped
    onto the host clock by the trace's own start time, each widened by
    the calibration's error bound (and the trace's microsecond ticks)."""
    from tpu_doom_torch import trace

    sim, s0 = _fallback_sim(cuda_device)
    trace.enable(cuda_device)
    try:
        sim.rollout(s0, None, 2)  # captures the twins
        torch.cuda.synchronize()
        trace.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            sim.rollout(s0, None, 4, render_every=2)
            torch.cuda.synchronize()
        rec = trace.spans()
    finally:
        trace.disable()
    stamps = sorted(t for s in rec.spans if not s.name.startswith(trace.HOST)
                    for t in (s.start_ns, s.end_ns))
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "trace_stamp_kernel" in e.name)
    assert len(stamps) == len(kernels) > 0, (len(stamps), len(kernels))
    base = trace_start_monotonic_ns(prof)
    slack = rec.error_ns + 1000  # the trace's times are whole microseconds
    outside = [(t, a, b) for t, (a, b) in zip(stamps, kernels)
               if not base + a * 1000 - slack <= t <= base + b * 1000 + slack]
    assert not outside, (rec.error_ns, outside[:5])


def trace_start_monotonic_ns(prof) -> int:
    """The profiler trace's time zero on the host's CLOCK_MONOTONIC: its
    start (wall-clock ns) less the wall clock's lead over the monotonic
    one."""
    import time

    lead = min((time.time_ns() - time.monotonic_ns()) for _ in range(16))
    return prof.profiler.kineto_results.trace_start_ns() - lead


# ---------------------------------------------------------------------------
# S1 and S2, the step's kernels around B1: bitwise their plain versions,
# three kernel nodes a level.
# ---------------------------------------------------------------------------

# case: (wad, level); "_no_triggers" drops the level's triggers and effect
# definitions (K = D = 0).
STEP_LEVELS = {
    "test0": (":test:", 0),
    "doom2_0": (":doom2:", 0),
    "doom2_1": (":doom2:", 1),
    "test0_no_triggers": (":test:", 0),
}
STEP_TICKS = 64
KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


def _step_sim(case, B, device, **player):
    """(sim, scene, reset state) of a STEP_LEVELS case with B envs."""
    from tpu_doom_torch.utils.config import PlayerConfig

    wad, level = STEP_LEVELS[case]
    sim = TorchSim(GameConfig(wad_file=wad, initial_level_index=level, width=64, height=40,
                              batch_size=B, raster_backend="portal",
                              player=PlayerConfig(**player)), device)
    scene, s = sim.scene, sim.reset()
    if case.endswith("_no_triggers"):
        scene = scene._replace(**{f: getattr(scene, f)[:0] for f in scene._fields
                                  if f.startswith(("trig_", "eff_"))})
        s = s._replace(trig_alive=s.trig_alive[:, :0])
    return sim, scene, s


def _perturbed(s, start, rng):
    """A state around `start` (B, 3) with every field drawn from `rng`
    (some movements and looks zero, some envs flying, noclipping,
    jumping, toggling, pushing, shooting) and its actions."""
    from tpu_doom_torch.sim.state import Actions

    dev = s.pos.device
    B, O = s.object_offset.shape
    K = s.trig_alive.shape[1]

    def u(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)

    def coin(p, shape):
        return torch.as_tensor(rng.random(shape) < p, device=dev)

    pos = start + u(-2.0, 2.0, (B, 3)) * torch.tensor([1.0, 0.15, 1.0], device=dev)
    s = s._replace(
        pos=pos, vel=u(-4.0, 4.0, (B, 3)), yaw=u(-np.pi, np.pi, B), pitch=u(-1.5, 1.5, B),
        fly=coin(0.25, B), noclip=coin(0.25, B), last_height_diff=u(-0.1, 0.1, B),
        object_offset=u(-1.0, 1.0, (B, O)), eff_active=coin(0.5, (B, O)),
        eff_first=u(-1.0, 1.0, (B, O)), eff_second=u(-1.0, 1.0, (B, O)),
        eff_has_second=coin(0.5, (B, O)), eff_wait=u(0.0, 0.03, (B, O)),
        eff_speed=u(0.5, 3.0, (B, O)), trig_alive=coin(0.8, (B, K)),
        exit_triggered=torch.as_tensor(rng.integers(0, 3, B, dtype=np.int32), device=dev),
        time=u(0.0, 100.0, B),
        tick=torch.as_tensor(rng.integers(0, 10_000, B, dtype=np.int32), device=dev))
    a = Actions(movement=u(-1.0, 1.0, (B, 2)) * ~coin(0.2, (B, 1)),
                look=u(-0.2, 0.2, (B, 2)) * ~coin(0.3, (B, 1)), jump=coin(0.5, B),
                fly_toggle=coin(0.1, B), clip_toggle=coin(0.1, B), push=coin(0.5, B),
                shoot=coin(0.3, B))
    return s, a


def _differs(name, got, want):
    """'' if got and want are the same bits, else what differs."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}"
    g, w = ((got.view(torch.int32), want.view(torch.int32))
            if got.dtype == torch.float32 else (got, want))
    bad = (g != w).reshape(g.shape[0], -1).any(1).nonzero().flatten() if g.numel() else []
    if len(bad) == 0:
        return ""
    b = int(bad[0])
    return f"{name}: {len(bad)} envs, env {b}: {got[b].tolist()} vs {want[b].tolist()}"


def _step_both(scene, cfg, s, a):
    """One tick through S1, B1 and S2 on the card, S1 and S2 held bitwise
    to their plain versions on the same inputs -> the kernels' state."""
    from tpu_doom_torch.ops import (
        effects_rows,
        effects_rows_ref,
        player_move,
        player_triggers,
        player_triggers_ref,
    )
    from tpu_doom_torch.sim.state import SimState

    pcfg, dt = cfg.player, cfg.timestep
    got1, want1 = effects_rows(scene, s, a, dt), effects_rows_ref(scene, s, a, dt)
    assert sorted(got1[0]) == sorted(want1[0])
    bad = [_differs(k, got1[0][k], want1[0][k]) for k in want1[0]]
    bad += [_differs(k, x, y) for k, x, y in zip(("fly", "noclip", "rows", "state8"),
                                                  got1[1:], want1[1:])]
    assert not any(bad), [x for x in bad if x]
    mv = player_move(got1[3], got1[4], radius=pcfg.radius, height=pcfg.height, dt=dt,
                     substeps=pcfg.clip_substeps, enable_noclip=pcfg.enable_noclip)
    got = player_triggers(scene, pcfg, dt, s, a, *got1[:3], mv)
    want = player_triggers_ref(scene, pcfg, dt, s, a, *got1[:3], mv)
    bad = [_differs(k, x, y) for k, x, y in zip(SimState._fields, got, want)]
    assert not any(bad), [x for x in bad if x]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 1024])
@pytest.mark.parametrize("case", sorted(STEP_LEVELS))
def test_step_kernels_match_plain_versions_on_card(cuda_device, case, B):
    """On the card: S1 (effects, toggles, B1's rows and state) and S2 (the
    player math after B1, the triggers, the fired effects, the clock)
    bitwise their plain versions, every output, over 64 seeded ticks on
    :test: 0 (doors, a lift, lights), :doom2: 0 and 1 and :test: 0 without
    triggers or effects (K = D = 0); every other tick starts from a
    perturbed state with random actions, the rest follow the kernels'
    trajectory."""
    sim, scene, s = _step_sim(case, B, cuda_device)
    rng = np.random.default_rng([B, sorted(STEP_LEVELS).index(case)])
    start, a = s.pos.clone(), sim.null_actions()
    for t in range(STEP_TICKS):
        if t % 2 == 0:
            s, a = _perturbed(s, start, rng)
        s = _step_both(scene, sim.config, s, a)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_kernels_trigger_scenarios_on_card(cuda_device, name):
    """On the card: tests/test_torch_sim.py's trigger scenarios (doors,
    the exit switch, the lift, a push out of range), 2 envs, through S1,
    B1 and S2, each tick bitwise the plain versions; the same scenarios
    fire."""
    sim, scene, s = _step_sim("test0", 2, cuda_device, clip_substeps=1, enable_noclip=False)
    pos, yaw, field, ticks = SCENARIOS[name]
    s = s._replace(pos=torch.tensor([pos] * 2, device=cuda_device))
    if yaw is not None:
        s = s._replace(yaw=torch.full((2,), yaw, device=cuda_device))
    a = sim.null_actions()
    if field == "back":
        a = a._replace(movement=torch.tensor([[0.0, 1.0]] * 2, device=cuda_device))
    else:
        a = a._replace(**{field: torch.ones(2, dtype=torch.bool, device=cuda_device)})
    fired = False
    for _ in range(ticks):
        s = _step_both(scene, sim.config, s, a)
        fired = fired or bool(s.eff_active.any() or s.exit_triggered.any())
    assert fired == (name in FIRING), name


@pytest.mark.cuda
def test_step_kernels_rotations_bitwise_on_card(cuda_device):
    """On the card: S2's cosf / sinf are torch.cos / torch.sin bit for bit
    over a sweep of 65,536 yaws in [-4 pi, 4 pi] against pitches in
    [-1.55, 1.55] in another order, through the walk force, the fly force
    (half the envs fly, half jump) and the look direction (every env
    pushes): every output of S1 and S2 bitwise their plain versions."""
    N = 1 << 16
    sim, scene, s = _step_sim("test0", N, cuda_device)
    pitch = torch.linspace(-1.55, 1.55, N, device=cuda_device)
    order = torch.as_tensor(np.random.default_rng(3).permutation(N), device=cuda_device)
    on = torch.arange(N, device=cuda_device) % 2 == 0
    s = s._replace(yaw=torch.linspace(-4 * np.pi, 4 * np.pi, N, device=cuda_device),
                   pitch=pitch[order], fly=on)
    a = sim.null_actions()._replace(
        movement=torch.tensor([[0.6, -0.8]] * N, device=cuda_device), jump=~on,
        push=torch.ones(N, dtype=torch.bool, device=cuda_device))
    _step_both(scene, sim.config, s, a)


def _node_types(graph) -> list:
    """The CUgraphNodeType of each node of a kept CUDA graph."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t()
    assert cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int()
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        types.append(t.value)
    return types


@pytest.mark.cuda
def test_step_is_three_kernels_a_level_on_card(cuda_device, monkeypatch):
    """On the card: the step of DoomSim, and of each level of a 2-level
    bank, captured with spans and counters off, is three kernel nodes a
    level (S1, B1, S2) and nothing else; replayed, each kernel launches
    once a level a tic (`ops.launch_counts`)."""
    from tpu_doom_torch import trace
    from tpu_doom_torch.ops import launch_counts, reset_launch_counts
    from tpu_doom_torch.sim.state import Actions, null_actions
    from tpu_doom_torch.sim.step import step as sim_step
    from tpu_doom_torch.tools.fixtures import capture_bank_tick

    monkeypatch.setattr(trace, "_counters", {})  # no counter adds a node
    sim = TorchSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=4,
                              raster_backend="portal"), cuda_device)
    s, a = sim.reset(), sim.null_actions()
    bank = _bank(((":test:", 0), (":doom2:", 0)), cuda_device)
    L, E = bank.num_levels, 4
    bs = bank.reset(E)
    ba = Actions(*(x.reshape((L, E) + x.shape[1:]) for x in null_actions(L * E, cuda_device)))

    def bank_step():
        for lv in range(L):
            sim_step(bank._at(bank.scenes, lv), bank.cfg, bank._at(bs, lv), bank._at(ba, lv))

    for fn, levels in ((lambda: sim.step(s, a), 1), (bank_step, L)):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.no_grad(), torch.cuda.graph(graph):
            fn()
        assert _node_types(graph) == [KERNEL_NODE] * 3 * levels

    n = 5
    sim.step_n(s, None, n)  # captures
    reset_launch_counts()
    sim.step_n(s, None, n)
    counts = launch_counts()
    assert counts["effects_rows"] == counts["player_move"] == counts["player_triggers"] == n
    active = torch.ones((L, E), dtype=torch.bool, device=cuda_device)
    tick = capture_bank_tick(bank, bs, active, ba, 64, 40)
    reset_launch_counts()
    for _ in range(n):
        tick.replay()
    counts = launch_counts()
    assert counts["effects_rows"] == counts["player_move"] == counts["player_triggers"] == n * L


@pytest.mark.parametrize("case", sorted(STEP_LEVELS))
def test_step_kernel_wrappers_run_plain_versions_on_cpu(case):
    """On the CPU, S1's and S2's wrappers run their plain versions (no
    launch counted) on every STEP_LEVELS case, K = D = 0 included, and
    refuse operands of another shape or dtype, as B1's does on the card."""
    from tpu_doom_torch.ops import (
        effects_rows,
        effects_rows_ref,
        player_move,
        player_triggers,
        player_triggers_ref,
    )

    sim, scene, s = _step_sim(case, 3, "cpu")
    s, a = _perturbed(s, s.pos.clone(), np.random.default_rng(4))
    pcfg, dt = sim.config.player, sim.config.timestep
    launches = effects_rows.launches, player_triggers.launches
    got1, want1 = effects_rows(scene, s, a, dt), effects_rows_ref(scene, s, a, dt)
    assert all(torch.equal(got1[0][k], want1[0][k]) for k in want1[0])
    assert all(torch.equal(x, y) for x, y in zip(got1[1:], want1[1:]))
    mv = player_move(got1[3], got1[4], radius=pcfg.radius, height=pcfg.height, dt=dt,
                     substeps=pcfg.clip_substeps)
    got = player_triggers(scene, pcfg, dt, s, a, *got1[:3], mv)
    want = player_triggers_ref(scene, pcfg, dt, s, a, *got1[:3], mv)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (effects_rows.launches, player_triggers.launches) == launches
    with pytest.raises(ValueError, match="effects_rows: pos"):
        effects_rows(scene, s._replace(pos=s.pos[:, :2]), a, dt)
    with pytest.raises(ValueError, match="effects_rows: eff_wait"):
        effects_rows(scene, s._replace(eff_wait=s.eff_wait.double()), a, dt)
    with pytest.raises(ValueError, match="effects_rows: bp_cells"):
        effects_rows(scene._replace(bp_cells=scene.bp_cells.long()), s, a, dt)
    with pytest.raises(ValueError, match="player_triggers: mv"):
        player_triggers(scene, pcfg, dt, s, a, *got1[:3], mv[:, :10])
    with pytest.raises(ValueError, match="player_triggers: tick"):
        player_triggers(scene, pcfg, dt, s._replace(tick=s.tick.long()), a, *got1[:3], mv)
    with pytest.raises(ValueError, match="player_triggers: trig_type"):
        player_triggers(scene._replace(trig_type=scene.trig_type.float()), pcfg, dt, s, a,
                        *got1[:3], mv)
