"""Kernels on the card against their plain PyTorch versions (marked
`cuda`; they skip without a CUDA card). This file imports no JAX, so it
also runs on the GPU machine, which has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX.) chip_smoke.py runs
the full-size checks.
"""

import pytest
import torch

from tpu_doom.utils.config import GameConfig
from tpu_doom_torch.models import DoomSim as TorchSim


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
    got = peel_resolve(rows, attrs, grid, yb, 3, tile_p=256, chunk_t=64)
    want = peel_resolve_ref(rows, attrs, grid, yb, 3, tile_p=256, chunk_t=64)
    assert torch.equal(got, want)


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
    assert args[6].dim() == 3
    gi, gc = render_portal_fused(*args, **kw)
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)
