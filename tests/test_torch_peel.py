"""What lets the triangle path's kernels B3 (`peel_resolve`) and B9
(`depth_peel`) find all K layers in one sweep over the rows, and cull rows
per pixel tile, without changing a result: three properties of their
plain versions, on the CPU. The kernels themselves are held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

(a) `depth_peel_ref`'s K layers are the first K of each pixel's covering
    rows in a stable sort by (z, id) (-0 == +0), each with its own z, and
    (inf, BIG_ID) past the end: so a sorted list of the K least seen is
    the peel.
(b) The tile cull (`_peel_may_cover`, csrc/peel.cuh:may_cover) never
    rejects a row that covers a pixel of the box (`_peel_cover`).
(c) `peel_resolve_ref` gives the same channels for every tile_p and
    chunk_t as with no window-y cull at all: on the levels' own rows that
    cull drops no covering row, so the kernel may tile the image its own
    way.

Tolerance: exact (equal ids, z and channels bitwise).

`synthetic_rows` (also read by the card tests) makes rows that stress
both: edges, z = +-1 and slam = 0 lines through pixel centres, exactly
(small integer and power-of-two coefficients, half-integer centres),
full-frame rows with equal z, z = +0 and -0 ties, rows that cover few or
no pixels, and invalid rows.
"""

import os

import numpy as np
import pytest
import torch

from tpu_doom_torch.models import DoomSim
from tpu_doom_torch.ops.raster import (
    BIG_ID,
    PEEL_BIN,
    PEEL_TILE_H,
    PEEL_TILE_W,
    _peel_cover,
    _peel_may_cover,
    _peel_tile_boxes,
    depth_peel_ref,
    pack_triangle_rows,
    peel_resolve_ref,
)
from tpu_doom_torch.render import raster as R
from tpu_doom_torch.utils.config import GameConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
W, H = 64, 40
INF = float("inf")


def level_inputs(wad, width=W, height=H, device="cpu"):
    """B3's y-sorted inputs (rows (2, T, 24), attrs, grid, ybounds) and B9's
    rows (2, T, 16) for two pitched views of `wad` (:test:'s big room and
    grate; elsewhere the start at two yaws)."""
    sim = DoomSim(GameConfig(wad_file=wad, width=width, height=height, batch_size=2,
                             raster_backend="auto"), device)
    s = sim.reset()._replace(
        yaw=torch.tensor([0.9, 2.2], device=device),
        pitch=torch.tensor([0.3, -0.35], device=device))
    if wad == ":test:":
        s = s._replace(pos=torch.tensor([[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0]],
                                        device=device))
    return peel_pair(sim, s, width, height)


def peel_pair(sim, state, width, height):
    rows, attrs, grid, yb, _ = R.peel_inputs(sim.scene, sim.config, width, height, state)
    prep = R.prepare(sim.scene, sim.config, width, height, state)
    rows16 = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    return rows, attrs, grid, yb, rows16


def verify_inputs():
    """The same for the 8 verify poses of :test: at 320x200."""
    with np.load(os.path.join(GOLDEN, "verify_ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    sim = DoomSim(GameConfig(wad_file=":test:", width=320, height=200, batch_size=8,
                             portal_crossings=12, raster_backend="auto"), "cpu")
    s = sim.reset(8)._replace(**{k: torch.as_tensor(ref[k]) for k in (
        "pos", "yaw", "time", "pitch", "object_offset")})
    return peel_pair(sim, s, 320, 200)


def synthetic_rows(seed, T=300, width=W, height=H, B=2):
    """(rows16 (B, T, 16), rows24 (B, T, 24), attrs (B, T, 16), ybounds
    (B, T, 2)) f32: the stress rows of this module's docstring; ids
    (column 22 of rows24) a permutation of 0..T-1; window-y bounds
    arbitrary, one NaN (the kernel applies the plain version's cull as
    it is).
    Random rows cover only the left half of the image (x <= width / 2 -
    0.5, an edge through a column of pixel centres); four tie rows at
    random positions cover the next quarter alone, at z = -0, +0, 0.25
    and 0.25; nothing covers the last quarter."""
    rng = np.random.default_rng(seed)
    shape = (B, T)

    def through_centres(scale=1.0):
        """(a, b, c) with a x + b y + c exactly 0 on a line through a
        pixel centre."""
        a = rng.integers(-3, 4, shape) * scale
        b = rng.integers(-3, 4, shape) * scale
        cx = rng.integers(0, width, shape) + 0.5
        cy = rng.integers(0, height, shape) + 0.5
        return np.stack([a, b, -(a * cx + b * cy)], axis=-1)

    half, three_q = width // 2 - 0.5, width * 3 // 4 - 0.5
    rows = np.zeros((B, T, 16))
    rows[..., 0:3] = [-1.0, 0.0, half]
    for i in (1, 2):
        rows[..., 3 * i:3 * i + 3] = through_centres()
    rows[rng.random(shape) < 0.25, 3:9] = 0.0  # the whole left half
    # z: a constant of a small set (ties, +0 and -0), or a slope that is
    # exactly +-1 or 0.5 along a line through a pixel centre.
    consts = np.array([0.25, 0.5, -0.5, 0.0, -0.0, 1.0, -1.0])
    kind = rng.integers(0, len(consts) + 1, shape)
    sloped = through_centres(1.0 / 64.0)
    sloped[..., 2] += rng.choice([1.0, -1.0, 0.5], shape)
    c = consts[np.minimum(kind, len(consts) - 1)]
    rows[..., 9:12] = np.where((kind == len(consts))[..., None], sloped,
                               np.stack([0.0 * c, 0.0 * c, c], axis=-1))
    rows[..., 12:15] = np.where((rng.random(shape) < 0.3)[..., None], through_centres(),
                                np.array([0.0, 0.0, 1.0]))
    rows[..., 15] = rng.random(shape) > 0.1
    for b in range(B):
        for t, z in zip(rng.choice(T, 4, replace=False), (-0.0, 0.0, 0.25, 0.25)):
            rows[b, t] = [1.0, 0.0, -(half + 1.0), -1.0, 0.0, three_q, 0.0, 0.0, 0.0,
                          0.0 * z, 0.0 * z, z, 0.0, 0.0, 1.0, 1.0]
    rows16 = torch.as_tensor(rows.astype(np.float32))
    ids = np.stack([rng.permutation(T) for _ in range(B)]).astype(np.float32)
    extra = rng.normal(size=(B, T, 6)).astype(np.float32)
    rows24 = torch.cat([rows16, torch.as_tensor(extra), torch.as_tensor(ids)[..., None],
                        torch.zeros((B, T, 1))], dim=-1)
    attrs = torch.as_tensor(rng.normal(size=(B, T, 16)).astype(np.float32))
    ymin = rng.uniform(-5.0, height + 5.0, shape)
    yb = np.stack([ymin, ymin + rng.uniform(0.0, height, shape)], axis=-1)
    yb[0, T // 4, 0] = np.nan  # its chunk's bounds are NaN: never tested
    return rows16, rows24, attrs, torch.as_tensor(yb.astype(np.float32))


def _case(name):
    """(rows16, grid, width) of a named case."""
    if name == "synthetic":
        return synthetic_rows(0)[0], R.pixel_grid(W, H, "cpu"), W
    if name == "synthetic_ragged":  # the image's last row is cut short
        return synthetic_rows(1, T=200)[0], R.pixel_grid(W, H, "cpu")[:, :-37], W
    if name == "verify":
        return verify_inputs()[4], R.pixel_grid(320, 200, "cpu"), 320
    wad = {"test": ":test:", "texstress_small": ":texstress:10x16",
           "texstress": ":texstress:"}[name]
    _, _, grid, _, rows16 = level_inputs(wad)
    return rows16, grid, W


def sorted_layers(rows, grid, K):
    """The first K of each pixel's covering rows in a stable sort by
    (z, row position) -> (z (B, K, P) f32, id (B, K, P) i32)."""
    B, T, _ = rows.shape
    P = grid.shape[1]
    zs = np.full((B, K, P), np.inf, np.float32)
    ids = np.full((B, K, P), BIG_ID, np.int32)
    cols = np.arange(P)
    for b in range(B):
        cover, z = (x.numpy() for x in _peel_cover(rows[b], grid[0][None], grid[1][None]))
        key = np.where(cover, z, np.inf)
        order = np.lexsort((np.broadcast_to(np.arange(T)[:, None], key.shape), key), axis=0)
        for k in range(min(K, T)):
            t = order[k]
            hit = cover[t, cols]
            zs[b, k] = np.where(hit, z[t, cols], np.inf)
            ids[b, k] = np.where(hit, t, BIG_ID)
    return zs, ids


@pytest.mark.parametrize("K", [1, 3, 4, 9])
@pytest.mark.parametrize("name", ["test", "texstress_small", "synthetic"])
def test_depth_peel_ref_layers_are_the_sorted_covers(name, K):
    """(a) Layer k of the iterative peel is the (k+1)-th covering row in
    (z, id) order, with its own z (bitwise), on pitched level views and on
    the synthetic rows (ties, +-0, fewer than K covers, none)."""
    rows, grid, _ = _case(name)
    z, ids = depth_peel_ref(rows, grid, K)
    zs, want = sorted_layers(rows, grid, K)
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(z.numpy().view(np.int32), zs.view(np.int32))
    if name == "synthetic":  # pixels with no cover, fewer than K, and +-0 ties
        covers = (want < BIG_ID).sum(1)
        assert (covers == 0).any() and (covers < K).any() and (covers == K).any()
        if K > 1:
            neg0 = (zs == 0.0) & np.signbit(zs)
            assert (neg0.any(1) & ((zs == 0.0) & ~np.signbit(zs)).any(1)).any()


@pytest.mark.parametrize("box", ["tile", "bin"])
@pytest.mark.parametrize("name", ["verify", "texstress", "synthetic", "synthetic_ragged"])
def test_tile_cull_never_rejects_a_covering_row(name, box):
    """(b) Every (box, row) pair with a pixel of the box that the row
    covers survives the cull, for the kernels' 32 x 8 tiles and 64 x 64
    bins, on the 8 verify poses at 320x200, on :texstress: and on rows
    whose edges pass exactly through pixel centres; and the tile cull
    rejects most pairs."""
    rows, grid, width = _case(name)
    size = dict(tile=(PEEL_TILE_W, PEEL_TILE_H), bin=(PEEL_BIN, PEEL_BIN))[box]
    tile, boxes = _peel_tile_boxes(grid, width, *size)
    kept = needed = 0
    for b in range(rows.shape[0]):
        keep = _peel_may_cover(rows[b], boxes)
        cover, _ = _peel_cover(rows[b], grid[0][None], grid[1][None])
        hit = torch.zeros(keep.shape).index_add_(1, tile, cover.float()) > 0
        assert not bool((hit & ~keep).any()), b
        kept += int(keep.sum())
        needed += int(hit.sum())
    assert needed > 0
    if box == "tile":  # a 64 x 40 image is one bin
        share = 0.9 if name.startswith("synthetic") else 0.5
        assert kept < share * keep.numel() * rows.shape[0]


@pytest.mark.parametrize("chunk_t", [16, 64, 128])
@pytest.mark.parametrize("tile_p", [256, 1024])
@pytest.mark.parametrize("wad", [":test:", ":texstress:10x16"])
def test_peel_resolve_ref_tiling_is_free(wad, tile_p, chunk_t):
    """(c) B3's plain version with the window-y cull at these tile_p and
    chunk_t equals it with no cull (every row's bounds (-inf, inf)),
    bitwise, at K = 3 on pitched views."""
    rows, attrs, grid, yb, _ = level_inputs(wad)
    open_yb = torch.stack([torch.full(yb.shape[:2], -INF), torch.full(yb.shape[:2], INF)], -1)
    want = peel_resolve_ref(rows, attrs, grid, open_yb, 3, tile_p, chunk_t)
    got = peel_resolve_ref(rows, attrs, grid, yb, 3, tile_p, chunk_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(got[:, 0, 13].mean()) > 0.5
