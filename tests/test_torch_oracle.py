"""The port's reference configurations, `raster_backend="portal_jnp"`
(the walk, then B7 classify_alpha, then B8 shade_portal) and `"jnp"` (B9
depth_peel, the first surviving layer, the shade), against the JAX
package on identical inputs (CPU: the wrappers take their plain versions;
the JAX kernels run in interpret mode, as tests/test_pallas.py runs them).

Tolerances:
(e) B9's plain version vs depth_peel_pallas: ids equal, z within 2e-5
    (tests/test_pallas.py:62-67's pin; XLA contracts a*b+c into fused
    multiply-adds on the CPU, the port rounds every step).
(f) B7's plain version vs classify_alpha_pallas: equal.
(g) B8's plain version vs shade_portal_pallas: equal.
(h), (i) whole frames vs the JAX package's same configuration: at most
    16 px per frame (the verify legs' ceiling; XLA's and PyTorch's
    sin/cos/atan2 differ by an ulp, which moves span-boundary pixels, and
    the port's "jnp" peel uses B9's z = zr . p where the JAX package's
    dense peel computes (vz . p) / det).
(j) exact: a property of the walk's records.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_doom.models import DoomSim as JaxSim
from tpu_doom.utils.config import GameConfig
from tpu_doom_torch.models import DoomSim as TorchSim
from tpu_doom_torch.sim.state import state_from_numpy
from tpu_doom_torch.utils.config import GameConfig as TorchConfig

TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
T = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
P11 = 1.0 / math.tan(math.radians(65.0) / 2.0)
CEILING = 16


def _peel_rows(poses, W, H):
    """The JAX package's triangle setup and 16-column rows for poses
    (pos, yaw) on :test: (tests/test_pallas.py:36-56)."""
    from tpu_doom.ops.raster_pallas import pack_triangle_rows
    from tpu_doom.render.raster_jnp import _pixel_grid, _prepare_env

    sim = JaxSim(GameConfig(wad_file=":test:", raster_backend="jnp"))
    s = sim.reset(len(poses))._replace(
        pos=jnp.asarray([p for p, _ in poses], jnp.float32),
        yaw=jnp.asarray([y for _, y in poses], jnp.float32))
    prep = jax.vmap(lambda pos, yaw, pitch, off, t: _prepare_env(
        sim.scene, sim.config, W, H, pos, yaw, pitch, off, t))(
            s.pos, s.yaw, s.pitch, s.object_offset, s.time)
    rows = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    return prep, rows, _pixel_grid(W, H)


def test_depth_peel_ref_matches_pallas_interpret():
    """(e) B9's plain version vs depth_peel_pallas on :test: at 96x64,
    two poses, K = 3; the port's row packing equals the JAX package's."""
    from tpu_doom.ops.raster_pallas import depth_peel_pallas

    from tpu_doom_torch.ops.raster import depth_peel_ref, pack_triangle_rows

    prep, rows, grid = _peel_rows(
        [([-2.56, 0.33, -2.24], 0.0), ([-2.0, 0.2, -8.5], 1.3)], 96, 64)
    got_rows = pack_triangle_rows(T(prep["e"]), T(prep["det"]), T(prep["vz"]),
                                  T(prep["vs"]))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(rows))
    zp, ip = (np.asarray(x) for x in depth_peel_pallas(
        rows, grid, 3, tile_p=256, chunk_t=64, interpret=True))
    zg, ig = depth_peel_ref(got_rows, T(grid), 3)
    assert ig.dtype == torch.int32
    np.testing.assert_array_equal(ig.numpy(), ip)
    fin = np.isfinite(zp)
    np.testing.assert_array_equal(np.isfinite(zg.numpy()), fin)
    np.testing.assert_allclose(zg.numpy()[fin], zp[fin], rtol=0, atol=2e-5)
    assert fin[:, 0].mean() > 0.5 and (~fin[:, 2]).any()


def test_depth_peel_ref_empty_pixels_get_big_id():
    """(e) Outside the map looking away: empty pixels are (inf, BIG_ID)."""
    from tpu_doom_torch.ops.raster import BIG_ID, depth_peel_ref, pack_triangle_rows
    from tpu_doom_torch.render import raster as R

    sim = TorchSim(TorchConfig(wad_file=":test:", raster_backend="jnp"), "cpu")
    s = sim.reset(1)._replace(pos=torch.tensor([[50.0, 0.0, 50.0]]))
    prep = R.prepare(sim.scene, sim.config, 32, 32, s)
    rows = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    z, ids = depth_peel_ref(rows, R.pixel_grid(32, 32, "cpu"), 1)
    empty = ~torch.isfinite(z)
    assert bool(empty.any())
    assert bool((ids[empty] == BIG_ID).all())


@pytest.fixture(scope="module")
def jax_classified():
    """The JAX walk's records of :test: at 64x32, two envs
    (tests/test_pallas.py:104-151), classified by classify_alpha_pallas in
    interpret mode, and the shade's other inputs."""
    from tpu_doom.ops.raster_pallas import classify_alpha_pallas
    from tpu_doom.render.portal import _sky_image, _walk_env

    W, H = 64, 32
    sim = JaxSim(GameConfig(wad_file=":test:", width=W, height=H, batch_size=2,
                            raster_backend="portal_jnp", portal_crossings=10))
    ps = sim._get_portal_scene()
    s = sim.reset(2)._replace(
        pos=jnp.asarray([[-2.56, 0.5, -2.24], [-2.2, 0.2, -8.8]], jnp.float32),
        yaw=jnp.asarray([0.0, 0.9], jnp.float32),
        time=jnp.asarray([0.0, 1.25], jnp.float32))
    rec, words, aux = jax.jit(jax.vmap(lambda p, y, pi, o, t: _walk_env(
        ps, sim.scene, sim.config, W, H, 10, p, y, pi, o, t)))(
            s.pos, s.yaw, s.pitch, s.object_offset, s.time)
    sky = jax.jit(jax.vmap(lambda sy, cy, sp, cp: _sky_image(
        ps, sim.scene, sim.config, W, H, sy, cy, sp, cp)))(
            aux["sy"], aux["cy"], aux["sp"], aux["cp"])
    hc = ps["alpha_meta"][0]
    cam_y = aux["cam"][:, 1]
    ch = classify_alpha_pallas(rec, words, cam_y, hc, H, P11, interpret=True)
    B, P = 2, H * W
    ndc_y = (1.0 - 2.0 * (np.arange(H, dtype=np.float32) + 0.5) / np.float32(H))
    ndc_y = np.repeat(ndc_y.astype(np.float32), W)[None, :]
    dxz = np.broadcast_to(np.asarray(aux["d"]).transpose(0, 2, 1)[:, :, None, :],
                          (B, 2, H, W)).reshape(B, 2, P)
    return dict(rec=rec, words=words, cam_y=cam_y, hc=int(hc), ch=np.asarray(ch),
                ndc_y=ndc_y, dxz=np.ascontiguousarray(dxz),
                sky=np.asarray(sky).reshape(B, P), cam=np.asarray(aux["cam"]),
                ps=ps, H=H, W=W)


def test_classify_alpha_ref_matches_pallas_interpret(jax_classified):
    """(f) B7's plain version vs classify_alpha_pallas: equal."""
    from tpu_doom_torch.ops.raster import classify_alpha_ref

    j = jax_classified
    got = classify_alpha_ref(T(j["rec"]), T(j["words"]), T(j["cam_y"]), j["hc"],
                             j["H"], P11)
    assert got.shape == j["ch"].shape == (2, 11, j["H"], j["W"])
    np.testing.assert_array_equal(got.numpy(), j["ch"])
    assert (j["ch"][:, 0] != 0).mean() > 0.9


def test_classify_alpha_ref_empty_records():
    """(f) All-empty spans classify to zeros (tests/test_pallas.py:153-167)."""
    from tpu_doom.ops.raster_pallas import classify_alpha_pallas

    from tpu_doom_torch.ops.raster import classify_alpha_ref

    rec = np.zeros((1, 10, 16, 40), np.float32)
    rec[:, :, 0, :] = 1e9
    rec[:, :, 1, :] = -1e9
    words = np.zeros((1, 2, 4, 40), np.int32)
    want = np.asarray(classify_alpha_pallas(
        jnp.asarray(rec), jnp.asarray(words), jnp.zeros((1,)), 128, 32, 1.07,
        interpret=True))
    got = classify_alpha_ref(T(rec), T(words), torch.zeros((1,)), 128, 32, 1.07)
    assert got.shape == (1, 11, 32, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.any()


def _shade_both(j, hole):
    from tpu_doom.ops.raster_pallas import shade_portal_pallas

    from tpu_doom_torch.ops.raster import shade_portal_ref

    ps = j["ps"]
    B, P = 2, j["H"] * j["W"]
    ch = j["ch"].reshape(B, 11, P)
    want = shade_portal_pallas(
        jnp.asarray(ch), jnp.asarray(j["dxz"]), jnp.asarray(j["ndc_y"]),
        jnp.asarray(j["sky"]), jnp.asarray(j["cam"]), ps["tex_i8"], jnp.asarray(hole),
        ps["cmap_i8"], P11, 32, tile=P, interpret=True)
    got = shade_portal_ref(T(ch), T(j["dxz"]), T(j["ndc_y"]), T(j["sky"]),
                           T(j["cam"]), T(ps["tex_i8"]), T(hole), T(ps["cmap_i8"]),
                           P11, 32)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def test_shade_portal_ref_matches_pallas_interpret(jax_classified):
    """(g) B8's plain version vs shade_portal_pallas on (f)'s channels:
    0 px differ, with the level's hole table and with a full-size table
    of empty hole bytes (what a holeless level gets)."""
    j = jax_classified
    tex = np.asarray(j["ps"]["tex_i8"])
    empty = np.full((-(-tex.shape[0] // 8), 128), -128, np.int8)
    for hole in (np.asarray(j["ps"]["hole_bytes"]), empty):
        (wi, wc), (gi, gc) = _shade_both(j, hole)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
        assert wc.mean() > 0.9


def test_shade_portal_refuses_the_stub_hole_table(jax_classified):
    """(g) The (1, 128) stub the fused path passes for holeless levels is
    too short for B8: the TPU kernel reads past it and returns byte 128,
    whose bit 7 marks texels as holes; the port raises instead."""
    from tpu_doom.ops.raster_pallas import shade_portal_pallas

    from tpu_doom_torch.ops.raster import shade_portal, shade_portal_ref

    j = jax_classified
    ps, P = j["ps"], j["H"] * j["W"]
    stub = np.full((1, 128), -128, np.int8)
    full = np.full((-(-ps["tex_i8"].shape[0] // 8), 128), -128, np.int8)
    (_, want_cov), _ = _shade_both(j, full)
    stub_cov = np.asarray(shade_portal_pallas(
        jnp.asarray(j["ch"].reshape(2, 11, P)), jnp.asarray(j["dxz"]),
        jnp.asarray(j["ndc_y"]), jnp.asarray(j["sky"]), jnp.asarray(j["cam"]),
        ps["tex_i8"], jnp.asarray(stub), ps["cmap_i8"], P11, 32, tile=P,
        interpret=True)[1])
    assert (stub_cov != want_cov).sum() > 0  # the trap, on the TPU kernel
    args = (T(j["ch"].reshape(2, 11, P)), T(j["dxz"]), T(j["ndc_y"]), T(j["sky"]),
            T(j["cam"]), T(ps["tex_i8"]), T(stub), T(ps["cmap_i8"]), P11, 32)
    for fn in (shade_portal_ref, shade_portal):
        with pytest.raises(ValueError, match="hole table"):
            fn(*args)


POSES4 = dict(  # (h): tests/test_torch_render.py's POSES, one env pitched
    pos=[[-2.56, 0.5, -2.24], [-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0],
         [-3.8, 0.0, -9.8]],
    yaw=[0.0, 0.9, 0.0, 0.0], time=[0.0, 1.25, 0.4, 0.0],
    pitch=[1e-8, 0.3, 1e-8, 1e-8])


def _frames_both(wad_file, W, H, B, backend, state_kw, **cfg_kw):
    """Render the same states through the JAX package's and the port's
    DoomSim in configuration `backend` -> (jax idx, jax cov, port idx,
    port cov), numpy."""
    kw = dict(wad_file=wad_file, width=W, height=H, batch_size=B,
              raster_backend=backend, **cfg_kw)
    simj = JaxSim(GameConfig(render_env_chunk=0, **kw))
    simt = TorchSim(TorchConfig(**kw), "cpu")
    s = simj.reset(B)
    s = s._replace(**{k: jnp.asarray(v, jnp.float32) for k, v in state_kw.items()})
    ij, cj = (np.asarray(x) for x in simj.render(s))
    it, ct = simt.render(state_from_numpy(TO_NP(s), "cpu"))
    assert it.dtype == torch.uint8 and ct.dtype == torch.bool
    return ij, cj, it.numpy(), ct.numpy()


def _within_ceiling(ij, cj, it, ct):
    for e in range(ij.shape[0]):
        assert int((it[e] != ij[e]).sum()) <= CEILING, e
        assert int((ct[e] != cj[e]).sum()) <= CEILING, e


def test_doomsim_portal_jnp_matches_jax_test_level():
    """(h) DoomSim(raster_backend="portal_jnp") on :test: at 64x40 x 4
    envs, one pitched 0.3 (the y-shear through B7 and B8, with the sky
    image of `_shade_portal`: the fused kernel's `_sky_image` differs from
    it by 252 px of sky on that env, and so does the port's "portal")."""
    ij, cj, it, ct = _frames_both(":test:", 64, 40, 4, "portal_jnp", POSES4)
    _within_ceiling(ij, cj, it, ct)
    assert cj.mean() > 0.9
    simt = TorchSim(TorchConfig(wad_file=":test:", width=64, height=40,
                                raster_backend="portal"), "cpu")
    s = simt.reset(4)._replace(**{k: torch.tensor(v) for k, v in POSES4.items()})
    ip = simt.render(s)[0].numpy()
    assert (ip[1] != ij[1]).sum() > 100 and (ip[[0, 2, 3]] == it[[0, 2, 3]]).all()


def test_doomsim_portal_jnp_matches_jax_holeless_big_level():
    """(h) :texstress:10x16 (a big level without hole bytes: B8 reads a
    full-size empty hole table) at 64x40 x 3 envs."""
    from tpu_doom_torch.render import portal as P

    sim = TorchSim(TorchConfig(wad_file=":texstress:10x16",
                               raster_backend="portal_jnp"), "cpu")
    assert "hole_bytes" not in sim.portal_scene()
    assert sim.portal_scene()["has_back"].shape[0] > P.SMALL_LEVEL_ROWS
    # Not yaw 0.0: there XLA's fused multiply-adds move 19 px of a floor
    # in the JAX package's own render (tests/test_torch_bigwalk.py).
    ij, cj, it, ct = _frames_both(":texstress:10x16", 64, 40, 3, "portal_jnp",
                                  dict(yaw=[1.0, 2.2, 4.0]))
    _within_ceiling(ij, cj, it, ct)
    assert cj.mean() > 0.9


def test_doomsim_jnp_matches_jax():
    """(i) DoomSim(raster_backend="jnp") on :test: at 96x64 x 2 envs, one
    pitched."""
    ij, cj, it, ct = _frames_both(
        ":test:", 96, 64, 2, "jnp",
        dict(pos=[[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0]], yaw=[0.9, 0.0],
             pitch=[0.3, 1e-8], time=[1.25, 0.4]))
    _within_ceiling(ij, cj, it, ct)
    assert cj.mean() > 0.9


def test_portal_jnp_triangle_fallback_takes_the_jnp_path():
    """(i) portal_jnp with portal_pitch="triangle": the pitched env falls
    back to the "jnp" triangle path (B9), as the JAX package's does
    (portal.py:1487); it equals the port's "jnp" render of that env."""
    state = dict(pos=[[-2.2, 0.2, -8.8]] * 2, yaw=[0.9, 0.9], pitch=[0.4, 1e-8])
    ij, cj, it, ct = _frames_both(":test:", 64, 40, 2, "portal_jnp", state,
                                  portal_pitch="triangle")
    _within_ceiling(ij, cj, it, ct)
    simt = TorchSim(TorchConfig(wad_file=":test:", width=64, height=40,
                                raster_backend="jnp"), "cpu")
    s = simt.reset(2)._replace(**{k: torch.tensor(v) for k, v in state.items()})
    i2, c2 = simt.render(s)
    np.testing.assert_array_equal(it[0], i2[0].numpy())
    np.testing.assert_array_equal(ct[0], c2[0].numpy())


def test_no_kind_zero_record_covers_a_pixel():
    """(j) B7 marks a pixel done on a non-zero kind, the JAX package's
    `_classify_jnp` (and B2) on any covering record: the two agree
    because no record of kind 0 covers a pixel. Checked on the port's
    walk at the (h) poses, where B7 then B8 equal B2 exactly on the
    zero-pitch envs (the pitched one's sky image differs, see (h))."""
    from tpu_doom_torch.ops.raster import classify_alpha, render_portal_fused, shade_portal
    from tpu_doom_torch.render import portal as P

    W, H = 64, 40
    sim = TorchSim(TorchConfig(wad_file=":test:", width=W, height=H, batch_size=4,
                               raster_backend="portal_jnp"), "cpu")
    s = sim.reset(4)._replace(**{k: torch.tensor(v) for k, v in POSES4.items()})
    records, _, _ = P.walk(sim.portal_scene(), sim.scene, sim.config, W, H,
                           int(sim.config.portal_crossings), s)
    y = torch.arange(H, dtype=torch.float32) + 0.5
    covers = ((y >= records[:, :, 0, :, None])
              & (y < records[:, :, 1, :, None])).any(dim=-1)  # (B, R, W)
    kind0 = records[:, :, 2] == 0.0
    assert bool(covers.any()) and bool(kind0.any())
    assert not bool((covers & kind0).any())

    cargs, sargs, shear, _ = P.oracle_inputs(sim.portal_scene(), sim.scene,
                                             sim.config, W, H, s)
    i78, c78 = shade_portal(classify_alpha(*cargs, shear=shear).reshape(4, 11, -1),
                            *sargs, shear=shear)
    args, kw, _ = P.fused_inputs(sim.portal_scene(), sim.scene, sim.config, W, H, s)
    i2, c2 = render_portal_fused(*args, **kw)
    flat = [0, 2, 3]
    # B8's f32 outputs after the frames' casts are B2's u8 / bool frames.
    assert torch.equal(i78.reshape(4, H, W)[flat].to(torch.uint8), i2[flat])
    assert torch.equal(c78.reshape(4, H, W) > 0.5, c2)
