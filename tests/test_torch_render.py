"""The PyTorch port's renderers against the JAX package on identical
inputs (CPU: kernel wrappers take their plain versions here; the kernels
themselves are held to the plain versions on the card by the `cuda`
tests below and by chip_smoke.py).

Tolerances:
* B2 plain version vs the Pallas kernel in interpret mode, on records
  and alpha words made by the JAX walk: idx and cov equal.
* B3 plain version vs the Pallas kernel in interpret mode:
  has / pass / transparent equal; floats within rtol 1e-5 but for at
  most 1e-4 of them, which stay within 1e-3 absolute (XLA contracts
  a*b+c into fused multiply-adds on the CPU, the port rounds each step,
  and the perspective interpolation cancels terms).
* Whole frames vs JAX `portal_jnp` (bit-equal to the kernel path,
  test_portal.py:162): per-pose mismatched pixels pinned at the counts
  measured, never above 16. The sin/cos/atan2 of XLA and of PyTorch
  differ by an ulp, which moves a few span-boundary pixels.
* The triangle path vs tests/golden/frames.npz: coverage equal, pinned
  pixel counts.
"""

import math
import os

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

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
T = lambda x: torch.as_tensor(np.array(x))  # noqa: E731


def _walk_inputs(W, H):
    """Records / words / camera terms from the JAX walk for 3 poses,
    one of them pitched (y-shear)."""
    from tpu_doom.render.portal import _sky_image, _walk_env

    cfg = GameConfig(wad_file=":test:", width=W, height=H, batch_size=3,
                     raster_backend="portal_jnp", render_env_chunk=0)
    sim = JaxSim(cfg)
    s = sim.reset(3)._replace(
        pos=jnp.asarray([[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0],
                         [-3.8, 0.0, -9.8]], jnp.float32),
        yaw=jnp.asarray([0.9, 0.0, 0.0], jnp.float32),
        time=jnp.asarray([1.25, 0.4, 0.0], jnp.float32),
        pitch=jnp.asarray([-0.35, 1e-8, 1e-8], jnp.float32),
    )
    ps = sim._get_portal_scene()
    rec, words, aux = jax.jit(jax.vmap(
        lambda p, y, pi, o, t: _walk_env(ps, sim.scene, cfg, W, H, 24, p, y, pi, o, t)
    ))(s.pos, s.yaw, s.pitch, s.object_offset, s.time)
    sky = jax.jit(jax.vmap(
        lambda sy, cy, sp, cp: _sky_image(ps, sim.scene, cfg, W, H, sy, cy, sp, cp)
    ))(aux["sy"], aux["cy"], aux["sp"], aux["cp"])
    return sim, ps, rec, words, aux, sky


def _port_sky(wad, W, H, aux, want=None):
    """B2's sky operands from the port: `sky_coords` of the JAX walk's
    camera terms (aux), and the port's u8 sky texture of `wad`. Where the
    JAX sky image `want` is given, their gather must equal it."""
    from tpu_doom_torch.ops.raster import sky_gather
    from tpu_doom_torch.render.portal import sky_coords

    simt = TorchSim(TorchConfig(wad_file=wad, width=W, height=H,
                                raster_backend="portal"), "cpu")
    sky_x, sky_y = sky_coords(simt.scene, simt.config, W, H, T(aux["sy"]),
                              T(aux["cy"]), T(aux["sp"]), T(aux["cp"]))
    sky_tex = simt.portal_scene()["sky_tex"]
    assert (sky_x.dtype, sky_y.dtype, sky_tex.dtype) == (torch.int32, torch.int32,
                                                         torch.uint8)
    if want is not None:
        np.testing.assert_array_equal(sky_gather(sky_x, sky_y, sky_tex).numpy(),
                                      np.asarray(want))
    return sky_x, sky_y, sky_tex


def test_render_portal_fused_ref_matches_pallas_interpret():
    """(c) B2's plain version vs render_portal_fused_pallas(interpret)
    followed by the JAX package's casts (portal.py:1587: idx as u8, cov >
    0.5): the port takes the sky as coordinates, whose gather is the JAX
    sky image the Pallas kernel takes, and returns u8 / bool."""
    from tpu_doom.ops.raster_pallas import render_portal_fused_pallas

    from tpu_doom_torch.ops.raster import render_portal_fused_ref

    W, H = 64, 40
    sim, ps, rec, words, aux, sky = _walk_inputs(W, H)
    p11 = 1.0 / math.tan(math.radians(65.0) / 2.0)
    dxz = aux["d"].transpose(0, 2, 1)
    hc = ps["alpha_meta"][0]
    want_i, want_c = render_portal_fused_pallas(
        rec, words, aux["cam"], hc, dxz, sky, ps["tex_i8"], ps["hole_bytes"],
        ps["cmap_i8"], H, p11, 32, tile_h=40, interpret=True,
        shear=aux["shear"], hole_ranges=ps["hole_ranges"])
    got_i, got_c = render_portal_fused_ref(
        T(rec), T(words), T(aux["cam"]), int(hc), T(dxz), *_port_sky(":test:", W, H, aux, sky),
        T(ps["tex_i8"]), T(ps["hole_bytes"]), T(ps["cmap_i8"]), H, p11, 32,
        shear=T(aux["shear"]))
    assert got_i.dtype == torch.uint8 and got_c.dtype == torch.bool
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i.astype(jnp.uint8)))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c > 0.5))
    assert np.asarray(want_c).mean() > 0.9
    assert np.asarray(aux["shear"]).any()


# Sky cases: wad, yaws, pitches (the JAX `_sky_image` takes the camera
# terms as they are; a pitched env moves the sky rows).
SKY_CASES = {
    "test_pitched": (":test:", [0.0, 0.9, 2.5, -1.2], [0.0, -0.35, 0.3, 0.0]),
    "doom2": (":doom2:", [0.0, 1.7, -2.4, 3.0], [0.0, 0.3, 0.0, -0.2]),
}


@pytest.mark.parametrize("case", list(SKY_CASES))
def test_sky_coords_gather_is_jax_sky_image(case):
    """`sky_coords` then the two row gathers of B2's plain version
    (`sky_gather`) equal the JAX package's `_sky_image`, bitwise, under
    pitch and on :doom2:."""
    from tpu_doom.render.portal import _sky_image

    wad, yaws, pitches = SKY_CASES[case]
    W, H = 64, 40
    cfg = GameConfig(wad_file=wad, width=W, height=H, raster_backend="portal")
    sim = JaxSim(cfg)
    ps = sim._get_portal_scene()
    yaw = np.asarray(yaws, np.float32)
    pitch = np.asarray(pitches, np.float32)
    on = np.abs(pitch) > 1e-5
    aux = dict(sy=np.sin(yaw.astype(np.float64)).astype(np.float32),
               cy=np.cos(yaw.astype(np.float64)).astype(np.float32),
               sp=np.where(on, np.sin(pitch.astype(np.float64)), 0.0).astype(np.float32),
               cp=np.where(on, np.cos(pitch.astype(np.float64)), 1.0).astype(np.float32))
    want = np.asarray(jax.jit(jax.vmap(
        lambda sy, cy, sp, cp: _sky_image(ps, sim.scene, cfg, W, H, sy, cy, sp, cp)
    ))(aux["sy"], aux["cy"], aux["sp"], aux["cp"]))
    sky_x, sky_y, _ = _port_sky(wad, W, H, aux, want)
    assert sky_x.shape == (4, W) and sky_y.shape == (4, H)
    # The pitched envs' sky rows differ from the level ones' (env 0's).
    assert on.sum() == 2 and not on[0]
    assert all(torch.equal(sky_y[i], sky_y[0]) != bool(on[i]) for i in range(1, 4))


def test_walk_and_tables_match_jax():
    """The port's portal tables equal the JAX ones; its walk emits the
    same alpha words and matches the records up to the ulp-level
    sin/cos differences (all but a few record values equal)."""
    from tpu_doom_torch.render.portal import sky_image, walk

    W, H = 64, 40
    sim, ps, rec, words, aux, sky = _walk_inputs(W, H)
    simt = TorchSim(TorchConfig(wad_file=":test:", width=W, height=H,
                               raster_backend="portal"), "cpu")
    pt = simt.portal_scene()
    for k in ("tex_i8", "hole_bytes", "cmap_i8", "sky_tex"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(ps[k]), err_msg=k)
    assert pt["hc"] == int(ps["alpha_meta"][0])
    s = sim.reset(3)._replace(
        pos=jnp.asarray([[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0],
                         [-3.8, 0.0, -9.8]], jnp.float32),
        yaw=jnp.asarray([0.9, 0.0, 0.0], jnp.float32),
        time=jnp.asarray([1.25, 0.4, 0.0], jnp.float32),
        pitch=jnp.asarray([-0.35, 1e-8, 1e-8], jnp.float32),
    )
    rt, wt, auxt = walk(pt, simt.scene, simt.config, W, H, 24,
                        state_from_numpy(TO_NP(s), "cpu"))
    assert rt.shape == rec.shape and wt.shape == words.shape
    np.testing.assert_array_equal(wt.numpy(), np.asarray(words))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rec), rtol=1e-5, atol=1e-4)
    assert (rt.numpy() != np.asarray(rec)).mean() < 0.01
    skt = sky_image(pt, simt.scene, simt.config, W, H, T(aux["sy"]), T(aux["cy"]),
                    T(aux["sp"]), T(aux["cp"]))
    np.testing.assert_array_equal(skt.numpy(), np.asarray(sky))


def test_peel_resolve_ref_matches_pallas_interpret():
    """(d) B3's plain version vs peel_resolve_pallas(interpret) with
    tile_p=256, chunk_t=64 (as tests/test_pallas.py runs it)."""
    from tpu_doom.ops.raster_pallas import (
        pack_triangle_attrs,
        pack_triangle_rows_full,
        peel_resolve_pallas,
    )
    from tpu_doom.render.raster_jnp import _pixel_grid, _prepare_env

    from tpu_doom_torch.ops.raster import peel_resolve_ref

    W, H = 64, 24
    sim = JaxSim(GameConfig(wad_file=":test:", raster_backend="jnp"))
    cfg = sim.config
    s = sim.reset(2)._replace(
        pos=jnp.asarray([[-2.2, 0.2, -8.8], [-3.5, 1.0, -9.0]], jnp.float32),
        yaw=jnp.asarray([0.9, 0.0], jnp.float32),
        pitch=jnp.asarray([0.3, 1e-8], jnp.float32),
    )
    @jax.jit
    def inputs(s):
        with jax.default_matmul_precision("highest"):
            prep = jax.vmap(lambda p, y, pi, o, t: _prepare_env(
                sim.scene, cfg, W, H, p, y, pi, o, t))(
                    s.pos, s.yaw, s.pitch, s.object_offset, s.time)
            rows = pack_triangle_rows_full(prep["e"], prep["det"], prep["vz"],
                                           prep["vs"], prep["v_tile_uv_tri"])
        lv = jnp.take_along_axis(prep["lights_f"], jnp.clip(
            prep["v_light_tri"], 0, prep["lights_f"].shape[-1] - 1), axis=-1)
        attrs = pack_triangle_attrs(
            prep["v_tile_size_tri"], prep["v_atlas_a_tri"], prep["v_atlas_b_tri"],
            lv, prep["tri_pass"], prep["transparent"], prep["det"])
        yb = prep["tri_ybounds"]
        order = jnp.argsort(yb[..., 0], axis=-1)[..., None]
        return (jnp.take_along_axis(rows, order, axis=1),
                jnp.take_along_axis(attrs, order, axis=1),
                jnp.take_along_axis(yb, order, axis=1))

    rows, attrs, yb = inputs(s)
    grid = _pixel_grid(W, H)
    want = np.asarray(peel_resolve_pallas(rows, attrs, grid, yb, 3, tile_p=256,
                                          chunk_t=64, interpret=True))
    got = peel_resolve_ref(T(rows), T(attrs), T(grid), T(yb), 3, tile_p=256,
                           chunk_t=64).numpy()
    for c in (11, 12, 13):  # pass, transparent, has
        np.testing.assert_array_equal(got[:, :, c], want[:, :, c])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # Floats: within 1e-5 relative except where XLA's fused multiply-adds
    # meet cancelling terms in the perspective interpolation (measured:
    # 14 of 237815 values, worst 2.9e-4 of a texel); those stay < 1e-3.
    g, w = got[fin], want[fin]
    off = ~np.isclose(g, w, rtol=1e-5, atol=1e-5)
    assert off.mean() <= 1e-4, off.sum()
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    assert want[:, 0, 13].mean() > 0.5  # the first layer covers the frame


W_P, H_P = 100, 64
POSES = [
    # tests/test_portal.py:30-42: (name, pos, yaw, time, door, lift).
    ("start", [-2.56, 0.5, -2.24], 0.0, 0.0, 0.0, 0.0),
    ("corridor_door", [-2.56, 0.33, -5.4], 0.0, 0.4, 0.0, 0.0),
    ("door_half_open", [-2.56, 0.33, -5.4], 0.0, 0.0, 0.5, 0.0),
    ("big_room_sky", [-2.2, 0.2, -8.8], 0.9, 1.25, 0.0, 0.0),
    ("nukage_anim", [-1.9, 0.2, -8.2], 0.0, 8.0 / 35.0 + 1e-3, 0.0, 0.0),
    ("grate", [-3.5, 1.0, -9.0], 0.0, 0.4, 0.0, 0.0),
    ("barrel", [-3.8, 0.0, -9.8], 0.0, 0.0, 0.0, 0.0),
    ("lift_down", [-2.56, 0.2, -12.0], 0.0, 0.0, 0.0, -0.64),
    ("scroll_wall", [-2.56, 0.33, -2.5], math.pi, 0.5, 0.0, 0.0),
    ("flicker", [-3.84, 0.0, -10.9], math.pi, 0.24, 0.0, 0.0),
]
# Measured port-vs-portal_jnp mismatches at 100x64: 2 px on lift_down and
# on flicker, 0 elsewhere; ceilings leave headroom and stay <= 16.
PORTAL_CEILING = {name: 0 for name, *_ in POSES}
PORTAL_CEILING.update(lift_down=6, flicker=6)


def test_doomsim_portal_frames_match_jax():
    """(e) The port's DoomSim (portal) vs JAX portal_jnp on the POSES."""
    B = len(POSES)
    kw = dict(wad_file=":test:", width=W_P, height=H_P, batch_size=B)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", render_env_chunk=0, **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", **kw), "cpu")
    s = simj.reset(B)
    oo = np.zeros(s.object_offset.shape, np.float32)
    for i, p in enumerate(POSES):
        oo[i, 1], oo[i, 2] = p[4], p[5]
    s = s._replace(
        pos=jnp.asarray([p[1] for p in POSES], jnp.float32),
        yaw=jnp.asarray([p[2] for p in POSES], jnp.float32),
        time=jnp.asarray([p[3] for p in POSES], jnp.float32),
        object_offset=jnp.asarray(oo),
    )
    ij, cj = (np.asarray(x) for x in simj.render(s))
    it, ct = simt.render(state_from_numpy(TO_NP(s), "cpu"))
    assert it.dtype == torch.uint8 and ct.dtype == torch.bool
    for i, (name, *_) in enumerate(POSES):
        n = int((it[i].numpy() != ij[i]).sum())
        assert n <= PORTAL_CEILING[name] <= 16, (name, n)
        assert int((ct[i].numpy() != cj[i]).sum()) <= PORTAL_CEILING[name], name


def test_chunked_render_matches_jax_chunked_render():
    """`render_env_chunk=4` on the POSES (10 envs: a ragged last slice,
    which JAX pads by repeating its last env and the port renders as it
    is) in both packages: within the ceilings of the unchunked test."""
    B = len(POSES)
    kw = dict(wad_file=":test:", width=W_P, height=H_P, batch_size=B,
              render_env_chunk=4)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", **kw), "cpu")
    s = simj.reset(B)
    oo = np.zeros(s.object_offset.shape, np.float32)
    for i, p in enumerate(POSES):
        oo[i, 1], oo[i, 2] = p[4], p[5]
    s = s._replace(
        pos=jnp.asarray([p[1] for p in POSES], jnp.float32),
        yaw=jnp.asarray([p[2] for p in POSES], jnp.float32),
        time=jnp.asarray([p[3] for p in POSES], jnp.float32),
        object_offset=jnp.asarray(oo),
    )
    ij, cj = (np.asarray(x) for x in simj.render(s))
    it, ct = simt.render(state_from_numpy(TO_NP(s), "cpu"))
    assert it.shape == (B, H_P, W_P)
    for i, (name, *_) in enumerate(POSES):
        assert int((it[i].numpy() != ij[i]).sum()) <= PORTAL_CEILING[name], name
        assert int((ct[i].numpy() != cj[i]).sum()) <= PORTAL_CEILING[name], name


CHUNK_CASES = [
    # (wad, backend, extra, whether some env takes the triangle fallback)
    (":test:", "portal", {}, False),
    (":test:", "portal_jnp", {}, False),
    (":test:", "jnp", {}, False),
    (":test:", "portal", dict(portal_pitch="triangle"), True),
    (":test:", "portal_jnp", dict(portal_compact_crossings=1), True),
    (":texstress:", "portal", {}, False),
    (":texstress:", "portal", dict(portal_global_segs_max=1024), False),
]


@pytest.mark.parametrize("wad, backend, extra, falls", CHUNK_CASES)
def test_render_env_chunk_equals_one_piece(monkeypatch, wad, backend, extra, falls):
    """`render_env_chunk=2` renders 5 envs as slices of 2, 2 and 1 through
    DoomSim.render: bitwise the frames of `render_env_chunk=0`, on every
    backend, the triangle fallback inside a slice included (pitched envs
    under portal_pitch="triangle"; crossing overflow under portal_jnp)."""
    import dataclasses

    from tpu_doom_torch.render import portal as P

    sim = TorchSim(TorchConfig(wad_file=wad, width=64, height=40, batch_size=5,
                               raster_backend=backend, render_env_chunk=0, **extra),
                   "cpu")
    s = sim.reset()._replace(yaw=torch.tensor([0.0, 1.3, 2.6, 3.9, 5.2]),
                             pitch=torch.tensor([1e-8, 0.3, 1e-8, -0.2, 1e-8]))
    i0, c0 = sim.render(s)
    fallback_envs = []
    real = P.render_frames

    def spy(scene, cfg, sub, width, height):
        fallback_envs.append(sub.pos.shape[0])
        return real(scene, cfg, sub, width, height)

    monkeypatch.setattr(P, "render_frames", spy)
    sim.config = dataclasses.replace(sim.config, render_env_chunk=2)
    i2, c2 = sim.render(s)
    assert torch.equal(i2, i0) and torch.equal(c2, c0)
    assert float(c0.float().mean()) > 0.9
    if backend.startswith("portal"):
        assert bool(fallback_envs) == falls, fallback_envs
        assert all(n <= 2 for n in fallback_envs)


def test_tpu_layout_knobs_change_no_frame():
    """`portal_tile_h` and `render_group_unroll` have no effect on the
    port: non-default values, chunked or not, give the default frames."""
    import dataclasses

    sim = TorchSim(TorchConfig(wad_file=":test:", width=64, height=40, batch_size=3,
                               raster_backend="portal"), "cpu")
    s = sim.reset()._replace(yaw=torch.tensor([0.0, 2.0, 4.0]))
    i0, c0 = sim.render(s)
    for extra in (dict(portal_tile_h=32), dict(render_group_unroll=1),
                  dict(portal_tile_h=8, render_group_unroll=4, render_env_chunk=2)):
        sim.config = dataclasses.replace(sim.config, **extra)
        i, c = sim.render(s)
        assert torch.equal(i, i0) and torch.equal(c, c0), extra


def test_verify_ref_poses_within_ceiling():
    """The 8 verify poses at 320x200 vs the JAX-made verify_ref.npz that
    chip_smoke.py holds the card to (<= 16 px per pose)."""
    with np.load(os.path.join(GOLDEN, "verify_ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    sim = TorchSim(TorchConfig(wad_file=":test:", width=320, height=200,
                              batch_size=8, raster_backend="portal",
                              portal_crossings=12), "cpu")
    s = sim.reset(8)._replace(**{k: torch.as_tensor(ref[k]) for k in (
        "pos", "yaw", "time", "pitch", "object_offset")})
    idx, cov = sim.render(s)
    for i in range(8):
        assert int((idx[i].numpy() != ref["idx"][i]).sum()) <= 16, i
        assert int((cov[i].numpy() != ref["cov"][i]).sum()) <= 16, i


# Measured triangle-path mismatches vs frames.npz: big_room (pitched) 2 px.
GOLDEN_CEILING = {"start": 0, "big_room": 4, "door_half_open": 0, "grate": 0}


@pytest.mark.parametrize("name", sorted(GOLDEN_CEILING))
def test_triangle_path_hits_goldens(name):
    """(e) The triangle path (B3's plain version here) vs frames.npz,
    scenarios of tests/golden/regen.py restated as literals."""
    sim = TorchSim(TorchConfig(wad_file=":test:", raster_backend="auto"), "cpu")
    s = sim.reset(1)
    if name == "big_room":
        s = s._replace(pos=torch.tensor([[-2.2, 0.2, -8.8]]), yaw=torch.tensor([0.9]),
                       pitch=torch.tensor([0.3]), time=torch.tensor([1.25]))
    elif name == "door_half_open":
        oo = s.object_offset.clone()
        oo[0, 1] = 0.5
        s = s._replace(pos=torch.tensor([[-2.56, 0.33, -5.4]]), object_offset=oo)
    elif name == "grate":
        s = s._replace(pos=torch.tensor([[-3.5, 1.0, -9.0]]), time=torch.tensor([0.4]))
    idx, cov = sim.render(s, 160, 100)
    with np.load(os.path.join(GOLDEN, "frames.npz")) as g:
        np.testing.assert_array_equal(cov[0].numpy(), g[f"{name}_cov"])
        n = int((idx[0].numpy() != g[f"{name}_idx"]).sum())
    assert n <= GOLDEN_CEILING[name], n


def test_triangle_fallback_renders_pitched_envs():
    """portal_pitch='triangle': pitched envs take the triangle path and
    equal a triangle-only render; unpitched ones stay on the portal path."""
    kw = dict(wad_file=":test:", width=64, height=40, batch_size=2)
    simp = TorchSim(TorchConfig(raster_backend="portal", portal_pitch="triangle", **kw), "cpu")
    simt = TorchSim(TorchConfig(raster_backend="auto", **kw), "cpu")
    s = simp.reset(2)._replace(
        pos=torch.tensor([[-2.2, 0.2, -8.8]] * 2), yaw=torch.tensor([0.9, 0.9]),
        pitch=torch.tensor([0.4, 1e-8]))
    ip, cp = simp.render(s)
    it, ct = simt.render(s)
    assert torch.equal(ip[0], it[0]) and torch.equal(cp[0], ct[0])
    assert bool(cp[1].all())  # the unpitched env stays on the portal path


def test_frames_to_rgb_clear_colour():
    from tpu_doom_torch.render import frames_to_rgb

    palette = torch.arange(256 * 3, dtype=torch.int32).reshape(256, 3).to(torch.uint8)
    idx = torch.tensor([[[1, 2]]], dtype=torch.uint8)
    cov = torch.tensor([[[True, False]]])
    rgb = frames_to_rgb(palette, idx, cov)
    assert rgb[0, 0, 0].tolist() == palette[1].tolist()
    assert rgb[0, 0, 1].tolist() == [15, 17, 22]


def test_doom2_portal_frames_match_jax():
    """The Doom2-format fixture (141 walk rows, still the small-level
    branch) through both packages' portal paths: within 16 px per env."""
    kw = dict(wad_file=":doom2:", width=64, height=40, batch_size=2)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", render_env_chunk=0, **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", **kw), "cpu")
    s = simj.reset(2)
    s = s._replace(yaw=jnp.asarray([0.0, 2.0], jnp.float32))
    ij, cj = (np.asarray(x) for x in simj.render(s))
    it, ct = simt.render(state_from_numpy(TO_NP(s), "cpu"))
    for e in range(2):
        assert int((it[e].numpy() != ij[e]).sum()) <= 16, e
        assert int((ct[e].numpy() != cj[e]).sum()) <= 16, e


def test_stress_level_renders_through_big_walk():
    """:stress: (962 walk rows) renders through the big-level walk: the
    visible-seg cull and B4's plain version (crossing compaction is off
    there), within 16 px of JAX portal_jnp per env."""
    kw = dict(wad_file=":stress:", width=32, height=20, batch_size=2)
    simj = JaxSim(GameConfig(raster_backend="portal_jnp", render_env_chunk=0, **kw))
    simt = TorchSim(TorchConfig(raster_backend="portal", **kw), "cpu")
    assert simt.portal_scene()["has_back"].shape[0] > 192
    s = simj.reset(2)._replace(yaw=jnp.asarray([0.0, 2.2], jnp.float32))
    ij, cj = (np.asarray(x) for x in simj.render(s))
    it, ct = simt.render(state_from_numpy(TO_NP(s), "cpu"))
    for e in range(2):
        assert int((it[e].numpy() != ij[e]).sum()) <= 16, e
        assert int((ct[e].numpy() != cj[e]).sum()) <= 16, e


def _hires_pose(target, backend):
    """One pose of a golden above 320x200 through the port on the CPU ->
    (idx, cov, ref idx, ref cov), (n, H, W) each."""
    from tpu_doom_torch.utils.config import PlayerConfig

    if target == "640x400":  # verify pose 2: the big room, its sky and a sprite
        with np.load(os.path.join(GOLDEN, "verify_640x400_ref.npz")) as z:
            ref = {k: z[k][2:3] for k in z.files}
        sim = TorchSim(TorchConfig(wad_file=":test:", width=640, height=400, batch_size=1,
                                   raster_backend=backend, portal_crossings=12), "cpu")
        s = sim.reset(1)._replace(**{k: torch.as_tensor(ref[k]) for k in (
            "pos", "yaw", "time", "pitch", "object_offset")})
        return (*sim.render(s), ref["idx"], ref["cov"])
    if target == "doom2":  # MAP01 pose 0: its three sprites at 800x600
        with np.load(os.path.join(GOLDEN, "verify_doom2_ref.npz")) as z:
            ref = {k: z[k][0:1] for k in z.files if k.startswith("map01")}
        sim = TorchSim(TorchConfig(wad_file=":doom2:", width=800, height=600, batch_size=1,
                                   raster_backend=backend), "cpu")
        s = sim.reset(1)._replace(**{k: torch.as_tensor(ref[f"map01_{k}"]) for k in (
            "pos", "yaw", "pitch", "time")})
        return (*sim.render(s), ref["map01_idx"], ref["map01_cov"])
    # The bank verify leg: env 0 of E1M1 and of MAP01 on the padded tables.
    from tpu_doom_torch.tools.banks import BANK5, make_bank

    with np.load(os.path.join(GOLDEN, "verify_bank_ref.npz")) as z:
        ref = {k: z[k][:, 0:1] for k in z.files}
    bank = make_bank(BANK5[0:1] + BANK5[2:3], "cpu", raster_backend=backend,
                        player=PlayerConfig(clip_substeps=1))
    s = bank.reset(1)
    np.testing.assert_array_equal(s.pos.numpy(), ref["pos"])
    idx, cov = bank.render(s._replace(yaw=torch.as_tensor(ref["yaw"])))
    return (idx.flatten(0, 1), cov.flatten(0, 1), ref["idx"].reshape(2, 400, 640),
            ref["cov"].reshape(2, 400, 640))


@pytest.mark.parametrize("backend", ["portal", "portal_jnp"])
@pytest.mark.parametrize("target", ["640x400", "bank", "doom2"])
def test_hires_golden_pose_within_ceiling(target, backend):
    """The port's plain path against the JAX-made goldens above 320x200
    that chip_smoke.py holds the card to (tests/golden/regen_torch_ref.py),
    one pose per target (per level for the bank): <= 16 px per pose."""
    idx, cov, ref_idx, ref_cov = _hires_pose(target, backend)
    assert idx.shape == ref_idx.shape
    for i in range(idx.shape[0]):
        assert int((idx[i].numpy() != ref_idx[i]).sum()) <= 16, i
        assert int((cov[i].numpy() != ref_cov[i]).sum()) <= 16, i
