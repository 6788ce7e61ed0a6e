"""Regenerate the reference frames the PyTorch port is held to on a GPU.

Run from the repo root (JAX on the CPU):
    JAX_PLATFORMS=cpu python tests/golden/regen_torch_ref.py [test|texstress]
(no argument writes both files). Each renders 8 states through the JAX
package's `portal_jnp` path at 320x200:
* verify_ref.npz: the 8 feature-covering verify poses of bench.py on
  :test: (walls, flats, sky, door, lift, sprite, masked middle, scroll,
  pitch shear): the poses' state fields and the (8, 200, 320)
  palette-index and coverage frames;
* verify_texstress_ref.npz: the 8 states of bench.py's :texstress:
  verify leg (yaws from numpy's default_rng(7), 24 ticks walking
  forward with clip_substeps=1, env 1 pitched 0.3): every SimState
  field, and the portal_jnp frames made two ways: `idx`/`cov` with each
  stage of the render compiled as its own program (walk, alpha mask,
  classify, shade: the stages the port has), and `idx_fused`/
  `cov_fused` from DoomSim.render, one compiled program. On this level
  the two JAX renders disagree on two of the 8 envs (74 and 95 px, in a
  floor strip on the CPU); the port is held to the staged frames, and
  the script prints the disagreement.
`chip_smoke.py` reads them with numpy alone (no JAX on the GPU machine).
"""

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# (pos, time, door offset, lift offset, yaw, pitch): bench.py:57-78.
POSES = [
    ([-2.56, 0.5, -2.24], 0.0, 0.0, 0.0, 0.0, 0.0),
    ([-2.56, 0.33, -5.4], 0.0, 0.4, 0.5, 0.0, 0.0),
    ([-2.2, 0.2, -8.8], 0.9, 1.25, 0.0, 0.0, 0.0),
    ([-3.5, 1.0, -9.0], 0.0, 0.4, 0.0, 0.0, 0.0),
    ([-3.8, 0.0, -9.8], 0.0, 0.0, 0.0, 0.0, 0.0),
    ([-2.56, 0.2, -12.0], 0.0, 0.0, 0.0, -0.64, 0.0),
    ([-2.56, 0.33, -2.5], 3.14159, 0.5, 0.0, 0.0, 0.0),
    ([-2.2, 0.2, -8.8], 0.9, 1.25, 0.0, 0.0, -0.35),
]
WIDTH, HEIGHT, CROSSINGS = 320, 200, 12
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "verify_ref.npz")
OUT_TEXSTRESS = os.path.join(HERE, "verify_texstress_ref.npz")


def verify_states(sim):
    """The bench verify poses as a JAX SimState (bench.py:57-78 layout:
    pose tuple = (pos, yaw, time, door, lift, pitch))."""
    state = sim.reset(len(POSES))
    oo = np.zeros((len(POSES), state.object_offset.shape[1]), np.float32)
    for i, p in enumerate(POSES):
        oo[i, 1], oo[i, 2] = p[3], p[4]
    return state._replace(
        pos=jnp.asarray([p[0] for p in POSES], jnp.float32),
        yaw=jnp.asarray([p[1] for p in POSES], jnp.float32),
        time=jnp.asarray([p[2] for p in POSES], jnp.float32),
        pitch=jnp.asarray([p[5] or 1e-8 for p in POSES], jnp.float32),
        object_offset=jnp.asarray(oo),
    )


def write_test_ref():
    from tpu_doom.models import DoomSim
    from tpu_doom.utils.config import GameConfig, PlayerConfig

    sim = DoomSim(GameConfig(
        wad_file=":test:", width=WIDTH, height=HEIGHT, batch_size=len(POSES),
        raster_backend="portal_jnp", portal_crossings=CROSSINGS,
        render_env_chunk=0, player=PlayerConfig(clip_substeps=1),
    ))
    state = verify_states(sim)
    idx, cov = sim.render(state)
    np.savez_compressed(
        OUT, idx=np.asarray(idx), cov=np.asarray(cov),
        pos=np.asarray(state.pos), yaw=np.asarray(state.yaw),
        time=np.asarray(state.time), pitch=np.asarray(state.pitch),
        object_offset=np.asarray(state.object_offset),
    )
    print("wrote", OUT)


def portal_jnp_staged(sim, state, width, height):
    """The JAX package's portal_jnp render with every stage compiled on
    its own (tpu_doom/render/portal.py:1499-1611 and :1460-1497): the
    walk, the alpha mask, the classify and the shade, each one jitted
    program, then the triangle path for overflowed envs."""
    from tpu_doom.render import portal as jp
    from tpu_doom.render.raster_jnp import render_frames

    cfg, scene, ps = sim.config, sim.scene, sim._get_portal_scene()
    W, H = width, height
    p11 = 1.0 / np.tan(np.radians(cfg.fov) / 2.0)
    hc = ps["alpha_meta"][0]
    rec, words, aux = jax.jit(jax.vmap(lambda p, y, pi, o, t: jp._walk_env(
        ps, scene, cfg, W, H, int(cfg.portal_crossings), p, y, pi, o, t)))(
            state.pos, state.yaw, state.pitch, state.object_offset, state.time)
    mask = jax.jit(jax.vmap(lambda r, w, cy, sh: jp._alpha_mask_env(
        r, w, H, cy, p11, hc, sh)))(rec, words, aux["cam"][:, 1], aux["shear"])
    ch = jax.jit(jax.vmap(lambda r, m: jp._classify_jnp(r, m, H)))(rec, mask)

    def shade(ch_e, cam, d, sy, cy, sp, cp, sh, off, t):
        aux_e = dict(cam=cam, d=d, sy=sy, cy=cy, sp=sp, cp=cp, shear=sh)
        return jp._shade_portal(ps, scene, cfg, W, H, ch_e, aux_e, off, t)

    idx, cov = (np.asarray(x) for x in jax.jit(jax.vmap(shade))(
        ch, aux["cam"], aux["d"], aux["sy"], aux["cy"], aux["sp"], aux["cp"],
        aux["shear"], state.object_offset, state.time))
    fall = np.asarray(aux["overflow"])
    if fall.any():
        tri = dataclasses.replace(cfg, raster_backend="jnp")
        idx_t, cov_t = (np.asarray(x) for x in render_frames(scene, tri, state, W, H))
        idx, cov = np.where(fall[:, None, None], idx_t, idx), np.where(
            fall[:, None, None], cov_t, cov)
    return idx, cov


def write_texstress_ref():
    """bench.py:116-134 (`_verify_texstress_leg`), shipped defaults."""
    from tpu_doom.models import DoomSim
    from tpu_doom.utils.config import GameConfig, PlayerConfig

    b = 8
    sim = DoomSim(GameConfig(
        wad_file=":texstress:", width=WIDTH, height=HEIGHT, batch_size=b,
        raster_backend="portal_jnp", render_env_chunk=0,
        player=PlayerConfig(clip_substeps=1),
    ))
    rng = np.random.default_rng(7)
    state = sim.reset(b)
    state = state._replace(
        yaw=jnp.asarray(rng.uniform(0, 6.28, b).astype(np.float32)))
    acts = sim.null_actions(b)._replace(
        movement=jnp.asarray(np.tile([[0.0, 1.0]], (b, 1)).astype(np.float32)))
    seq = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (24,) + x.shape), acts)
    state = sim.step_n(state, seq, 24)
    state = state._replace(pitch=state.pitch.at[1].set(0.3))
    idx, cov = portal_jnp_staged(sim, state, WIDTH, HEIGHT)
    idx_f, cov_f = (np.asarray(x) for x in sim.render(state))
    np.savez_compressed(
        OUT_TEXSTRESS, idx=idx, cov=cov, idx_fused=idx_f, cov_fused=cov_f,
        **{k: np.asarray(v) for k, v in state._asdict().items()},
    )
    print("wrote", OUT_TEXSTRESS, "; one-program render vs staged, px per env:",
          (idx_f != idx).sum(axis=(1, 2)).tolist(), "cov:",
          (cov_f != cov).sum(axis=(1, 2)).tolist())


def main(argv):
    which = argv[1:] or ["test", "texstress"]
    for name in which:
        {"test": write_test_ref, "texstress": write_texstress_ref}[name]()


if __name__ == "__main__":
    main(sys.argv)
