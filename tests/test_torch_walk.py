"""The port's column walk (`render/portal.py:walk`, whose W1 and W2
wrappers run their plain versions on the CPU) against the JAX package's
`_walk_env` on identical states, bitwise: records and words compared as
int32 bits, overflow equal.

The JAX walk runs jitted, as `tests/test_torch_render.py:_walk_inputs`
drives it, in a subprocess whose XLA targets a CPU without fused
multiply-adds (`--xla_cpu_max_isa=SSE4_2`). On a CPU with them XLA
contracts a*b+c (the rays `fwd + right * xv`, the crossing terms) into
one rounding where the port rounds twice (ROADMAP C), which moves ~0.2 %
of the record values by an ulp; without them XLA rounds each operation
as the port does, and the two walks agree bit for bit. The states are
made with numpy in the subprocess and handed to the port.

Cases (64x40, K = 24, crossing compaction at its AUTO 8 unless stated):
* `:test:` (64 walk rows) and `:doom2:` MAP01 (141), with pitched
  (sheared) poses among them;
* config 5's E1M1 member, its tables padded to the bank's 141 rows;
* a pose facing a wall up close: fewer valid crossings than K in every
  column, so the sentinel slots' row order (whose u feeds the words)
  matters;
* a pose whose ray meets a room corner: two crossings of equal depth in
  one column, kept in row order;
* `portal_compact_crossings=2`: the envs with more live crossings
  overflow, the one with two does not.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, K = 64, 40, 24
BANK5 = ((":test:", 0), (":test:", 1), (":doom2:", 0), (":doom2:", 1))
# group -> (wad, level, config overrides, poses: (x, z, yaw, pitch,
# time)); a pose's height is the level's start height, x None keeps the
# start position. "bank" walks config 5's member `level` of the bank
# instead of the level alone.
GROUPS = {
    "test": (":test:", 0, {}, [
        (-2.2, -8.8, 0.9, -0.35, 1.25), (-3.5, -9.0, 0.0, 0.0, 0.4),
        (-3.8, -9.8, 2.1, 0.0, 0.0),
        (-2.0, -7.9, -3.1, 0.0, 0.0),  # facing a wall up close
        (-1.9988791942596436, -8.977842330932617, -3.0999999046325684, 0.0, 0.0),  # a corner
    ]),
    "doom2": (":doom2:", 0, {}, [(None, None, 0.0, 0.0, 0.0), (None, None, 1.7, 0.3, 0.5),
                                 (None, None, -2.4, 0.0, 2.0)]),
    "bank": ("bank", 0, {}, [(-2.2, -8.8, 0.9, 0.0, 1.25), (-3.5, -9.0, 3.0, -0.2, 0.4)]),
    "overflow": (":test:", 0, dict(portal_compact_crossings=2), [
        (-2.2, -8.8, 0.9, 0.0, 0.0), (-3.5, -9.0, 0.0, 0.2, 0.0),
        (-2.0, -7.9, -3.1, 0.0, 0.0)]),
}
# case -> (group, its envs)
CASES = {"test": ("test", slice(0, 3)), "few_crossings": ("test", slice(3, 4)),
         "tie": ("test", slice(4, 5)), "doom2": ("doom2", slice(None)),
         "bank": ("bank", slice(None)), "overflow": ("overflow", slice(None))}
TIE_COLUMN = 31  # the tie pose's column through the corner


def _config(mod, wad, level, extra):
    """The case's GameConfig from config module `mod` (either package's)."""
    if wad == "bank":
        wad, level = ":test:", 0
    return mod.GameConfig(wad_file=wad, initial_level_index=level, width=W, height=H,
                          raster_backend="portal", render_env_chunk=0, **extra)


def _jax_walks(out_path):
    """Subprocess body: every case's states and JAX walk into out_path."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from tpu_doom.geom.builder import compile_level
    from tpu_doom.models import DoomSim
    from tpu_doom.models.level_bank import LevelBank
    from tpu_doom.render.portal import _walk_env
    from tpu_doom.utils import config as C
    from tpu_doom.wad import wadgen
    from tpu_doom.wad.archive import Archive
    from tpu_doom.wad.meta import WadMetadata
    from tpu_doom.wad.tex import TextureDirectory

    out = {}
    for case, (wad, level, extra, poses) in GROUPS.items():
        cfg = _config(C, wad, level, extra)
        if wad == "bank":
            meta = WadMetadata.from_file(os.path.join(ROOT, "assets/meta/doom.toml"))
            builders = {":test:": wadgen.build_test_wad, ":doom2:": wadgen.build_doom2_wad}
            levels = []
            for w, lv in BANK5:
                arc = Archive(builders[w](), source=w)
                levels.append(compile_level(arc, TextureDirectory(arc, meta), meta, lv))
            bank = LevelBank(levels, cfg)
            # Level `level`'s view, cut on the host (eager slices would
            # each compile).
            scene, ps, s = jax.tree_util.tree_map(
                lambda x: np.asarray(x)[level],
                (bank.scenes, bank.pscenes, bank.reset(len(poses))))
        else:
            sim = DoomSim(cfg)
            scene, ps = sim.scene, sim._get_portal_scene()
            s = sim.reset(len(poses))
        pos = np.asarray(s.pos).copy()
        for i, (x, z, *_rest) in enumerate(poses):
            if x is not None:
                pos[i, 0], pos[i, 2] = x, z
        s = s._replace(pos=jnp.asarray(pos),
                       yaw=jnp.asarray([p[2] for p in poses], jnp.float32),
                       pitch=jnp.asarray([p[3] for p in poses], jnp.float32),
                       time=jnp.asarray([p[4] for p in poses], jnp.float32))
        n_cross = int(cfg.portal_crossings)
        rec, words, aux = jax.jit(jax.vmap(
            lambda p, y, pi, o, t: _walk_env(ps, scene, cfg, W, H, n_cross, p, y, pi, o, t)
        ))(s.pos, s.yaw, s.pitch, s.object_offset, s.time)
        out[f"{case}/records"] = np.asarray(rec)
        out[f"{case}/words"] = np.asarray(words)
        out[f"{case}/overflow"] = np.asarray(aux["overflow"])
        for field, v in s._asdict().items():
            out[f"{case}/state/{field}"] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_walks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("walk") / "jax_walks.npz")
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_cpu_max_isa=SSE4_2").strip(),
               JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), path], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return path


@functools.lru_cache(maxsize=None)
def _port_walk(case, path):
    """The port's walk of a group's states (saved at path) on the CPU,
    and W1's outputs."""
    from tpu_doom_torch.ops import walk as Wk
    from tpu_doom_torch.render import portal as P
    from tpu_doom_torch.sim.state import SimState
    from tpu_doom_torch.utils import config as C

    data = np.load(path)
    wad, level, extra, _ = GROUPS[case]
    cfg = _config(C, wad, level, extra)
    if wad == "bank":
        from tpu_doom_torch.models import LevelBank
        from tpu_doom_torch.tools.banks import bank_levels

        bank = LevelBank(bank_levels(BANK5, cfg), cfg, "cpu")
        scene, pt = bank._at(bank.scenes, level), bank._at(bank.pscenes, level)
        cfg = bank.cfg
    else:
        from tpu_doom_torch.models import DoomSim

        sim = DoomSim(cfg, "cpu")
        scene, pt, cfg = sim.scene, sim.portal_scene(), sim.config
    state = SimState(*(torch.as_tensor(data[f"{case}/state/{f}"]) for f in SimState._fields))
    calls = []
    orig = P.walk_cross

    def spy(*args):
        calls.append(args)
        return orig(*args)

    P.walk_cross = spy
    try:
        rec, words, aux = P.walk(pt, scene, cfg, W, H, int(cfg.portal_crossings), state)
    finally:
        P.walk_cross = orig
    return rec, words, aux, Wk.walk_cross_ref(*calls[0]), pt


@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_jax_bitwise(jax_walks, case):
    group, envs = CASES[case]
    rec, words, aux, cross, pt = _port_walk(group, jax_walks)
    want = np.load(jax_walks)
    rec, words, overflow = rec[envs], words[envs], aux["overflow"][envs]
    t, _, idx, live, *_ = (x[envs] for x in cross)
    want_rec = want[f"{group}/records"][envs]
    assert rec.shape == want_rec.shape
    np.testing.assert_array_equal(rec.numpy().view(np.int32), want_rec.view(np.int32))
    np.testing.assert_array_equal(words.numpy(), want[f"{group}/words"][envs])
    np.testing.assert_array_equal(overflow.numpy(), want[f"{group}/overflow"][envs])
    valid = t < 1e29
    if case == "bank":  # E1M1's 64 rows padded to 141 with zero-length rows
        S = pt["p1"].shape[0]
        pad = torch.cat([(pt["p1"] == pt["p2"]).all(dim=1), pt["sprite_half"] == 0.0])
        assert pt["has_back"].shape[0] == 141 and int(pad.sum()) == 141 - 64
        assert not pad[idx[valid].long()].any() and S == pad.shape[0] - pt["sprite_half"].shape[0]
    if case == "few_crossings":
        assert int(valid.sum(dim=1).max()) < K  # sentinel slots in every column
    if case == "tie":
        tv = t[0, :, TIE_COLUMN][valid[0, :, TIE_COLUMN]]
        ids = idx[0, :, TIE_COLUMN][valid[0, :, TIE_COLUMN]]
        tied = [j for j in range(len(tv) - 1) if tv[j] == tv[j + 1]]
        assert tied and all(ids[j] < ids[j + 1] for j in tied)
    if case == "overflow":
        assert overflow[:2].all() and not overflow[2]
    if case in ("test", "doom2"):
        assert (want[f"{group}/state/pitch"][envs] != 0.0).any()


if __name__ == "__main__":
    _jax_walks(sys.argv[1])
