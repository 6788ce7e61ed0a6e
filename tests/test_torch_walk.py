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
  overflow, the one with two does not;
* the big-level walk (more than 192 walk rows: the visible-seg cull,
  then W2 on every crossing) on `:texstress:10x16` at the defaults, where
  W2 reads kernel B4's selection (JAX's walk selects through
  `select_rows_pallas` in interpret mode), and under
  `portal_compact_crossings=4`, where W2 compacts and reads the table;
* `:test:` at times up to 12.2 s with the movable objects' offsets drawn
  from a seeded numpy generator (the animation, scroll and offset columns
  of the attribute table).

Along the bench's trajectory (`:stress:6`, 2 envs, 74 ticks at 320x200)
the envs whose walk overflows, tick by tick, equal those of `_walk_env`
as the JAX package's root tool tools/fallbackrate.py evaluates them.

The attribute table, the rows' endpoints and the visible-row cull (W0's
plain version, `render/portal.py:walk_table_ref`) are held bitwise to
the JAX walk's own: the subprocess records them as `_walk_env` builds
them (its `jnp.stack` of the 74 columns, the endpoints' two
`jnp.concatenate`, the cull's `jnp.argsort` and one-hot select), with
`jnp` in `tpu_doom/render/portal.py` replaced for the run by a proxy that
passes every call through.
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
BIG_POSES = [(None, None, 0.0, 0.0, 0.0), (None, None, 2.2, 0.2, 0.5),
             (None, None, -1.3, 0.0, 1.0), (None, None, 0.9, -0.3, 2.0)]
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
    "texstress": (":texstress:10x16", 0, {}, BIG_POSES),
    "texstress_compact": (":texstress:10x16", 0, dict(portal_compact_crossings=4), BIG_POSES),
    "offsets": (":test:", 0, {}, [(-2.2, -8.8, 0.9, 0.0, 0.3), (-3.5, -9.0, 0.0, 0.2, 1.7),
                                  (-3.8, -9.8, 2.1, 0.0, 5.0), (-1.9, -8.2, 0.0, 0.0, 12.2)]),
}
OFFSETS_SEED = {"offsets": 0}  # groups whose object offsets are drawn, with their seed
SELECT = {"texstress": "interpret"}  # JAX's walk selects through B4's Pallas kernel
# case -> (group, its envs)
CASES = {"test": ("test", slice(0, 3)), "few_crossings": ("test", slice(3, 4)),
         "tie": ("test", slice(4, 5)), "doom2": ("doom2", slice(None)),
         "bank": ("bank", slice(None)), "overflow": ("overflow", slice(None)),
         "texstress": ("texstress", slice(None)),
         "texstress_compact": ("texstress_compact", slice(None)),
         "offsets": ("offsets", slice(None))}
TIE_COLUMN = 31  # the tie pose's column through the corner


def _config(mod, wad, level, extra):
    """The case's GameConfig from config module `mod` (either package's)."""
    if wad == "bank":
        wad, level = ":test:", 0
    return mod.GameConfig(wad_file=wad, initial_level_index=level, width=W, height=H,
                          raster_backend="portal", render_env_chunk=0, **extra)


class _TableSpy:
    """Stands in for `jnp` in the JAX walk's module: passes every call
    through, and while `log` is a dict records the attribute table (the
    stack of 74 columns), then the rows' endpoints (the next two
    concatenations) and the cull's argsort (its input and output) and
    one-hot select of (p1, p2, table)."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.log = None

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def stack(self, arrays, axis=0, **kw):
        out = self._jnp.stack(arrays, axis=axis, **kw)
        if self.log is not None and len(arrays) == 74 and "table" not in self.log:
            self.log["table"] = out
        return out

    def concatenate(self, arrays, axis=0, **kw):
        out = self._jnp.concatenate(arrays, axis=axis, **kw)
        if self.log is not None and "table" in self.log and len(self.log.get("ends", ())) < 2:
            self.log.setdefault("ends", []).append(out)
        return out

    def argsort(self, a, **kw):
        out = self._jnp.argsort(a, **kw)
        if self.log is not None and "table" in self.log and "argsort" not in self.log:
            self.log["argsort_in"], self.log["argsort"] = a, out
        return out

    def einsum(self, spec, *operands, **kw):
        out = self._jnp.einsum(spec, *operands, **kw)
        if self.log is not None and spec == "vs,sc->vc":
            self.log["selv"] = out
        return out


def _jax_walks(out_path):
    """Subprocess body: every case's states, JAX walk and attribute table
    into out_path."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import tpu_doom.render.portal as JP
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
        if case in OFFSETS_SEED:
            rng = np.random.default_rng(OFFSETS_SEED[case])
            s = s._replace(object_offset=jnp.asarray(rng.uniform(
                -0.6, 0.6, s.object_offset.shape).astype(np.float32)))
        n_cross = int(cfg.portal_crossings)
        spy = _TableSpy(jnp)

        def walk_env(p, y, pi, o, t):
            spy.log = {}
            try:
                rec, words, aux = _walk_env(ps, scene, cfg, W, H, n_cross, p, y, pi, o, t,
                                            select_kernel=SELECT.get(case, ""))
            finally:
                log, spy.log = spy.log, None
            if "selv" in log:  # the cull: the kept rows' (p1, p2, table)
                sv = log["selv"]
                tab = dict(p1=sv[:, :2], p2=sv[:, 2:4], table=sv[:, 4:],
                           order=log["argsort"],
                           visible=jnp.sum(log["argsort_in"] == 0))
            else:
                tab = dict(p1=log["ends"][0], p2=log["ends"][1], table=log["table"])
            return rec, words, aux, tab

        JP.jnp = spy
        try:
            rec, words, aux, tab = jax.jit(jax.vmap(walk_env))(
                s.pos, s.yaw, s.pitch, s.object_offset, s.time)
        finally:
            JP.jnp = jnp
        out[f"{case}/records"] = np.asarray(rec)
        out[f"{case}/words"] = np.asarray(words)
        out[f"{case}/overflow"] = np.asarray(aux["overflow"])
        for k, v in tab.items():
            out[f"{case}/walk_table/{k}"] = np.asarray(v)
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
    W1's outputs, the portal scene and the arguments the walk gave W1 and
    W2."""
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
        rec, words, aux = P.walk(pt, scene, cfg, W, H, int(cfg.portal_crossings), state)
    finally:
        for n, f in origs.items():
            setattr(P, n, f)
    cross, recs = calls["walk_cross"][0], calls["walk_records"][0]
    return rec, words, aux, Wk.walk_cross_ref(*cross), pt, calls["walk_table"][0], cross, recs


@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_jax_bitwise(jax_walks, case):
    group, envs = CASES[case]
    rec, words, aux, cross, pt, _, _, recs = _port_walk(group, jax_walks)
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
    if case.startswith("texstress"):  # the big-level walk: W2 from B4's selection or the table
        sel = case == "texstress"
        assert pt["has_back"].shape[0] > 192 and rec.shape[1] == 5 * (K if sel else 4)
        assert (recs[16] is not None) == sel and (recs[8] is None) == sel


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("group", list(GROUPS))
def test_walk_table_matches_jax_bitwise(jax_walks, group):
    """W0's plain version (`walk_table_ref`, on the arguments the port's
    walk gives W0) against the JAX walk's own attribute table, endpoints
    and cull, bitwise: the table (B, SD', 74) and p1, p2 as int32 bits;
    on big levels the kept rows `ordv` equal to the first SV of JAX's
    stable argsort, the visible-row count to JAX's visible count and the
    overflow to that count > SV. The
    level's `walk_static` equals the table's STATIC_COLS, the columns it
    replaces, in every env (at the kept rows under the cull, `+ 0.0`)."""
    from tpu_doom_torch.ops.walk import C_CA, STATIC_COLS
    from tpu_doom_torch.render.portal import walk_table_ref

    *_, pt, targs, _, _ = _port_walk(group, jax_walks)
    table, p1, p2, ordv, overflow, n_vis = walk_table_ref(*targs)
    want = np.load(jax_walks)
    key = f"{group}/walk_table/"
    for name, got in (("table", table), ("p1", p1), ("p2", p2)):
        assert got.shape == want[key + name].shape, name
        got, exp = got.numpy(), want[key + name]
        diff = _bits(got) != _bits(exp)
        if name == "table":
            # One deviation, XLA's: on rows whose ceiling atlas is all
            # zeros, its base v `ay + n_rows * row_h` is 0 + (-1 * 0) =
            # +0.0 in IEEE (here and on the card), and the compiled JAX
            # walk gives -0.0. Only there, and only the sign of a zero.
            off = diff[..., C_CA + 1]
            assert bool((got[..., C_CA + 1][off] == 0.0).all())
            assert bool((exp[..., C_CA + 1][off] == 0.0).all())
            diff[..., C_CA + 1] = False
        assert not diff.any(), (name, np.argwhere(diff)[:8])
    sv = targs[10]
    cull = key + "order" in want.files
    assert (sv > 0) == cull == (ordv is not None)
    assert cull == group.startswith("texstress")
    static = pt["walk_static"]
    if cull:
        np.testing.assert_array_equal(ordv.numpy(), want[key + "order"][:, :sv])
        np.testing.assert_array_equal(overflow.numpy(), want[key + "visible"] > sv)
        np.testing.assert_array_equal(n_vis.numpy(), want[key + "visible"])
        static = static[ordv] + 0.0  # (B, SV, 40)
    else:
        assert not bool(overflow.any()) and n_vis is None
    np.testing.assert_array_equal(_bits(static.expand(table.shape[0], -1, -1).numpy()),
                                  _bits(table[:, :, STATIC_COLS].numpy()))
    if group == "offsets":  # the offset, animated floor and scrolled u columns move
        objoff, time_ = targs[2], targs[3]
        assert bool((objoff != 0.0).all()) and bool((time_ > 0.0).all())
        zero = walk_table_ref(targs[0], targs[1], torch.zeros_like(objoff),
                              torch.zeros_like(time_), *targs[4:])[0]
        moved = (zero != table).any(dim=(0, 1))
        from tpu_doom_torch.ops.walk import C_FA, C_FC, C_FCB, P_A, P_LOW, PIECE0
        assert all(bool(moved[c]) for c in (C_FC, C_FA, C_FCB, PIECE0 + P_LOW,
                                             PIECE0 + 16 + P_A)), moved.nonzero()


def test_walk_static_layout_is_w0s():
    """`ops.walk.STATIC_COLS` is the column list W0 was built with
    (csrc/walk_table.cu kStaticCols), and W0's level argument list is its
    `Level` struct's, field for field."""
    import re

    from tpu_doom_torch import _build
    from tpu_doom_torch.ops.walk import LEVEL_ROWS, STATIC_COLS

    src = (_build.CSRC / "walk_table.cu").read_text()
    cols = re.search(r"kStaticCols\[kStatic\] = \{([^}]*)\}", src).group(1)
    assert [int(c) for c in cols.replace("\n", " ").split(",")] == STATIC_COLS
    assert int(re.search(r"kStatic = (\d+);", src).group(1)) == len(STATIC_COLS)
    body = re.search(r"struct Level \{(.*?)\n\};", src, re.S).group(1)
    names = re.findall(r"\*\s*(\w+)", re.sub(r"//[^\n]*", "", body))
    assert len(names) == 1 + len(LEVEL_ROWS) and names[0] == "stat"
    short = {"ceil_cbase": "ceil_cb", "floor_cbase": "floor_cb", "piece_cbase": "piece_cb",
             "sprite_center": "spr_center", "sprite_half": "spr_half"}
    assert names[1:] == [short.get(k, k) for k, _ in LEVEL_ROWS]


def test_w2_selection_form_matches_table_form(jax_walks):
    """W2's plain version from B4's selection (the big-level walk's form)
    gives the same bits as from the table on the same crossings, with and
    without compaction."""
    from tpu_doom_torch.ops import walk as Wk

    *_, cross, recs = _port_walk("texstress", jax_walks)
    table = cross[4]  # the (culled) attribute table W1 read
    assert recs[8] is None and recs[16] is not None
    for kc in (0, 4):
        args = list(recs[:16])
        args[14] = kc
        from_sel = Wk.walk_records_ref(*args, sel=recs[16])
        args[8] = table
        from_table = Wk.walk_records_ref(*args)
        assert from_sel[0].shape[1] == 5 * (kc or K)
        for a, b in zip(from_sel, from_table):
            a, b = a.numpy(), b.numpy()
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                          b.view(np.int32) if b.dtype == np.float32 else b)


def test_explicit_compaction_overflow_formula(jax_walks):
    """On a big level under explicit crossing compaction W2 does the
    compaction: an env overflows where it did before W2 (the visible-seg
    cull), or where more than kc crossings are live in any column, which
    is the formula the walk applied itself before W2 took the big levels."""
    from tpu_doom_torch.ops.walk import mask_bits_to_bool

    rec, words, aux, cross, pt, _, _, recs = _port_walk("texstress_compact", jax_walks)
    mask, ovf_in, kc = recs[6], recs[7], recs[14]
    assert kc == 4 and recs[8] is not None and recs[16] is None
    want = ovf_in | (mask_bits_to_bool(mask, K).sum(dim=1) > kc)
    assert torch.equal(aux["overflow"], want)
    assert bool(want.any()) and not bool(want.all())


# The bench trajectory of the overflow check: :stress:6 x 2 envs x 74
# ticks at 320x200. Env 1 overflows at tick 73 (the walk's crossing
# compaction, 8 on this small maze), every other env-tick stays on the
# portal path, so the run holds both kinds; from reset, :texstress:10x16
# overflowed in none of 200 ticks of 16 envs at 64x40, and this was the
# earliest overflow found on the maze fixtures.
TRAJECTORY = dict(wad=":stress:6", batch=2, ticks=74)


def test_walk_overflow_matches_jax_over_the_bench_trajectory(monkeypatch):
    """The envs whose walk overflows, tick by tick along the bench's
    trajectory (`bench.bench_actions` from reset; portal, clip_substeps=1
    at 320x200, the active set where the level needs it), equal those of
    the JAX package's `_walk_env` as tools/fallbackrate.py evaluates them
    over the same ticks: the JAX tool's per-tick masks are read as it
    hands them to np.asarray."""
    from test_torch_tools import _load_jax_tool

    from tpu_doom_torch.bench import bench_actions
    from tpu_doom_torch.models import DoomSim
    from tpu_doom_torch.render.portal import active_segs, walk
    from tpu_doom_torch.utils.config import GameConfig, PlayerConfig

    wad, batch, ticks = TRAJECTORY["wad"], TRAJECTORY["batch"], TRAJECTORY["ticks"]
    mod = _load_jax_tool("fallbackrate")
    arrays = []

    class Recording:
        """numpy, with every `asarray` result kept: the tool reads each
        tick's overflow mask through np.asarray and nothing else."""

        def __getattr__(self, name):
            return getattr(np, name)

        def asarray(self, x, *args, **kw):
            arrays.append(np.asarray(x, *args, **kw))
            return arrays[-1]

    monkeypatch.setattr(mod, "np", Recording())
    for k, v in (("BENCH_WAD", wad), ("BENCH_BATCH", str(batch)), ("BENCH_TICKS", str(ticks))):
        monkeypatch.setenv(k, v)
    mod.main()
    masks = np.stack(arrays)
    assert masks.shape == (ticks, batch) and masks.dtype == bool
    assert masks.any() and not masks.all()  # both kinds of env-tick occur

    sim = DoomSim(GameConfig(wad_file=wad, width=320, height=200, batch_size=batch,
                             raster_backend="portal",
                             metadata_file=os.path.join(ROOT, "assets", "meta", "doom.toml"),
                             player=PlayerConfig(clip_substeps=1)), "cpu")
    cfg, pscene = sim.config, sim.portal_scene()
    acts, state = bench_actions(sim, batch), sim.reset(batch)
    got = []
    with torch.no_grad():
        for _ in range(ticks):
            _, _, aux = walk(pscene, sim.scene, cfg, 320, 200, int(cfg.portal_crossings),
                             state, active_segs=active_segs(pscene, cfg))
            got.append(aux["overflow"].numpy())
            state = sim.step(state, acts)
    np.testing.assert_array_equal(np.stack(got), masks)  # every env, every tick


if __name__ == "__main__":
    _jax_walks(sys.argv[1])
