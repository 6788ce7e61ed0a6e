"""The port's instruments, `tpu_doom_torch.tools.onehotbench` (B10) and
`tpu_doom_torch.tools.kernelbudget` (B11), against the JAX tools they
replace, on identical inputs (CPU: the wrappers take their plain
versions; the TPU kernels run in interpret mode, as tests/test_pallas.py
runs them). The tool files under tools/ are loaded as they are; the
kernel budget's `pl` is swapped for a proxy whose `pallas_call` passes
`interpret=True`.

Tolerances: all exact.
(a) `lookup_ref` vs onehotbench's `_kernel`: int32 row 0 of every grid
    step equal, rows past S included (they add 0 on both sides).
(b) `render_portal_ablated_ref` vs kernelbudget's `_ablated_call`, every
    variant: 0 px on idx and cov. The TPU tool's copy has no shear (zero
    pitch here) and marks a pixel done on a non-zero kind across
    crossings, where B2 marks it done on any hit; no record of kind 0
    ever covers a pixel (tests/test_torch_oracle.py (j)), so both compute
    B2's function.
(c) `render_portal_ablated_ref(ablate=())` vs `render_portal_fused_ref`:
    bitwise.
"""

import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_doom_torch.tools import kernelbudget as KB
from tpu_doom_torch.tools import onehotbench as OH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
W, H = 64, 40


def _load_jax_tool(name):
    """tools/<name>.py as a module. Importing it points JAX's compilation
    cache at the repo's TPU cache; the suite's own settings are put back."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in keep.items():
        jax.config.update(k, v)
    return mod


# ---------------------------------------------------------------------------
# (a) B10
# ---------------------------------------------------------------------------

ONEHOT_SHAPES = [(16, 256, 4, 2), (534, 256, 2, 1)]  # (S, n, iters, grid)


@pytest.fixture(scope="module")
def onehotbench_jax():
    return _load_jax_tool("onehotbench")


@pytest.mark.parametrize("shape", ONEHOT_SHAPES, ids=lambda s: "S%d_n%d_it%d_g%d" % s)
@pytest.mark.parametrize("variant", ["i32", "i16", "i8x2"])
def test_lookup_ref_matches_onehotbench_interpret(onehotbench_jax, variant, shape):
    """(a) The TPU tool's one-hot lookup (interpret mode) vs `lookup_ref`
    and the CPU wrapper for `ldg` and `smem`, on the TPU tool's inputs."""
    from jax.experimental import pallas as pl

    S, n, iters, grid = shape
    idx, tab = OH.make_inputs(S, n, "cpu")
    f = pl.pallas_call(
        functools.partial(onehotbench_jax._kernel, S=S, n=n, variant=variant,
                          iters=iters),
        grid=(grid,),
        in_specs=[pl.BlockSpec((1, n), lambda i: (0, 0)),
                  pl.BlockSpec((S, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 8, n), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, 8, n), jnp.int32),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(idx.numpy()), jnp.asarray(tab.numpy())))[:, 0]
    got = OH.lookup_ref(idx, tab, iters, grid)
    assert got.dtype == torch.int32 and got.shape == (grid, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for v in ("ldg", "smem"):
        assert torch.equal(OH.lookup(idx, tab, iters, grid, v), got)
    if S == 16:  # rows past S occur here, and add 0 on both sides
        assert int(((idx >> 7) + iters - 1 >= S).sum()) > 0


def test_lookup_copy_floor_and_refusals():
    """`copy` writes iters * (idx & 127) with no table read; the wrappers
    refuse an unknown variant and a device that is neither CPU nor CUDA."""
    idx, tab = OH.make_inputs(16, 256, "cpu")
    out = OH.lookup(idx, tab, 4, 3, "copy")
    assert torch.equal(out, ((idx & 127) * 4).expand(3, -1))
    with pytest.raises(ValueError, match="variant"):
        OH.lookup(idx, tab, 4, 3, "i32")
    with pytest.raises(ValueError, match="device"):
        OH.lookup(idx.to("meta"), tab.to("meta"), 4, 3)


# ---------------------------------------------------------------------------
# (b), (c) B11
# ---------------------------------------------------------------------------

# (pos, yaw) on :test:, zero pitch: env 0 looks at the free-standing grate
# (a masked middle texture), whose alpha test decides ~900 px; env 1 is the
# same view with the masked flag (record channel 13) cleared on its records,
# so the grate's transparent texels reach the shade's hole test. No view of
# :test: reaches a hole otherwise (64 yaws at 14 positions checked: every
# texture with holes is drawn masked), so without it `hole` would be an
# untested switch.
GRATE = ([-3.5, 1.0, -9.0], 0.0)


def _port_sky(W, H, aux, want):
    """B2's sky operands from the port (`sky_coords` of the JAX walk's
    camera terms, the u8 sky texture), held to the JAX sky image `want`
    through their gather."""
    from tpu_doom_torch.models import DoomSim
    from tpu_doom_torch.ops.raster import sky_gather
    from tpu_doom_torch.render.portal import sky_coords
    from tpu_doom_torch.utils.config import GameConfig

    sim = DoomSim(GameConfig(wad_file=":test:", width=W, height=H,
                             raster_backend="portal"), "cpu")
    sky_x, sky_y = sky_coords(sim.scene, sim.config, W, H,
                              *(T(aux[k]) for k in ("sy", "cy", "sp", "cp")))
    sky_tex = sim.portal_scene()["sky_tex"]
    np.testing.assert_array_equal(sky_gather(sky_x, sky_y, sky_tex).numpy(),
                                  np.asarray(want))
    return sky_x, sky_y, sky_tex


@pytest.fixture(scope="module")
def budget_case():
    """The JAX walk's inputs for both sides, and a cache of `_ablated_call`
    results by variant."""
    from jax.experimental import pallas as pl

    from tpu_doom.models import DoomSim
    from tpu_doom.render.portal import _sky_image, _walk_env
    from tpu_doom.utils.config import GameConfig, PlayerConfig

    kb = _load_jax_tool("kernelbudget")

    class Interpret:
        def __getattr__(self, name):
            return getattr(pl, name)

        def pallas_call(self, *args, **kw):
            return pl.pallas_call(*args, interpret=True, **kw)

    kb.pl = Interpret()
    cfg = GameConfig(wad_file=":test:", width=W, height=H, batch_size=2,
                     raster_backend="portal", player=PlayerConfig(clip_substeps=4))
    sim = DoomSim(cfg)
    scene, ps = sim.scene, sim._get_portal_scene()
    s = sim.reset(2)._replace(pos=jnp.asarray([GRATE[0]] * 2, jnp.float32),
                              yaw=jnp.asarray([GRATE[1]] * 2, jnp.float32))
    rec, words, aux = jax.jit(jax.vmap(
        lambda p, y, pi, o, t: _walk_env(ps, scene, cfg, W, H, int(cfg.portal_crossings),
                                         p, y, pi, o, t)
    ))(s.pos, s.yaw, s.pitch, s.object_offset, s.time)
    sky = jax.jit(jax.vmap(
        lambda sy, cy, sp, cp: _sky_image(ps, scene, cfg, W, H, sy, cy, sp, cp)
    ))(aux["sy"], aux["cy"], aux["sp"], aux["cp"])
    rec = np.array(rec)
    rec[1, 3::5, 13] = 0.0  # env 1: masked-family records lose their masked flag
    assert not np.asarray(aux["shear"]).any()
    p11 = 1.0 / math.tan(math.radians(cfg.fov) / 2.0)
    n_rows = scene.palette_lut.shape[0]
    jax_args = (rec, words, aux["cam"], ps["alpha_meta"][0], aux["d"].transpose(0, 2, 1),
                sky, ps["tex_i8"], ps["hole_bytes"], ps["cmap_i8"], H, p11, n_rows)
    # The port takes the sky as coordinates, whose gather is JAX's image.
    torch_args = (tuple(T(a) for a in jax_args[:3]) + (int(jax_args[3]), T(jax_args[4]))
                  + _port_sky(W, H, aux, sky) + tuple(T(a) for a in jax_args[6:9])
                  + (H, p11, n_rows))
    cache = {}

    def jax_out(variant):
        if variant not in cache:
            i, c = kb._ablated_call(*jax_args, tile_h=40, ablate=KB.ABLATIONS[variant])
            cache[variant] = np.asarray(i), np.asarray(c)
        return cache[variant]

    return torch_args, jax_out


@pytest.mark.parametrize("variant", list(KB.ABLATIONS))
def test_ablated_ref_matches_kernelbudget_interpret(budget_case, variant):
    """(b) Each variant's plain version vs the TPU tool's ablation copy
    (interpret mode): 0 px on idx and cov; the CPU wrapper is the plain
    version."""
    args, jax_out = budget_case
    want_i, want_c = jax_out(variant)
    got_i, got_c = KB.render_portal_ablated_ref(*args, ablate=KB.ABLATIONS[variant])
    # The port's u8 / bool frames are the JAX f32 outputs after its casts.
    np.testing.assert_array_equal(got_i.numpy(), want_i.astype(np.uint8))
    np.testing.assert_array_equal(got_c.numpy(), want_c > 0.5)
    wi, wc = KB.render_portal_ablated(*args, ablate=KB.ABLATIONS[variant])
    assert torch.equal(wi, got_i) and torch.equal(wc, got_c)
    if variant == "no_classify":
        assert not want_c.any()
    else:
        assert want_c.mean() > 0.5


def test_alpha_and_hole_switches_change_pixels(budget_case):
    """(b) The chosen views exercise the `alpha` and `hole` switches: in
    the TPU tool and the port alike, each changes pixels of `full` (idx or
    cov; the alpha test on env 0, the hole test on env 1)."""
    args, jax_out = budget_case
    fi, fc = jax_out("full")
    for variant, env in (("no_alpha", 0), ("no_hole", 1)):
        vi, vc = jax_out(variant)
        diff = ((vi != fi) | (vc != fc)).sum(axis=(1, 2))
        assert diff[env] > 0, (variant, diff)
        gi, gc = KB.render_portal_ablated_ref(*args, ablate=KB.ABLATIONS[variant])
        assert int(((gi.numpy() != fi.astype(np.uint8)) | (gc.numpy() != (fc > 0.5))).sum()
                   ) == int(diff.sum())


def test_ablated_ref_without_ablation_is_fused_ref():
    """(c) With nothing switched off the plain version is B2's, bitwise,
    on the port's own walk (one env pitched, so the shear is non-zero)."""
    from tpu_doom_torch.models import DoomSim
    from tpu_doom_torch.ops.raster import render_portal_fused_ref
    from tpu_doom_torch.render.portal import fused_inputs
    from tpu_doom_torch.utils.config import GameConfig

    sim = DoomSim(GameConfig(wad_file=":test:", width=W, height=H, batch_size=3,
                             raster_backend="portal"), "cpu")
    s = sim.reset()._replace(yaw=torch.tensor([0.0, 0.9, 2.5]),
                             pitch=torch.tensor([0.0, 0.3, 0.0]))
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, sim.config, W, H, s)
    assert bool(kw["shear"].any())
    gi, gc = KB.render_portal_ablated_ref(*args, **kw, ablate=())
    wi, wc = render_portal_fused_ref(*args, **kw)
    assert (gi.dtype, gc.dtype) == (wi.dtype, wc.dtype) == (torch.uint8, torch.bool)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)


def test_ablated_wrapper_refusals():
    """Only the instantiated masks, only the global-table mode, only CPU
    or CUDA tensors."""
    x = torch.zeros((1, 5, 16, 8))
    with pytest.raises(ValueError, match="no variant"):
        KB.render_portal_ablated(x, None, None, 0, None, None, None, None, None, None,
                                 None, 4, 1.0, 32, ablate=("flatten",))
    with pytest.raises(ValueError, match="no variant"):
        KB.render_portal_ablated_ref(x, None, None, 0, None, None, None, None, None, None,
                                     None, 4, 1.0, 32, ablate=("tex", "hole"))
    with pytest.raises(ValueError, match="global-table"):
        KB.render_portal_ablated_ref(x, None, None, 0, None, None, None, None,
                                     torch.zeros((1, 8, 128), dtype=torch.int16), None,
                                     None, 4, 1.0, 32)
    with pytest.raises(ValueError, match="device"):
        KB.render_portal_ablated(x.to("meta"), None, None, 0, None, None, None, None,
                                 None, None, None, 4, 1.0, 32)


# ---------------------------------------------------------------------------
# (d) the tools' command lines; the build's kernel names
# ---------------------------------------------------------------------------


def test_onehotbench_main_on_cpu(capsys):
    """(d) `python -m tpu_doom_torch.tools.onehotbench 16 256 1 --device
    cpu`: a device line, then one line per variant."""
    assert OH.main(["16", "256", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[onehotbench] cpu")
    assert [ln.split()[0] for ln in lines[1:]] == list(OH.VARIANTS)
    assert all("us/lookup" in ln and "on cpu" in ln for ln in lines[1:])


def test_kernelbudget_main_on_cpu(capsys, monkeypatch):
    """(d) The kernel budget at 2 envs x 64x40, 1 timed call, on the CPU:
    one line per variant, `no_flatten` not applicable, then the shares."""
    for k, v in dict(BENCH_BATCH="2", BENCH_W="64", BENCH_H="40", BENCH_REPS="1").items():
        monkeypatch.setenv(k, v)
    assert KB.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[kernelbudget] :test: 64x40 x 2 envs on cpu")
    timed = [ln.split(":")[0].strip() for ln in lines if "ms/batch (B=2)" in ln]
    assert timed == list(KB.VARIANTS)
    assert "no_flatten: not applicable on this card" in [ln.strip() for ln in lines]
    shares = [ln.split(":")[0].strip() for ln in lines if "share" in ln]
    assert shares == [v for v in KB.ABLATIONS if v != "full"]


def test_ptxas_names_keep_template_arguments(tmp_path):
    """Each instantiation of a kernel template gets its own line in the
    build's ptxas report."""
    from tpu_doom_torch import _build

    ns = "_ZN41_GLOBAL__N__5c1d2a3b_16_render_portal_cu_9f8e7d6c"
    assert _build.kernel_name(f"{ns}20render_portal_kernelILi0EEEvPKfPKiS3_") == (
        "render_portal_kernel<0>")
    assert _build.kernel_name(f"{ns}20render_portal_kernelILi28EEEvPKf") == (
        "render_portal_kernel<28>")
    assert _build.kernel_name(f"{ns}18select_rows_kernelEPKiPKfPfiiii") == (
        "select_rows_kernel")
    assert _build.kernel_name("_Z6helperv") is None
    lib = tmp_path / "lib.so"
    lib.with_suffix(".ptxas.txt").write_text("\n".join(
        f"ptxas info    : Compiling entry function '{ns}20render_portal_kernelILi{a}EEEvPKf'"
        f" for 'sm_90a'\nptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {r} registers, 464 bytes cmem[0]" for a, r in ((0, 39), (1, 30))))
    assert _build.ptxas_usage(lib) == [
        "render_portal_kernel<0>: Used 39 registers, 464 bytes cmem[0];"
        " 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "render_portal_kernel<1>: Used 30 registers, 464 bytes cmem[0];"
        " 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ]
