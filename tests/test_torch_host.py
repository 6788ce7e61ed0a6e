"""The port's own host layers (`tpu_doom_torch.wad`, `.geom`,
`.utils.config`) against the JAX package's, and the port's independence
of JAX:

(a) both packages compile the four fixtures to bitwise-equal
    `LevelArrays`, portal tables included;
(b) both packages' default configs are equal field by field;
(c) importing every module of the port, and chip_smoke.py, loads neither
    `jax` nor any module of `tpu_doom`;
(d) no import statement of the port's files names `jax` or `tpu_doom`;
(f) no module of the port imports a root script (chip_smoke.py), and
    `tpu_doom_torch.tools.fixtures` finds its checkout from another
    directory.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The fixtures as the JAX package's DoomSim builds them
# (tpu_doom/models/doom_sim.py:43-75).
JAX_FIXTURES = {
    ":test:": ("build_test_wad", (), {}),
    ":doom2:": ("build_doom2_wad", (), {}),
    ":stress:": ("build_stress_wad", (0, 20), {}),
    ":texstress:": ("build_stress_wad", (0, 16), {"n_textures": 128}),
}


def _compile_jax(wad_file):
    from tpu_doom.geom.builder import compile_level
    from tpu_doom.wad import wadgen
    from tpu_doom.wad.archive import Archive
    from tpu_doom.wad.meta import WadMetadata
    from tpu_doom.wad.tex import TextureDirectory

    fn, args, kw = JAX_FIXTURES[wad_file]
    wad = Archive(getattr(wadgen, fn)(*args, **kw), source=wad_file)
    meta = WadMetadata.from_file(os.path.join(ROOT, "assets/meta/doom.toml"))
    return compile_level(wad, TextureDirectory(wad, meta), meta, 0)


def _compile_port(wad_file):
    from tpu_doom_torch.geom.builder import compile_level
    from tpu_doom_torch.models.doom_sim import open_wad
    from tpu_doom_torch.wad.meta import WadMetadata
    from tpu_doom_torch.wad.tex import TextureDirectory

    wad = open_wad(wad_file)
    meta = WadMetadata.from_file(os.path.join(ROOT, "assets/meta/doom.toml"))
    return compile_level(wad, TextureDirectory(wad, meta), meta, 0)


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


@pytest.mark.parametrize("wad_file", sorted(JAX_FIXTURES))
def test_compile_level_matches_jax_package(wad_file):
    """(a) Every LevelArrays field, and every array of its PortalTable,
    bitwise equal."""
    ja, pa = _compile_jax(wad_file), _compile_port(wad_file)
    names = [f.name for f in dataclasses.fields(ja)]
    assert names == [f.name for f in dataclasses.fields(pa)]
    for name in names:
        if name == "portal":
            jt, pt = ja.portal, pa.portal
            fields = [f.name for f in dataclasses.fields(jt)]
            assert fields == [f.name for f in dataclasses.fields(pt)]
            for f in fields:
                _assert_same(getattr(jt, f), getattr(pt, f), f"portal.{f}")
        else:
            _assert_same(getattr(ja, name), getattr(pa, name), name)


def test_default_configs_match_jax_package():
    """(b) GameConfig() and PlayerConfig() equal field by field."""
    from tpu_doom.utils import config as jc
    from tpu_doom_torch.utils import config as pc

    for cls in ("GameConfig", "PlayerConfig"):
        j, p = getattr(jc, cls)(), getattr(pc, cls)()
        jf = [f.name for f in dataclasses.fields(j)]
        assert jf == [f.name for f in dataclasses.fields(p)], cls
        for name in jf:
            jv, pv = getattr(j, name), getattr(p, name)
            if dataclasses.is_dataclass(jv):
                jv, pv = dataclasses.asdict(jv), dataclasses.asdict(pv)
            assert jv == pv, (cls, name)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import tpu_doom_torch
for m in pkgutil.walk_packages(tpu_doom_torch.__path__, "tpu_doom_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "tpu_doom"
             or n.startswith("tpu_doom."))
print(len([n for n in sys.modules if n.startswith("tpu_doom_torch")]))
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    """(c) A fresh interpreter imports every module of the port and
    chip_smoke.py; sys.modules then holds no jax and no tpu_doom.*."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 30  # the walk found the modules


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_tick.py"),
             os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tpu_doom_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_sources_import_no_jax():
    """(d) No import in the port's package, chip_smoke.py,
    tools/profile_tick.py or tests/test_torch_cuda.py names jax or
    tpu_doom."""
    files = _port_files()
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "tpu_doom"), (path, node.lineno, m)


def _package_imports():
    """(path, line, top-level module) of every absolute import in the
    port's package."""
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tpu_doom_torch")):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    yield path, node.lineno, m.split(".")[0]


def test_package_imports_no_root_script():
    """(f) No module of the port imports chip_smoke.py (or any root
    script): the fixtures it shares live in tpu_doom_torch.tools.fixtures."""
    bad = [x for x in _package_imports() if x[2] in ("chip_smoke", "bench", "tools")]
    assert not bad, bad


def test_fixtures_load_outside_the_checkout(tmp_path):
    """(f) `tpu_doom_torch.tools.fixtures`, imported in an interpreter
    whose working directory is elsewhere, finds its checkout and builds
    the verify poses' state and the maze's pitched envs (on the CPU here):
    chip_smoke.py and tools/profile_tick.py rely on it."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from tpu_doom_torch.tools.fixtures import (fallback_sim, make_sim,\n"
            "                                           verify_ref, verify_state)\n"
            "vsim = make_sim('cpu', batch_size=8, portal_crossings=12,\n"
            "                raster_backend='auto')\n"
            "sim, state, _ = fallback_sim(device='cpu', wad_file=':texstress:')\n"
            "n = state.pos.shape[0] // 2  # fallback_sim pitches the first half\n"
            "for name, m, s in (('verify', vsim, verify_state(vsim, verify_ref())),\n"
            "                   ('maze', sim, type(state)(*(x[:n] for x in state)))):\n"
            "    print(name, tuple(s.pos.shape), m.config.width, m.config.height)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["verify (8, 3) 320 200", "maze (128, 3) 320 200"]
