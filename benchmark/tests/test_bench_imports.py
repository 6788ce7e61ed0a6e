"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and nothing of the port in the reference."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from harness.cell import FORBIDDEN, forbidden_modules


def _imports(directory):
    """(file, top-level module name) of every import under `directory`;
    relative imports as '.'."""
    for base, _, files in os.walk(directory):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        yield path, a.name.split(".")[0]
                elif isinstance(node, ast.ImportFrom):
                    yield path, "." if node.level else node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    bad = [(p, m) for p, m in _imports(BENCH) if m in FORBIDDEN]
    assert not bad
    # The port's name begins with the JAX package's: compared whole, it passes.
    assert "tpu_doom_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    bad = [(p, m) for p, m in _imports(ref) if m.startswith("tpu_doom") or m in
           ("harness", "drivers")]
    assert not bad


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.cell, harness.check, harness.trace, harness.traffic\n"
            "from harness.cell import load_module, forbidden_modules\n"
            "for k in ('doom_sim', 'level_bank'): load_module('drivers', k)\n"
            "import tpu_doom_torch.models, tpu_doom_torch.graphs, reference.models\n"
            "import reference.render.portal, reference.levels\n"
            "print(forbidden_modules())\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_doom_torch_like", object())
    assert "tpu_doom_torch_like" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in forbidden_modules()
