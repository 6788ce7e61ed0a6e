"""The frozen fixture generator and metadata make today the bytes the
port's make, for every fixture the cells load."""

import filecmp
import json
import os

import pytest

from conftest import BENCH, ROOT


def _specs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    specs = set()
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            specs |= {s for s, _ in json.load(f)["levels"]}
    return sorted(specs)


@pytest.mark.parametrize("spec", _specs())
def test_frozen_wadgen_bytes_equal_the_ports(spec):
    from harness.inputs import wad_bytes
    from tpu_doom_torch.models.doom_sim import open_wad
    from tpu_doom_torch.wad import wadgen

    frozen = wad_bytes(spec)
    port = {":test:": wadgen.build_test_wad, ":doom2:": wadgen.build_doom2_wad}[spec]()
    assert frozen == port
    assert open_wad(spec).num_levels >= 1


def test_frozen_metadata_equals_the_ports():
    assert filecmp.cmp(os.path.join(BENCH, "inputs", "doom.toml"),
                       os.path.join(ROOT, "assets", "meta", "doom.toml"), shallow=False)
