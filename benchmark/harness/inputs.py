"""The WAD files a cell loads, the metadata file beside them, and the
GameConfig fields a configuration sets.

A configuration names each level's WAD either as a fixture of the
benchmark's frozen generator (`reference/wad/wadgen.py`: ':test:',
':doom2:', ...), written to a directory under TMPDIR, or as a file of the
checkout, by its path from the checkout's root (a real IWAD added as data
needs no change here). Both sides get the same files: the port opens them
by path (`open_wad` accepts a path), the reference with its own loader. A
later change to the port's fixtures therefore cannot change what is
measured.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
METADATA = os.path.join(HERE, "inputs", "doom.toml")


# GameConfig fields the harness sets itself, from the configuration's own
# keys (`levels`, `envs_per_level`, `width`, `height`, `game.clip_substeps`)
# and the metadata beside the WADs; a configuration's `game` may not set them.
HARNESS_FIELDS = ("wad_file", "initial_level_index", "batch_size", "player", "width",
                  "height", "metadata_file")


def game_fields(config: dict) -> dict:
    """The GameConfig fields a configuration file sets, besides the WAD,
    the batch and the player, for either side's GameConfig: every key of
    its `game` under its own name, but `clip_substeps` (the PlayerConfig
    field the drivers read). A key that is not a field of both the port's
    and the reference's GameConfig, or that the harness sets itself,
    raises."""
    from reference.utils.config import GameConfig as ReferenceConfig
    from tpu_doom_torch.utils.config import GameConfig as PortConfig

    both = ({f.name for f in dataclasses.fields(PortConfig)}
            & {f.name for f in dataclasses.fields(ReferenceConfig)})
    game = {k: v for k, v in config["game"].items() if k != "clip_substeps"}
    for key in game:
        if key not in both or key in HARNESS_FIELDS:
            raise ValueError(f"configuration {config.get('name')!r}: game key {key!r} is not"
                             " a GameConfig field of both the port and the reference that"
                             " a configuration may set")
    return dict(game, width=int(config["width"]), height=int(config["height"]),
                metadata_file=METADATA)


def wad_bytes(spec: str) -> bytes:
    """The fixture named by `spec`, as the port's `open_wad` names them:
    ':test:', ':doom2:', ':stress:[cells]', ':texstress:[cells]x[textures]'."""
    from reference.wad import wadgen

    if spec == ":test:":
        return wadgen.build_test_wad()
    if spec == ":doom2:":
        return wadgen.build_doom2_wad()
    if spec.startswith(":stress:"):
        cells = spec[len(":stress:"):]
        return wadgen.build_stress_wad(0, int(cells) if cells else 20)
    if spec.startswith(":texstress:"):
        c, _, t = spec[len(":texstress:"):].partition("x")
        return wadgen.build_stress_wad(0, int(c or 16), n_textures=int(t or 128))
    raise ValueError(f"unknown fixture {spec!r}")


def checkout_file(spec: str) -> str:
    """The absolute path of a WAD named by its path from the checkout's
    root; it has to lie inside the checkout."""
    root = os.path.realpath(ROOT)
    path = os.path.realpath(os.path.join(root, spec))
    if os.path.isabs(spec) or os.path.commonpath([path, root]) != root:
        raise ValueError(f"WAD {spec!r} is not a path inside the checkout")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"WAD {spec!r} not found in the checkout")
    return path


class WadFiles:
    """{spec: path} of a configuration's WADs: files of the checkout where
    they are named so, the fixtures written to a directory under TMPDIR,
    removed by `close`."""

    def __init__(self, specs):
        self.dir = tempfile.mkdtemp(prefix="bench_wads_")
        self.paths = {}
        for spec in dict.fromkeys(s for s, _ in specs):
            if not spec.startswith(":"):
                self.paths[spec] = checkout_file(spec)
                continue
            path = os.path.join(self.dir, f"wad{len(self.paths)}.wad")
            with open(path, "wb") as f:
                f.write(wad_bytes(spec))
            self.paths[spec] = path

    def levels(self, specs) -> list:
        """(path, level index) of each (spec, level index)."""
        return [(self.paths[s], int(i)) for s, i in specs]

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
