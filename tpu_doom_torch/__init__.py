"""tpu-doom on PyTorch + CUDA: the batch-first Doom simulator ported from
the JAX package `tpu_doom` to one NVIDIA H100 (Hopper, sm_90a).

Layering mirrors `tpu_doom`:
  sim/      per-tick game step over a written-out env batch dimension
  render/   portal (column) renderer + triangle rasterizer fallback
  ops/      the hand-written Hopper kernels (csrc/*.cu) and their plain
            PyTorch versions, chosen by the device of the tensors given
  models/   the DoomSim API
  csrc/     CUDA C++ sources, built with nvcc by `_build.load()`
  bench.py  the benchmark and verify leg (`python3 -m tpu_doom_torch.bench`)
  cli.py    the command line (`python -m tpu_doom_torch.cli`)
  entry.py  `entry()`: a step + render tick and its example arguments

  wad/      WAD loading and the synthetic fixtures (host, numpy)
  geom/     the level compiler and portal tables (host, numpy)
  utils/    GameConfig / PlayerConfig, checkpoints, the terminal viewer
            and its helpers (timers, ttf, text, input)

`wad/`, `geom/` and `utils/` (all but `checkpoint.py`) are this
package's own copies of the JAX package's host layers: no module here
imports `jax` or anything of `tpu_doom`. Only `native/` (the C asset loaders) is shared.
"""

__version__ = "0.1.0"
