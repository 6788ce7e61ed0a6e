"""tpu-doom on PyTorch + CUDA: the batch-first Doom simulator ported from
the JAX package `tpu_doom` to one NVIDIA H100 (Hopper, sm_90a).

Layering mirrors `tpu_doom`:
  sim/      per-tick game step over a written-out env batch dimension
  render/   portal (column) renderer + triangle rasterizer fallback
  ops/      the hand-written Hopper kernels (csrc/*.cu) and their plain
            PyTorch versions, chosen by the device of the tensors given
  models/   the DoomSim API
  csrc/     CUDA C++ sources, built with nvcc by `_build.load()`

  wad/      WAD loading and the synthetic fixtures (host, numpy)
  geom/     the level compiler and portal tables (host, numpy)
  utils/    GameConfig / PlayerConfig

`wad/`, `geom/` and `utils/config.py` are this package's own copies of
the JAX package's host layers: no module here imports `jax` or anything
of `tpu_doom`. Only `native/` (the C asset loaders) is shared.
"""

__version__ = "0.1.0"
