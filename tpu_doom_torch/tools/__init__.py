"""The port's measuring instruments, each with its own hand-written kernel:

* `onehotbench` (B10, csrc/onehot_lookup.cu): one texel-table lookup at
  the compact table's size, three ways of reading the table;
* `kernelbudget` (B11, csrc/render_portal.cu's ablation instantiations):
  B2's time split by stage, each switched off in turn.

Both run on the card unless `--device cpu` is given (their kernels' plain
versions, for checking the tools themselves). Neither runs on the main
path: their launch counts stay 0 there. `banks` builds the level banks
the card is measured on (chip_smoke.py, tools/profile_tick.py).

The twins of the root tools that time the JAX package, on the card
unless BENCH_DEVICE=cpu, each timing the bench's tick captured as a CUDA
graph: `perfcmp` (an A/B of the tick under GameConfig overrides),
`stagebudget` (full / step / render / walk, each its own captured tick)
and `measure_all` (every bench row, one process at a time).
"""

from __future__ import annotations

import subprocess

import torch


def device_label(device: torch.device) -> str:
    """The device a tool's numbers come from: the card's name and power
    limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu (the kernels' plain versions; no device time)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip() if smi.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        card = ""
    return card or torch.cuda.get_device_name(device)
