"""B10: one texel-table lookup at the compact table's size, timed on the card.

    python -m tpu_doom_torch.tools.onehotbench [S n reps] [--device cpu]

(defaults 534 3072 50: the `:test:` compact texel table, as the TPU tool.)
Replaces tools/onehotbench.py (`run`, :82, kernel `_kernel`), which timed
the TPU's one-hot MXU lookup. The function is the same: idx (1, n) int32
in [0, S * 128), tab (S, 128) int8 ->
    out[g, j] = sum over it < iters of tab[(idx[j] >> 7) + it, idx[j] & 127]
for every grid step g < grid, a row at or past S adding 0 (int32). The
TPU kernel wrote that into row 0 of a (grid, 8, n) block; here it is
(grid, n).

The TPU tool's variants are three ways to build the one-hot for the MXU
(`i32`, `i16`, `i8x2`: int32, int16 or two int8 compares per element)
plus the contraction's floor with a constant one-hot (`matonly`). Hopper
reads a table with an indexed load, so no one-hot and no contraction
exists here and those four have no counterpart. The variants are the
ways to read the table (csrc/onehot_lookup.cu):
  ldg   each thread reads its texel through the read-only path, as B2, B7
        and B8 do;
  smem  each block stages the whole table in dynamic shared memory first
        (above 48 KB with the opt-in attribute; a table over the card's
        opt-in maximum raises, it never falls back to ldg);
  copy  the floor: the same launch reads idx and writes iters * (idx & 127)
        with no table read.
`ldg` and `smem` compute exactly the TPU tool's `i32`/`i16`/`i8x2`.

Prints one line per variant, kernel time over reps x iters x grid in
microseconds, as the TPU tool ("us/lookup"), from CUDA events around reps
back-to-back launches.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from .._build import check, load
from . import device_label

VARIANTS = ("ldg", "smem", "copy")


def make_inputs(S: int, n: int, device):
    """The TPU tool's inputs: idx from default_rng(0), tab from
    default_rng(1)."""
    idx = np.random.default_rng(0).integers(0, S * 128, (1, n)).astype(np.int32)
    tab = np.random.default_rng(1).integers(-128, 128, (S, 128)).astype(np.int8)
    return torch.as_tensor(idx, device=device), torch.as_tensor(tab, device=device)


def lookup_ref(idx, tab, iters: int = 16, grid: int = 64, variant: str = "ldg"):
    """Plain version of B10: idx (1, n) int32, tab (S, 128) int8 -> (grid,
    n) int32; `copy` gives iters * (idx & 127). Every grid step computes
    the same row, so it is computed once and repeated."""
    if variant not in VARIANTS:
        raise ValueError(f"onehot_lookup: unknown variant {variant!r}")
    i = idx.reshape(-1).to(torch.int32)
    lo = i & 127
    if variant == "copy":
        row = lo * iters
    else:
        S = tab.shape[0]
        r = (i >> 7)[None, :] + torch.arange(iters, dtype=torch.int32, device=i.device)[:, None]
        ok = (r >= 0) & (r < S)
        vals = tab.reshape(-1).to(torch.int32)[(torch.where(ok, r, 0) * 128 + lo).long()]
        row = torch.where(ok, vals, 0).sum(0, dtype=torch.int32)
    return row[None, :].repeat(grid, 1)


def smem_optin() -> int:
    """The card's largest dynamic shared memory per block, opt-in, bytes."""
    out = ctypes.c_int(0)
    check(load().tdt_smem_optin(ctypes.addressof(out)), "smem_optin")
    return out.value


def lookup(idx, tab, iters: int = 16, grid: int = 64, variant: str = "ldg"):
    """Kernel B10 for CUDA tensors, its plain version for CPU tensors
    (arguments as `lookup_ref`)."""
    if idx.device.type == "cpu":
        return lookup_ref(idx, tab, iters, grid, variant)
    if idx.device.type != "cuda":
        raise ValueError(f"onehot_lookup: unsupported device {idx.device}")
    if variant not in VARIANTS:
        raise ValueError(f"onehot_lookup: unknown variant {variant!r}")
    if (idx.dim() != 2 or idx.shape[0] != 1 or tab.dim() != 2 or tab.shape[1] != 128
            or tab.shape[0] < 1):
        raise ValueError("onehot_lookup: bad shapes")
    if (idx.dtype, tab.dtype) != (torch.int32, torch.int8):
        raise ValueError("onehot_lookup: bad dtypes")
    n, S = idx.shape[1], tab.shape[0]
    if grid < 1 or iters < 0 or n * grid > 2**30:
        raise ValueError("onehot_lookup: grid, iters or grid * n out of range")
    if variant == "smem" and tab.numel() > (limit := smem_optin()):
        raise ValueError(
            f"onehot_lookup: smem: a table of {tab.numel()} B exceeds this card's "
            f"opt-in shared memory of {limit} B per block")
    idx, tab = idx.contiguous(), tab.contiguous()
    if tab.data_ptr() % 16:  # the smem variant stages it in 16-byte copies
        tab = tab.clone()
    out = torch.empty((grid, n), dtype=torch.int32, device=idx.device)
    if n == 0:
        return out
    check(load().tdt_onehot_lookup(
        idx.data_ptr(), tab.data_ptr(), out.data_ptr(), n, S, int(iters), int(grid),
        VARIANTS.index(variant), torch.cuda.current_stream(idx.device).cuda_stream,
    ), "onehot_lookup")
    lookup.launches += 1
    return out


lookup.launches = 0


def run(variant: str, S: int, n: int, reps: int, iters: int = 16, grid: int = 64,
        device="cuda") -> float:
    """Microseconds per (grid step x iteration) of `variant` on the TPU
    tool's inputs: on the card, CUDA events around `reps` back-to-back
    launches after one warm-up; on the CPU the plain version's host
    time."""
    dev = torch.device(device)
    idx, tab = make_inputs(S, n, dev)
    lookup(idx, tab, iters, grid, variant)  # warm-up (and, once, the build)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            lookup(idx, tab, iters, grid, variant)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            lookup(idx, tab, iters, grid, variant)
        ms = (time.perf_counter() - t0) * 1e3
    us = ms * 1e3 / reps / iters / grid
    print(f"{variant:8s} S={S} n={n} iters={iters} grid={grid} on {dev.type}:"
          f" {us:8.5f} us/lookup", flush=True)
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("S", nargs="?", type=int, default=534)
    ap.add_argument("n", nargs="?", type=int, default=3072)
    ap.add_argument("reps", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"[onehotbench] {device_label(dev)}", flush=True)
    for v in VARIANTS:
        try:
            run(v, args.S, args.n, args.reps, device=dev)
        except ValueError as e:  # smem's refusal of an oversized table
            print(f"{v:8s} REFUSED: {e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
