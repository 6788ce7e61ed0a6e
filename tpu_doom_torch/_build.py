"""Build and load the CUDA kernels of `csrc/`.

`load()` compiles every `csrc/*.cu` with nvcc (one process per source,
in parallel) and links them into one shared library
with a plain C interface under `build/tpu_doom_torch/` (beside the
package, listed in .gitignore) on first use, and again only when a
source or the flags change: the library's file name carries a hash of
both. The library is bound with ctypes; every entry point takes device
pointers, sizes and the stream, and returns `cudaGetLastError()` after
its launch (`tdt_smem_optin` launches nothing: it writes a device
attribute to a host int and returns the CUDA error code).

Flags: `--fmad=false` keeps nvcc from contracting a*b+c into one fused
multiply-add, so each kernel rounds exactly where its plain PyTorch
version does and the two agree bit for bit. No `--use_fast_math`.
`-Xptxas -v` makes ptxas report each kernel's registers, shared memory
and spills; the report is kept beside the library (`ptxas_usage`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_doom_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Entry point -> argument types (every function returns a cudaError_t).
SIGNATURES = {
    # rows, state8, out, B, M, radius, height, dt, substeps, noclip, stream
    "tdt_player_move": [_P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P],
    # records, words, cam, shear, dxz, sky_x, sky_y, sky_tex, tex, hole,
    # cmap, idx, cov, B, R, W, H, n_words, hc, hs, ws, S1, holeless,
    # per_env, tex_stride, p11, n_rows, stream
    "tdt_render_portal": [_P] * 13 + [_I] * 12 + [_F, _I, _P],
    # rows, attrs, grid, ybounds, bounds, bins (scratch), out, B, T, P,
    # width, n_layers, tile_p, chunk_t, stream
    "tdt_peel_resolve": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _P],
    # idx, tab, out, B, N, S, C, stream
    "tdt_select_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # idx, live, out, B, N, S, stream
    "tdt_scatter_live": [_P, _P, _P, _I, _I, _I, _P],
    # meta, tex, out, B, C, tex_rows, out_rows, stream
    "tdt_gather_cells": [_P, _P, _P, _I, _I, _I, _I, _P],
    # records, words, cam_y, shear, out, B, R, W, H, n_words, hc, p11,
    # stream
    "tdt_classify_alpha": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _P],
    # ch, dxz, ndc_y, sky, cam, shear, tex, hole, cmap, idx, cov, B, P, S1,
    # p11, n_rows, stream
    "tdt_shade_portal": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _F, _I, _P],
    # rows, grid, bins (scratch), out_z, out_id, B, T, P, width, n_layers,
    # stream
    "tdt_depth_peel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # records, words, cam, shear, dxz, sky_x, sky_y, sky_tex, tex, hole,
    # cmap, idx, cov, B, R, W, H, n_words, hc, hs, ws, S1, holeless, p11,
    # n_rows, ablate, zero, stream
    "tdt_render_portal_ablated": [_P] * 13 + [_I] * 10 + [_F] + [_I] * 3 + [_P],
    # x, y, fast, ref, n, stream (B2's remainder against fmodf; tests only)
    "tdt_fmod_check": [_P, _P, _P, _P, _I, _P],
    # idx, tab, out, n, S, iters, grid, variant, stream
    "tdt_onehot_lookup": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # level (a host array of device pointers), its length, objoff, time,
    # lights, right, fwd, o, table, p1, p2, ordv and n_visible (or null),
    # overflow, B, S, D, O, L, SV, xvmax, near, far, flats_w, walls_w,
    # stream (W0)
    "tdt_walk_table": [_P, _I] + [_P] * 12 + [_I] * 6 + [_F] * 5 + [_P],
    # p1, p2, o, d, table, cyw, shear, t, u, idx, live, top, bot, mask,
    # B, SD, C, W, K, near, far, p11, H, stream (W1)
    "tdt_walk_cross": [_P] * 14 + [_I] * 5 + [_F] * 4 + [_P],
    # t, u, idx, live, top, bot, mask, ovf_in, table (or null), sel (or
    # null), aw, cyw, shear, shift, records, words, ovf_out, B, SD, C, W,
    # K, kc, n_words, wc, n_cells,
    # p11, H, stream (W2)
    "tdt_walk_records": [_P] * 17 + [_I] * 9 + [_F] * 2 + [_P],
    # in (a host array of device pointers), its length, out (the same), its
    # length, B, O, M, dt, stream (S1)
    "tdt_effects_rows": [_P, _I, _P, _I, _I, _I, _I, _F, _P],
    # in, its length, out, its length, B, K, D, O, dt, height, move_force,
    # friction, ground_drag, air_drag, spring_p, spring_d, pitch_lo,
    # pitch_hi, jump_vy, enable_noclip, stream (S2)
    "tdt_player_triggers": [_P, _I, _P, _I] + [_I] * 4 + [_F] * 11 + [_I, _P],
    # out (int*): the device's opt-in shared memory per block, bytes
    "tdt_smem_optin": [_P],
    # stream (capturing), body stream, pred (bool*), handle out (u64*):
    # a WHILE node's start
    "tdt_while_begin": [_P, _P, _P, _P],
    # body stream, handle (u64*), pred (bool*, or null): the WHILE node's end
    "tdt_while_end": [_P, _P, _P],
    # ring, tick counter, slot, n_slots, n_ticks, ahead, opens, stream:
    # one %globaltimer stamp (trace.py)
    "tdt_trace_stamp": [_P, _P, _I, _I, _I, _I, _I, _P],
    # out (i64*), steps, stream: %globaltimer's smallest step
    "tdt_trace_resolution": [_P, _I, _P],
}


def find_nvcc() -> str:
    """Path of nvcc, or RuntimeError naming where it was looked for."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "tpu_doom_torch: nvcc not found on PATH or under "
        f"{home}/bin; the CUDA kernels need the CUDA toolkit to build"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_doom_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; returns their joined stdout + stderr,
    or raises RuntimeError naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"tpu_doom_torch: nvcc failed ({p.returncode}):\n"
                f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> tuple[Path, float]:
    """Compile the kernels if the library is missing; returns (path,
    seconds spent compiling; 0.0 when it was already built). Each source
    compiles to an object in its own nvcc process, all at once, and one
    more nvcc links them."""
    nvcc = find_nvcc()
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *compile_flags, "-c", str(s), "-o", str(o)]
                    for s, o in zip(srcs, objs)])
    _run_all([[nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    _ptxas_log(lib).write_text(log)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def _ptxas_log(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def kernel_name(mangled: str) -> str | None:
    """'<name>_kernel', or '<name>_kernel<a,b>' for an instantiation of a
    kernel template over non-negative ints (Itanium mangling 'ILi0EE'),
    from a mangled entry name; None if it names no kernel of csrc/."""
    m = re.search(r"([a-z_]+_kernel)(?:I((?:Li\d+E)+)E)?", mangled)
    if not m:
        return None
    if m.group(2):
        return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
    return m.group(1)


def ptxas_usage(lib: Path) -> list[str]:
    """One line per kernel, '<kernel>: <registers/smem>; <spills>', from
    the ptxas report that `build` kept beside the library; each
    instantiation of a kernel template is reported under its own name."""
    out, name, spill = [], None, ""
    for line in _ptxas_log(lib).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m and kernel_name(m.group(1)):
            name, spill = kernel_name(m.group(1)), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, then load and bind the kernel library. Raises
    RuntimeError when nvcc is missing or the build fails."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"tpu_doom_torch: {name} launch failed: cudaError {err}")
