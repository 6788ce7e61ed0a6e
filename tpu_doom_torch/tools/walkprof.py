"""Where W1 (`walk_cross`, csrc/walk.cu) spends its time, on the card.

    python3 -m tpu_doom_torch.tools.walkprof [--other DIR]

Two readings, three with --other, each printed on `[walkprof]` lines:

* Phases. A copy of csrc/walk.cu, built on the fly with nvcc beside the
  package's library, stamps clock64() at W1's phase boundaries (thread 0
  of each block, into a device buffer read back after the launch); it is
  the production kernel otherwise, and its outputs are checked bitwise
  against the package's W1 on the same inputs. Run on the walk's own
  inputs at chip_smoke.py's W1 shapes: :test: and :texstress: at 256 x
  320x200 after 8 bench ticks, config 5's MAP01 (1,024 envs at 640x400
  after 8 bank ticks) and entry()'s 2 envs at 64x40 (from reset). Per
  shape: the mean SM cycles per block of each phase (staging the rows and
  the warps' cull; the scan of the rows kept; the ids of the K kept;
  writing the valid crossings' slots; the invalid ones'), the block's
  life, the rows warp 0 keeps of the last chunk, the valid crossings of
  thread 0.
* SASS. `cuobjdump -sass` of the package's library, walk_cross_kernel<24>:
  the instructions of the scan loop (static), and of the path one kept
  row takes when it is back-facing (the loop's head to the denominator's
  branch, then that branch's target to the loop's back edge; it includes
  the prefetch of the next row and the invalid row's id append).
* With --other DIR (another checkout, such as the parent's `git archive`
  under build/): DIR's csrc/walk.cu, built the same way, whose
  `tdt_walk_cross` takes the same arguments, beside this one's on the
  same inputs at each shape: first held bitwise to it, then each timed as
  the device ms per launch of 10 launches captured in a CUDA graph (no
  host time), median of 20 replays, in turns (other, this, this, other).

Card only: without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .fixtures import B_MAIN, H_MAIN, ROOT, W_MAIN, make_sim

SRC = os.path.join(ROOT, "tpu_doom_torch", "csrc", "walk.cu")
SLOTS = 10  # per block: 7 stamps, then rows kept (8) and valid crossings (9)
BID = "blockIdx.y * gridDim.x + blockIdx.x"
# (anchor in walk_cross_kernel, text put after it, or before it with a
# leading "^")
STAMPS = [
    ("  const bool cull = __all_sync(0xffffffffu, cone) && near_ >= 0.0f;\n", "  STAMP(0)\n"),
    ("  int nv = 0, ninv = 0, prev = -1;\n", "  STAMP(1)\n"),
    ("    __syncwarp();\n", f"    STAMP(2)\n    if (tid == 0) g_stamp[{BID}][8] = kept;\n"),
    ("  if (!act) return;\n  invalid_upto(SD);", "^  STAMP(3)\n"),
    ("  const int kv = min(nv, K);\n", "  STAMP(4)\n"),
    ("  const float top = tmax(ct, 0.0f), bot = tmin(cb, Hf);\n", "  STAMP(5)\n"),
    ("  bits = __reduce_or_sync(__activemask(), bits);",
     f"^  STAMP(6)\n  if (tid == 0) g_stamp[{BID}][9] = nv;\n"),
]
PHASES = ("stage + cull", "scan", "ids", "valid slots", "invalid slots")


def stamped_source() -> str:
    """csrc/walk.cu with the clock stamps and a copy-out entry point."""
    src = open(SRC).read()
    head = (f"namespace {{\n__device__ long long g_stamp[1 << 20][{SLOTS}];\n"
            f"#define STAMP(n) if (tid == 0 && {BID} < (1 << 20)) g_stamp[{BID}][n] = clock64();\n")
    src = src.replace("namespace {\n", head, 1)
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"walkprof: the anchor {anchor.strip()!r} is not in {SRC} once")
        src = src.replace(anchor, text[1:] + anchor if text[0] == "^" else anchor + text)
    return src + (f'\nextern "C" int tdt_walk_stamps(void* host, int n) {{\n'
                  f"  return (int)cudaMemcpyFromSymbol(host, g_stamp, (size_t)n * {SLOTS} *"
                  " sizeof(long long));\n}\n")


def build_walk(build_dir: str, name: str, source: str, include: str):
    """nvcc `source` (a walk.cu) into build_dir/<name>.so -> the loaded
    library, its tdt_walk_cross bound."""
    from .._build import NVCC_FLAGS, SIGNATURES

    os.makedirs(build_dir, exist_ok=True)
    cu, so = os.path.join(build_dir, name + ".cu"), os.path.join(build_dir, name + ".so")
    with open(cu, "w") as f:
        f.write(source)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-I", include, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"walkprof: nvcc failed on {name}:\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    lib.tdt_walk_cross.argtypes = SIGNATURES["tdt_walk_cross"]
    lib.tdt_walk_cross.restype = ctypes.c_int
    return lib


def build_stamped(build_dir: str):
    """The stamped copy of csrc/walk.cu, built -> the loaded library."""
    lib = build_walk(build_dir, "walk_stamped", stamped_source(), os.path.dirname(SRC))
    lib.tdt_walk_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tdt_walk_stamps.restype = ctypes.c_int
    return lib


def walk_cross_args(pscene, scene, cfg, width, height, state):
    """The arguments the walk of `state` gives W1."""
    from ..render import portal as P

    calls, orig = [], P.walk_cross

    def spy(*args):
        calls.append(args)
        return orig(*args)

    P.walk_cross = spy
    try:
        P.walk(pscene, scene, cfg, width, height, int(cfg.portal_crossings), state,
               active_segs=P.active_segs(pscene, cfg))
    finally:
        P.walk_cross = orig
    return calls[0]


def launcher(lib, args):
    """-> (run, outputs): run() launches lib's tdt_walk_cross on `args`
    (walk_cross's) into fresh output buffers, as the wrapper does."""
    from ..ops.walk import walk_cross

    p1, p2, o, d, table, cyw, shear, near, far, p11, H, K = args
    B, SD, W, C = p1.shape[0], p1.shape[1], d.shape[1], table.shape[2]
    ins = [x.contiguous() for x in (p1, p2, o, d, table, cyw, shear)]
    outs = [torch.empty_like(x) for x in walk_cross(*args)]

    def run():
        outs[-1].zero_()  # the mask is OR'd into
        rc = lib.tdt_walk_cross(*(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs),
                                B, SD, C, W, K, near, far, p11, float(H),
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"walkprof: tdt_walk_cross returned {rc}")

    return run, outs


def same_as_w1(outs, args) -> bool:
    """Whether `outs` are bitwise the package's W1 on `args`."""
    from ..ops.walk import walk_cross

    torch.cuda.synchronize()
    return all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
               for a, b in zip(outs, walk_cross(*args)))


def graph_ms(run, launches: int = 10, replays: int = 20) -> float:
    """Device ms per launch of `launches` runs captured in a CUDA graph,
    the median over `replays` replays."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            run()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def compare(this, other, label, args):
    """The other checkout's W1 beside this one's on `args`: bitwise, then
    timed in turns."""
    runs = {}
    for name, lib in (("other", other), ("this", this)):
        run, outs = launcher(lib, args)
        run()
        if not same_as_w1(outs, args):
            raise SystemExit(f"walkprof: {name}'s W1 differs from W1 on {label}")
        runs[name] = run
    ms = {n: [graph_ms(runs[n]) for _ in range(2)] for n in ("other", "this")}
    print(f"[walkprof] {label}: W1 device ms per launch in a CUDA graph: this"
          f" {ms['this'][0]:.4f} / {ms['this'][1]:.4f}, other {ms['other'][0]:.4f} /"
          f" {ms['other'][1]:.4f}", flush=True)


def stamped_run(lib, label, args):
    """W1's stamped copy on `args`: checked bitwise against the package's
    W1, then its stamps printed."""
    run, outs = launcher(lib, args)
    run()
    if not same_as_w1(outs, args):
        raise SystemExit(f"walkprof: the stamped W1 differs from W1 on {label}")
    p1, d, K = args[0], args[3], args[11]
    B, SD, W = p1.shape[0], p1.shape[1], d.shape[1]
    warps = (W + 31) // 32
    per = next((q for q in range(5, 1, -1) if warps % q == 0), 1)  # csrc/walk.cu's block shape
    nb = B * ((W + 32 * per - 1) // (32 * per))
    stamps = np.zeros((nb, SLOTS), dtype=np.int64)
    if lib.tdt_walk_stamps(stamps.ctypes.data, nb):
        raise SystemExit("walkprof: reading the stamps failed")
    phase = np.diff(stamps[:, :7], axis=1)[:, 1:].mean(axis=0)
    life = stamps[:, 6] - stamps[:, 0]
    print(f"[walkprof] {label}: B {B}, rows {SD}, W {W}, K {K}, {nb} blocks of {32 * per}; mean"
          " cycles per block: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, phase))
          + f"; life {life.mean():.0f} (p90 {np.percentile(life, 90):.0f}); rows warp 0 keeps"
          f" {stamps[:, 8].mean():.2f}, valid crossings of thread 0 {stamps[:, 9].mean():.2f}",
          flush=True)


INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);")


def sass_counts(lib_path: str, kmax: int = 24):
    """W1<kmax>'s scan loop in the library's SASS -> (its instructions,
    those of a back-facing kept row's path)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True).stdout
    name = f"walk_cross_kernelILi{kmax}E"
    body = out[out.index(name):]
    body = body[:body.index("Function :")] if "Function :" in body else body
    ins = [(int(a, 16), op, rest) for a, _, op, rest in INSTR.findall(body)]
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    # The denominator's test compares with 1e-12 (printed 9.99...e-13).
    test = next(i for i, (_, op, rest) in enumerate(ins)
                if op.startswith("FSETP.GE") and "9.9999999600419720025e-13" in rest)
    loops = [(at[int(r.split()[-1], 16)], i) for i, (a, op, r) in enumerate(ins)
             if op == "BRA" and r.split() and int(r.split()[-1], 16) < a
             and at.get(int(r.split()[-1], 16), i) <= test < i]
    head, back = min(loops, key=lambda x: x[1] - x[0])
    reject = next(i for i in range(test, back) if ins[i][1] == "BRA")
    target = at[int(ins[reject][2].split()[-1], 16)]
    return back - head + 1, (reject - head + 1) + (back - target + 1)


def shapes():
    """(label, W1's arguments) at chip_smoke.py's W1 shapes, one at a time."""
    from ..bench import bank_actions, bank_tick, bench_actions
    from ..entry import entry_sim
    from .banks import BANK5, BANK_H, BANK_W, make_bank

    for wad in (":test:", ":texstress:"):
        sim = make_sim(wad_file=wad)
        state = sim.reset()
        acts = bench_actions(sim, B_MAIN)
        for _ in range(8):
            state = sim.step(state, acts)
        yield f"{wad} {B_MAIN} x {W_MAIN}x{H_MAIN}", walk_cross_args(
            sim.portal_scene(), sim.scene, sim.config, W_MAIN, H_MAIN, state)
        del sim, state
    bank = make_bank(BANK5)
    E = 1024
    state = bank.reset(E)
    active = torch.ones((bank.num_levels, E), dtype=torch.bool, device="cuda")
    acts = bank_actions(bank.num_levels, E)
    tick = bank_tick(bank, BANK_W, BANK_H)
    for _ in range(8):
        (state, active), _ = tick((state, active), acts)
    lv = 2  # MAP01
    yield f"config 5's MAP01 {E} x {BANK_W}x{BANK_H}", walk_cross_args(
        bank._at(bank.pscenes, lv), bank._at(bank.scenes, lv), bank.cfg, BANK_W, BANK_H,
        bank._at(state, lv))
    del bank, state
    sim = entry_sim()  # entry()'s 2 envs at 64x40, K 12
    yield f"entry()'s 2 envs at {sim.config.width}x{sim.config.height}", walk_cross_args(
        sim.portal_scene(), sim.scene, sim.config, sim.config.width, sim.config.height,
        sim.reset(2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout whose W1 to time beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walkprof: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import _build

    path, _ = _build.build()
    this = _build.load()
    print(f"[walkprof] {torch.cuda.get_device_name(0)}", flush=True)
    out = os.path.join(ROOT, "build", "walkprof")
    lib = build_stamped(out)
    other = None
    if args.other:
        csrc = os.path.join(os.path.abspath(args.other), "tpu_doom_torch", "csrc")
        with open(os.path.join(csrc, "walk.cu")) as f:
            other = build_walk(out, "walk_other", f.read(), csrc)
    with torch.no_grad():
        for label, cross in shapes():
            stamped_run(lib, label, cross)
            if other is not None:
                compare(this, other, label, cross)
    loop, reject = sass_counts(str(path))
    print(f"[walkprof] SASS walk_cross_kernel<24>: scan loop {loop} instructions; a back-facing"
          f" kept row's path {reject}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
