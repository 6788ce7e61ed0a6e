"""Multi-process initialization: the port's twin of
`tpu_doom/parallel/distributed.py`.

Each process owns one device. `initialize` joins it to a
`torch.distributed` world at a TCP coordinator (NCCL on the card, gloo
on the CPU, unless the caller names a backend), and the same
('dp', 'tp') mesh then spans every process's device:

    from tpu_doom_torch.parallel.distributed import initialize, global_mesh
    initialize(coordinator="host0:1234", num_processes=8, process_id=i)
    mesh = global_mesh(tp=1)   # spans all processes' devices

or from the environment of each process (`torchrun` sets the same
through its own variables, which `initialize_from_env` also reads):

    TPUDOOM_COORDINATOR=host0:1234 TPUDOOM_NUM_PROCS=8 TPUDOOM_PROC_ID=i

`launch` starts such a world of n processes on this host and runs one
function on every rank (`entry.dryrun_multichip`, the tests).
NCCL takes one card per rank: it refuses two ranks on one device, and
`launch` refuses more NCCL ranks than cards. gloo may put several ranks
on one card (`backend="gloo"`), but its collectives cannot be captured
in a CUDA graph. Nothing switches backend or device on its own.
"""

from __future__ import annotations

import faulthandler
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import make_mesh

LAUNCH_TIMEOUT = 900  # seconds a launched world may take


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> bool:
    """`init_process_group` at `tcp://coordinator` (with no coordinator,
    torchrun's `env://`), after choosing this rank's card (its process id
    modulo the cards) when `device` is the card. Returns False, joining
    nothing, for a single process with no coordinator."""
    if num_processes is not None and num_processes <= 1 and coordinator is None:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or default_backend(device),
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    return True


def initialize_from_env(device="cuda") -> bool:
    """Initialize from TPUDOOM_COORDINATOR / TPUDOOM_NUM_PROCS /
    TPUDOOM_PROC_ID, or from torchrun's MASTER_ADDR / WORLD_SIZE / RANK;
    returns False if neither is set (single-process mode)."""
    coord = os.environ.get("TPUDOOM_COORDINATOR")
    if coord:
        return initialize(coordinator=coord,
                          num_processes=int(os.environ["TPUDOOM_NUM_PROCS"]),
                          process_id=int(os.environ["TPUDOOM_PROC_ID"]), device=device)
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        return initialize(device=device)
    return False


def global_mesh(dp: int | None = None, tp: int = 1, device="cuda"):
    """('dp', 'tp') mesh over every process of the world."""
    return make_mesh(dp=dp, tp=tp, device=device)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(results, rank, n, port, backend, device, fn, args):
    """One launched rank: join the world, run fn(*args), leave the world,
    and put (rank, ok, result or traceback) on `results`. A crash prints
    the rank's Python stack (faulthandler)."""
    faulthandler.enable()
    try:
        initialize(f"localhost:{port}", n, rank, backend=backend, device=device)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: report the traceback, exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, value))


def launch(n: int, fn, *args, device="cuda", backend: str | None = None) -> list:
    """Run `fn(*args)` on every rank of a new world of `n` processes on
    this host (start method `spawn`, a free localhost port) -> the ranks'
    results in rank order. `fn` must be importable and its result
    picklable. A rank that fails, dies or outlasts LAUNCH_TIMEOUT ends
    every rank and raises RuntimeError with its traceback."""
    backend = backend or default_backend(device)
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card per rank: {n} ranks, "
                         f"{torch.cuda.device_count()} cards")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(results, r, n, port, backend, str(device), fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    done, failed = {}, {}
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    try:
        while len(done) < n and not failed:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    failed.update({r: f"exit code {procs[r].exitcode}" for r in dead})
                elif time.monotonic() > deadline:
                    failed[-1] = f"timed out after {LAUNCH_TIMEOUT} s"
                continue
            (done if ok else failed)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if not failed else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    if failed:
        raise RuntimeError(f"launch: {len(failed)} of {n} ranks failed:\n"
                           + "\n".join(f"rank {r}: {v}" for r, v in sorted(failed.items())))
    return [done[r] for r in range(n)]
