"""One run of one cell: set-up, the timed window, the traced window, the
metrics and the check, as `benchmark/run.py` asks for them.

Everything that belongs to one configuration, traffic mix or metric is
found by name: the configuration in the file `BENCHMARK.json` gives it,
its driver in `benchmark/drivers/<kind>.py`, the mix in
`benchmark/traffic/<mix>.json`, each metric's reader in
`benchmark/metrics/<name>.py`.

A run: the cell's WAD files and action stream from the seed; the
program's set-up and `warmup_steps` agent steps (every kernel built, every
graph captured), and on the card one more under the profiler's device
tracing; with --trace 1 a traced window of TRACE_SECONDS of agent
steps under `torch.profiler`; the timed window, agent steps one after
another with no host sync inside, a CUDA event recorded after each, until
the host clock passes --seconds, then a synchronize (with --trace 1 the
port's launch counts are zeroed before it and read after it); the
per-layer metrics' readers; the program freed; then the check (`harness/check.py`).
A run that has loaded a module of JAX or of the JAX package, looked for
after the window and again once everything else is done, raises and
gives no result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
TRACE_SECONDS = 0.5  # the traced window's host time, at least
CHECK_STEPS = 3  # agent steps checked at seeded times in the window, besides the last
CHECK_ENVS = 16  # envs whose frames are checked, drawn from the seed
STEP_SECONDS = 0.3  # the least host time over which step_ms times the step
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_doom")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    """Raise if a module of JAX or of the JAX package is loaded."""
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded {when}: {bad}")


def profiler_activities(device) -> list:
    """What the profiler records: on the card the device's activity alone
    (kernels, copies, the CUDA runtime calls), so that it adds no host
    cost per PyTorch op; on the CPU, where there is no device, the host's
    ops."""
    act = torch.profiler.ProfilerActivity
    return [act.CUDA] if device.type == "cuda" else [act.CPU]


class Cell:
    """A workload of the manifest with its configuration, mix and metrics."""

    def __init__(self, name: str, manifest: dict | None = None):
        self.manifest = manifest or load_json(MANIFEST)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        conf = {c["name"]: c for c in self.manifest["configs"]}[self.workload["config"]]
        self.config = load_json(os.path.join(ROOT, conf["file"]))
        self.mix = load_json(os.path.join(BENCH, "traffic", f"{self.workload['traffic']}.json"))
        self.chips = int(self.workload["chips"])

    def metrics(self, section: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports: those
        that list it, and those without a list whose moved metric (for a
        per-layer one) this cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.manifest[section]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def end_to_end(self) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]


class Context:
    """What a metric's reader reads: the window's timings, the trace, the
    cell and the still-live program."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Clock:
    """A mark after each agent step: a CUDA event on the card (read after
    the window), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def fold(frames: torch.Tensor) -> torch.Tensor:
    """A 0-d int64 checksum of u8 frames: their bytes summed as int64
    words (wrapping), so that every byte of every frame is read."""
    flat = frames.reshape(-1)
    if flat.numel() % 8 == 0:
        return flat.view(torch.int64).sum()
    return flat.sum(dtype=torch.int64)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seeded_rng(seed: int, purpose: int):
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 63), purpose]))


@torch.no_grad()
def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, control: str | None = None,
             overrides: dict | None = None, log=print) -> dict:
    """One run of cell `name`; returns the result line's object. `log`
    takes the lines for standard error. `control` ("bfloat16"): the
    reference in that precision takes the program's place in the check.
    `overrides` replaces keys of the configuration and the mix (the CPU
    tests' small shapes)."""
    from harness.check import check_lines, judge, run_check
    from harness.inputs import WadFiles
    from harness.traffic import make_stream

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = Cell(name)
    for key, value in (overrides or {}).items():
        (cell.mix if key in cell.mix else cell.config)[key] = value
    config, mix = cell.config, cell.mix
    driver = load_module("drivers", config["kind"])
    envs = len(config["levels"]) * int(config["envs_per_level"])
    fs, warmup = int(mix["frame_skip"]), int(mix["warmup_steps"])
    rng = _seeded_rng(seed, 1)
    sample = torch.as_tensor(np.sort(rng.choice(envs, min(CHECK_ENVS, envs), replace=False)),
                             device=device)
    marks = sorted(rng.uniform(0.05, 0.95, CHECK_STEPS) * seconds)

    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    wads = WadFiles(config["levels"])
    try:
        stream = make_stream(mix, envs, seed, device, groups=len(config["levels"]))
        sync(device)
        parts["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        prog = driver.Program(config, mix, wads, stream, device)
        start = prog.start
        sync(device)
        parts["program"] = time.perf_counter() - t
        checksum = torch.zeros((), dtype=torch.int64, device=device)
        k = 0
        for _ in range(warmup):
            t = time.perf_counter()
            checksum += fold(prog.step(k))
            sync(device)
            key = "warmup" if k else "first_step"
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t
            k += 1
        t = time.perf_counter()
        if device.type == "cuda":
            # One agent step under the profiler's device tracing (CUPTI),
            # whose trace is dropped. Without it the card ran about half
            # of the processes, for seconds or for the whole window, in a
            # state ~11 % slower at the same SM clock (PERF.md, §2); with it,
            # every one at the faster rate, ~0.4 % below the untraced one.
            with torch.profiler.profile(activities=profiler_activities(device)):
                checksum += fold(prog.step(k))
                k += 1
                sync(device)
        # The set-up's objects (the level compiler's among them) are kept out
        # of the collector's passes in the windows: a full pass over them
        # stalls the host for milliseconds.
        gc.collect()
        gc.freeze()
        parts["profiler_and_gc"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s ({k} warm-up agent steps of {fs} tics): "
            + ", ".join(f"{name} {v:.3f}" for name, v in parts.items()))

        traced = None
        if trace:
            n0 = k
            with torch.profiler.profile(activities=profiler_activities(device)) as prof:
                with torch.profiler.record_function("benchmark_traced_window"):
                    t0 = time.perf_counter()
                    while time.perf_counter() - t0 < TRACE_SECONDS:
                        checksum += fold(prog.step(k))
                        k += 1
                    sync(device)
            traced = (prof, k - n0)

        if trace:
            prog.reset_counts()
        clock = Clock(device)
        snapshots = []
        n0 = k
        clock.mark()
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            last = elapsed >= seconds
            take = last or (marks and elapsed >= marks[0])
            if take and not last:
                marks.pop(0)
            pre = prog.capture() if take else None
            frames = prog.step(k)
            checksum += fold(frames)
            clock.mark()
            if take:
                snapshots.append((k, pre, prog.capture(), prog.take_frames(frames, sample)))
            k += 1
            if last:
                break
        issued = time.perf_counter() - t0
        sync(device)
        wall = time.perf_counter() - t0
        steps = k - n0
        refuse_forbidden("by the end of the window")
        counts = prog.counts() if trace else None
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        log(f"window {wall:.3f} s, {steps} agent steps of {fs} tics x {envs} envs,"
            f" the last issued at {issued:.3f} s, checksum {int(checksum)}")
        times = clock.intervals_ms()
        q = statistics.quantiles(times, n=100) if len(times) > 1 else times * 99
        log(f"agent step ms: p50 {q[49]:.4f}, p90 {q[89]:.4f}, p95 {q[94]:.4f}, p99"
            f" {q[98]:.4f}, max {max(times):.4f}; over 1.25 x p50:"
            f" {sum(t > 1.25 * q[49] for t in times)} of {len(times)}")

        ctx = Context(cell=cell, config=config, mix=mix, envs=envs, wads=wads,
                      setup_s=setup_s, wall_s=wall, steps=steps, tics=steps * fs,
                      step_ms=times, counts=counts, program=prog, step_index=k,
                      device=device, trace=None, traced_steps=0)
        result = {"correct": False, "attempted": steps, "failed": 0, "metrics": {},
                  "device": device_info(device, cell.chips, peak)}
        sections = ("per_layer",) if trace else ("end_to_end",)
        if trace:
            from harness.trace import Trace

            tr = Trace(traced[0])
            ctx.trace, ctx.traced_steps = tr, traced[1]
            result["device"]["busy_s"] = tr.busy_s
            result["device"]["window_s"] = tr.window_s
            log(f"traced window: {traced[1]} agent steps, {tr.window_s:.4f} s, device busy"
                f" {tr.busy_s:.4f} s in {len(tr.ops)} operations")
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
            ctx.step_seconds = STEP_SECONDS
        for section in sections:
            for m in cell.metrics(section):
                value = load_module("metrics", m["name"]).read(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        gc.unfreeze()
        prog.free()
        del prog, ctx, frames

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t1 = time.perf_counter()
        reference = driver.Reference(config, mix, wads, device)
        limits = config["limits"]
        readings, failed, low = run_check(reference, start, snapshots, stream, sample, limits,
                                          lower=getattr(torch, control) if control else None)
        sync(device)
        log(f"check: {len(snapshots)} agent steps and the start against the reference"
            f" in {time.perf_counter() - t1:.3f} s")
    finally:
        wads.close()
    result["correct"] = judge(readings, limits)
    result["failed"] = failed
    if low is not None:
        result["control"] = {"precision": control, **low}
        log(f"control ({control}): {json.dumps(low)}, correct {judge(low, limits)}")
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    refuse_forbidden("by the end of the run")
    for line in check_lines(readings, limits):
        log(line)
    return result


def device_info(device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}


def p95(values) -> float:
    """The 95th percentile, as statistics.quantiles(n=20) (exclusive) gives it."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]
