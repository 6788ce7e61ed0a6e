"""Spans and counters of the port's main path, timed where the work runs.

Off by default. With tracing off a span costs one bool check, and only
where Python runs: on the card a tick's Python runs only while its graph
is captured, so a replay costs nothing, and every captured graph is the
one an untraced program captures.

    from tpu_doom_torch import trace

    trace.enable()        # the card if there is one; calibrates its clock
    ...                   # DoomSim.rollout, LevelBank ticks, ...
    rec = trace.spans()   # synchronises once; the spans since the last read
    trace.counts()        # {"overflow_envs": n, "migrated_envs": n, ...}
    trace.disable()

On the card each span's start and end is a one-thread kernel
(`csrc/trace.cu`) that writes `%globaltimer` into a device ring of
ticks x slots; inside a capture the kernel is a node of the graph. A
tick's first stamp increments a device tick counter, and every later
stamp writes the row of the tick the counter holds, so nothing
synchronises per tick. `graphs.CapturedTick` replays a traced twin of its
graph while tracing is on. On the CPU the same spans take
`time.monotonic_ns()`. Host spans (`host.replay`, `host.actions`,
`host.frames`, `host.rollout`) take the host clock under the same tick
id. `spans()` maps every device stamp onto the host clock by the offsets
`enable()` and the read itself measured, so that a device gap between the program's spans
can be put down to the host span open at its start (`Spans.gaps`).

A span is named by its path: its name, its parent's path and its rank
among its parent's children of that name. Each path owns two slots of a
tick's row (start, end), the same in every graph and eager tick that
opens it. The spans of the main path:

    actions                the action copy into a graph's buffer (issued
                           before its tick, so under the next tick's id)
    tick                   one tick, captured or eager
      step                 sim/step.py; a bank's per level
        effects            kernel S1 (csrc/step.cu): effects, toggles, B1's rows
        player             kernel B1 (csrc/player_move.cu): the sweeps
        triggers           kernel S2 (csrc/step.cu): the player math after
                           the sweeps, the triggers, the clock
                           (`legacy` or the broad phase off: the same
                           spans around the plain effects, the oracle's
                           sweeps and player math, the plain triggers)
      migrate              LevelBank.step_with_exits after the step
      render               render_dispatch; a bank's per level
        walk               W0, W1 and W2 (render/portal.py:walk)
          select           kernel B4 (csrc/select_rows.cu): every attribute
                           column at every crossing, on big levels without
                           crossing compaction only
        raster, fallback
      frames               a bank's stack of its levels' frames
    frames                 TickGraphs.run's copy of a rendered frame out

Counters (`count`) add on the device, with no sync: `overflow_envs`, the
envs sent to the triangle fallback; `migrated_envs`, the envs that
changed level; and, counted only where W0's visible-row cull runs (big
levels), `cull_overflow_envs`, the envs over the visible-row budget, sent
to the fallback by the cull, and `visible_rows`, W0's visible rows summed
over the envs. A device's counters are made by `enable()` or `counter()`
and from then on count in every tick run or captured on it, traced or
not, so that a caller that times untraced graphs can read them too
(`counter()`); before they are made, `count` adds nothing to a graph.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

RING_TICKS = 4096  # ticks the ring of a session begun by enable() keeps between reads
SLOTS = 512  # slots of a tick's row: a start and an end for each of 256 span paths
CALIBRATION_LAUNCHES = 64
RESOLUTION_STEPS = 256
COUNTERS = ("overflow_envs", "migrated_envs", "cull_overflow_envs", "visible_rows")
HOST = "host."  # the prefix of host spans' names

_session = None  # the tracing session under way, or None
_counters: dict = {}  # device -> the int64 (len(COUNTERS),) counters, once made


class Span(NamedTuple):
    name: str
    start_ns: int  # host CLOCK_MONOTONIC
    end_ns: int
    parent: int  # index of the parent span in the same list, -1 for none
    tick: int


@dataclasses.dataclass
class Spans:
    """The spans of ticks `first_tick`..`last_tick` on the host clock,
    ordered by tick, then start. `error_ns` bounds the error of a device
    stamp mapped onto the host clock (0 on the CPU); `resolution_ns` is
    the device clock's smallest step. `dropped_ticks` ticks were
    overwritten before they were read; `unrecorded` spans found no free
    slot."""

    spans: list
    first_tick: int
    last_tick: int
    dropped_ticks: int
    error_ns: int
    resolution_ns: int
    unrecorded: int

    def top(self) -> list:
        """The program's outermost spans, by start: `tick`, `actions`,
        `frames` (and an eager caller's layers outside a tick)."""
        return sorted((s for s in self.spans if s.parent < 0 and not s.name.startswith(HOST)),
                      key=lambda s: s.start_ns)

    def busy(self) -> list:
        """The union of the outermost device spans: (start, end) ns."""
        out: list = []
        for s in self.top():
            if out and s.start_ns <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s.end_ns)
            else:
                out.append([s.start_ns, s.end_ns])
        return out

    def window_ns(self) -> int:
        busy = self.busy()
        return busy[-1][1] - busy[0][0] if busy else 0

    def idle_share(self) -> float:
        """100 x the device time inside none of the program's spans over
        the first start to the last end; None without spans."""
        busy, window = self.busy(), self.window_ns()
        if window <= 0:
            return None
        return 100.0 * (window - sum(e - s for s, e in busy)) / window

    def total_ms(self, name: str) -> float:
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name == name) / 1e6

    def gaps(self) -> dict:
        """{host span open at a device gap's start, or "caller": ms of
        gaps}: each idle interval between the program's device spans put
        down to what the host was doing when the device ran dry."""
        hosts = sorted((s for s in self.spans if s.name.startswith(HOST)),
                       key=lambda s: s.start_ns)
        starts = [s.start_ns for s in hosts]
        out: dict = {}
        busy = self.busy()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            who = "caller"
            # Host spans nest: the latest-starting one open at `a` is the
            # innermost; past an outermost one that ended, none is open.
            for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
                if hosts[i].end_ns >= a:
                    who = hosts[i].name
                    break
                if hosts[i].parent < 0:
                    break
            out[who] = out.get(who, 0.0) + (b - a) / 1e6
        return out


class _Session:
    """One enable() to disable(): the rings, the span paths, the clocks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.rows = RING_TICKS + 1  # one more: a span issued ahead writes the next tick's row
        self.paths: dict = {}  # (parent path, name, rank) -> path id
        self.names: list = []  # path id -> name
        self.parents: list = []  # path id -> parent path id, -1 for none
        self.host_ring = np.full((self.rows, SLOTS, 2), -1, dtype=np.int64)
        self.tick = 0  # the last tick opened (the device counter's value)
        self.read = 0  # the last tick spans() returned
        self.unrecorded = 0
        self.open: list = []  # open device spans
        self.open_host: list = []  # open host spans
        self.paused = 0
        self.capturing = False
        self.clock = (0, 0, 0)  # (device ns, offset ns, error bound ns) of a calibration
        self.resolution_ns = 0
        if self.cuda:
            self.ring = torch.full((self.rows, SLOTS, 2), -1, dtype=torch.int64, device=device)
            self.counter = torch.zeros(1, dtype=torch.int64, device=device)
            self.clock = self.calibrate()

    def path(self, parent, name: str):
        """The path id of a span named `name` opened under `parent` (an
        open span, or None); None when the row is full."""
        if parent is not None and parent.path is None:
            return None
        p, rank = -1, 0
        if parent is not None:
            p = parent.path
            rank = parent.kids.get(name, 0)
            parent.kids[name] = rank + 1
        key = (p, name, rank)
        path = self.paths.get(key)
        if path is None:
            if len(self.names) == SLOTS // 2:
                self.unrecorded += 1
                return None
            path = self.paths[key] = len(self.names)
            self.names.append(name)
            self.parents.append(p)
        return path

    def stamp(self, slot: int, tick: int, ahead: int, opens: bool, host: bool) -> None:
        """Write the time into `slot` of tick `tick`'s row: on the card
        (unless `host`) by a stamp kernel on the current stream, whose
        tick is the device counter + `ahead`; else the host clock."""
        if self.cuda and not host:
            from ._build import check, load

            stream = torch.cuda.current_stream(self.device).cuda_stream
            check(load().tdt_trace_stamp(self.ring.data_ptr(), self.counter.data_ptr(), slot,
                                         SLOTS, self.rows, ahead, int(opens), stream),
                  "trace stamp")
        else:
            self.host_ring[tick % self.rows, slot] = (tick, time.monotonic_ns())

    def calibrate(self) -> tuple:
        """(device ns, %globaltimer - CLOCK_MONOTONIC ns, error bound ns):
        each of CALIBRATION_LAUNCHES stamps, bracketed by host clock reads
        and a synchronize, bounds the offset to an interval (widened by the
        device clock's step); the offset is the middle of their
        intersection, or of the tightest one should clock drift leave none."""
        from ._build import check, load

        lib, dev = load(), self.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        if not self.resolution_ns:
            out = torch.zeros(1, dtype=torch.int64, device=dev)
            check(lib.tdt_trace_resolution(out.data_ptr(), RESOLUTION_STEPS, stream),
                  "trace resolution")
            self.resolution_ns = int(out)
        res = self.resolution_ns
        buf = torch.zeros((1, 1, 2), dtype=torch.int64, device=dev)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        torch.cuda.synchronize(dev)
        bounds = []
        for _ in range(CALIBRATION_LAUNCHES):
            h0 = time.monotonic_ns()
            check(lib.tdt_trace_stamp(buf.data_ptr(), zero.data_ptr(), 0, 1, 1, 0, 0, stream),
                  "trace stamp")
            torch.cuda.synchronize(dev)
            h1 = time.monotonic_ns()
            d = int(buf[0, 0, 1])
            bounds.append((d - h1, d + res - h0))
        lo, hi = max(b[0] for b in bounds), min(b[1] for b in bounds)
        if lo > hi:
            lo, hi = min(bounds, key=lambda b: b[1] - b[0])
        return d, (lo + hi) // 2, (hi - lo + 1) // 2 + res


class _Null:
    """The span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """A span at a layer boundary: stamps on the card, the host clock on
    the CPU. `ahead` = 1 files it under the next tick (it precedes its
    tick's graph); `host` also records it as a host span."""

    __slots__ = ("name", "ahead", "host", "session", "path", "tick", "kids", "host_span")

    def __init__(self, name: str, ahead: int, host: bool):
        self.name, self.ahead, self.host = name, ahead, host

    def __enter__(self):
        s = self.session = _session
        if s is None or s.paused:
            self.session = None
            return None
        self.path = s.path(s.open[-1] if s.open else None, self.name)
        self.kids = {}
        opens = self.name == "tick"
        if opens and not s.capturing:
            s.tick += 1
        self.tick = s.tick + self.ahead
        if self.path is not None:
            s.stamp(2 * self.path, self.tick, 1 if opens else self.ahead, opens, False)
        s.open.append(self)
        self.host_span = None
        if self.host:
            self.host_span = _HostSpan(self.name, self.ahead)
            self.host_span.__enter__()
        return None

    def __exit__(self, *exc):
        s = self.session
        if s is None:
            return False
        if self.host_span is not None:
            self.host_span.__exit__()
        s.open.pop()
        if self.path is not None:
            s.stamp(2 * self.path + 1, self.tick, 0 if self.name == "tick" else self.ahead,
                    False, False)
        return False


class _HostSpan:
    """A span of the host's own work, `host.<name>`, on the host clock."""

    __slots__ = ("name", "ahead", "session", "path", "tick", "kids")

    def __init__(self, name: str, ahead: int):
        self.name, self.ahead = HOST + name, ahead

    def __enter__(self):
        s = self.session = _session
        if s is None or s.paused or s.capturing:
            self.session = None
            return None
        self.path = s.path(s.open_host[-1] if s.open_host else None, self.name)
        self.kids = {}
        self.tick = s.tick + self.ahead
        if self.path is not None:
            s.stamp(2 * self.path, self.tick, 0, False, True)
        s.open_host.append(self)
        return None

    def __exit__(self, *exc):
        s = self.session
        if s is None:
            return False
        s.open_host.pop()
        if self.path is not None:
            s.stamp(2 * self.path + 1, self.tick, 0, False, True)
        return False


def span(name: str, ahead: int = 0, host: bool = False):
    """`with trace.span(name):` around a layer's work. A span named
    "tick" opens a new tick."""
    if _session is None:
        return _NULL
    return _Span(name, ahead, host)


def tick_span():
    """A `tick` span, unless one is open (a caller's, or a captured
    tick's): an eager caller's tick opens where its first layer does."""
    s = _session
    if s is None or any(o.name == "tick" for o in s.open):
        return _NULL
    return _Span("tick", 0, False)


def host_span(name: str, ahead: int = 0):
    """`with trace.host_span(name):` around the host's own work of a tick
    (`host.<name>`)."""
    if _session is None:
        return _NULL
    return _HostSpan(name, ahead)


def count(name: str, values: torch.Tensor) -> None:
    """Add the sum of `values` (the true entries of a mask) to counter
    `name` of their device, on the device, once its counters are made."""
    c = _counters.get(values.device)
    if c is not None:
        c[COUNTERS.index(name)].add_(values.sum())


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def counter(name: str, device) -> torch.Tensor:
    """The 0-d int64 tensor on `device` to which every later count of
    `name` there adds, traced or not. The device's counters are made at
    the first call (or enable()), which must come before the captures they
    are to count; zero and read the tensor as any tensor."""
    dev = _device(device)
    if dev not in _counters:
        _counters[dev] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    return _counters[dev][COUNTERS.index(name)]


def enable(device=None) -> None:
    """Start a tracing session on `device` (the current card if torch sees
    one, else the CPU) whose ring keeps RING_TICKS ticks between reads,
    and zero its counters (making them if needed). On the card this
    launches the stamp kernel (building the kernels if needed) and
    measures the device clock against the host's."""
    global _session
    dev = _device(device if device is not None else
                  "cuda" if torch.cuda.is_available() else "cpu")
    _session = None
    _session = _Session(dev)
    counter(COUNTERS[0], dev)
    _counters[dev].zero_()


def disable() -> None:
    """End the session: spans cost nothing again, and each CapturedTick
    replays its untraced graph (dropping its twin). The counters stay."""
    global _session
    _session = None


def session():
    """The session under way (an opaque object), or None."""
    return _session


def _require():
    if _session is None:
        raise RuntimeError("trace: tracing is off; call trace.enable() first")
    return _session


def reset() -> None:
    """Drop the spans recorded so far and zero the counters."""
    s = _require()
    if s.cuda:
        torch.cuda.synchronize(s.device)
        s.tick = int(s.counter)
    s.read = s.tick
    _counters[s.device].zero_()


def counts() -> dict:
    """{counter: value} since enable() or reset() (synchronises)."""
    s = _require()
    return dict(zip(COUNTERS, _counters[s.device].tolist()))


def spans() -> Spans:
    """The spans of the ticks since the last read, on the host clock
    (synchronises once). Ticks the ring overwrote before this read are
    counted in `dropped_ticks`."""
    s = _require()
    rings = [(s.host_ring, None)]
    error = 0
    if s.cuda:
        torch.cuda.synchronize(s.device)
        s.tick = int(s.counter)
        # The offset drifts (~0.35 us/s on an H100): it is measured again
        # and each stamp mapped by the line through the two calibrations.
        (t0, o0, e0), (t1, o1, e1) = s.clock, s.calibrate()
        s.clock, error = (t1, o1, e1), max(e0, e1)
        rings.append((s.ring.cpu().numpy(), (t0, o0, (o1 - o0) / max(t1 - t0, 1))))
    last = s.tick
    first = max(s.read + 1, last - s.rows + 2)
    dropped = max(0, first - s.read - 1)
    s.read = last
    ticks = np.arange(first, last + 1)
    found = []  # (tick, start, end, path)
    for ring, line in rings:
        rows = ring[ticks % s.rows]  # (T, SLOTS, 2)
        ok = rows[:, :, 0] == ticks[:, None]
        ti, pi = np.nonzero(ok[:, 0::2] & ok[:, 1::2])
        start, end = rows[ti, 2 * pi, 1], rows[ti, 2 * pi + 1, 1]
        if line is not None:  # device ns onto the host clock
            t0, o0, slope = line
            start = start - np.rint(o0 + (start - t0) * slope).astype(np.int64)
            end = end - np.rint(o0 + (end - t0) * slope).astype(np.int64)
        found += zip(ticks[ti].tolist(), start.tolist(), end.tolist(), pi.tolist())
    found.sort()
    # A span's parent is the latest span of its parent's path opened before
    # it: in its own tick, or for a host span such as host.replay, under
    # host.rollout, in the tick its caller's call began.
    out, latest = [], {}
    for t, a, b, p in found:
        out.append(Span(s.names[p], a, b, latest.get(s.parents[p], -1), t))
        latest[p] = len(out) - 1
    return Spans(out, first, last, dropped, error, s.resolution_ns, s.unrecorded)


@contextlib.contextmanager
def paused():
    """Spans inside do nothing: a graph captured inside holds no stamp
    (`CapturedTick`'s untraced graph, a conditional node's body)."""
    s = _session
    if s is None:
        yield
        return
    s.paused += 1
    try:
        yield
    finally:
        s.paused -= 1


@contextlib.contextmanager
def capturing():
    """A traced graph is being captured inside: its stamps are nodes, and
    the host's tick moves at each replay (`open_tick`), not here."""
    s = _require()
    prev = s.capturing
    s.capturing = True
    try:
        yield
    finally:
        s.capturing = prev


def open_tick() -> None:
    """A traced graph is about to replay: the host's copy of the device
    tick counter moves with the stamp that opens the graph's tick."""
    _require().tick += 1
