"""Captured ticks: `step_n` and `DoomSim.rollout` on the card.

The JAX package runs a rollout as one compiled program (`lax.scan` over
the ticks): one dispatch and no host round-trip. Here a tick's work is
captured once as a CUDA graph over static buffers and replayed per tick:
`TickGraphs` keeps a step graph and a step + render graph per batch size
(and image size), sharing the state and action buffers and one memory
pool. Between replays the host only copies the tick's actions into the
action buffer and the rendered frame out of the graph, both on the
device; the graph writes the new state back into the state buffer.
On the CPU the same loop runs eagerly. A level bank's tick
(`LevelBank.step_with_exits`, then every level's render) is captured the
same way with `CapturedTick`, its state the (state, active mask) pair.

What the eager tick decides on the host, a captured one decides on the
device. `device_while` is the only such decision, the triangle fallback
of `render/portal.py`: inside a capture its body becomes the body of a
conditional (WHILE) node (csrc/graph_while.cu) that a replay runs as
long as its flag, computed by the graph, is true. Eagerly the body runs a
fixed number of times, unconditionally; under `device_decisions()` that
is how a capture's warm-up tick runs every op the graph will hold (the
kernels are loaded, the cached device constants of `_numerics` made) and
how the CPU tests check that the device form equals the host branch.

Launch counts: a kernel wrapper counts its launches where it launches. A
capture launches nothing, so `CapturedTick` takes the capture's counts
back and each replay adds them; a conditional body's launches count once
for every run of it, from a device counter the body increments (read by
`ops.launch_counts`).
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch

from . import trace
from .sim.state import Actions, SimState, null_actions

MAX_BODIES = 1024  # conditional bodies one capture may hold (counters made before it)

_captures: list = []  # the captures under way, innermost last
_bodies = weakref.WeakSet()  # the bodies of every live captured tick
_device_decisions = [False]


class _Body:
    """A conditional node's body: the launches of one run, and a 0-d
    int64 device counter of its runs."""

    def __init__(self, launches: dict, runs: torch.Tensor):
        self.launches = launches
        self.runs = runs


class _Capture:
    """What a capture under way needs ready before it starts: the stream
    that captures conditional bodies, their memory pool and counters."""

    def __init__(self, device: torch.device):
        # High priority: torch's graph capture stream comes from the pool of
        # normal-priority streams, so the two are never the same stream.
        self.body_stream = torch.cuda.Stream(device, priority=-1)
        self.body_pool = torch.cuda.MemPool()
        self.counters = torch.zeros(MAX_BODIES, dtype=torch.int64, device=device)
        self.bodies: list[_Body] = []


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@contextlib.contextmanager
def device_decisions():
    """Take the device form of the host's decisions eagerly, on any
    device (`device_while` bodies then run unconditionally)."""
    prev = _device_decisions[0]
    _device_decisions[0] = True
    try:
        yield
    finally:
        _device_decisions[0] = prev


def decides_on_device(t: torch.Tensor) -> bool:
    """Whether a decision on `t` must stay on the device: inside a capture
    on its stream, or under `device_decisions()`."""
    return _device_decisions[0] or (t.is_cuda and torch.cuda.is_current_stream_capturing())


def device_while(cond, body, runs: int) -> None:
    """Run `body()` while `cond()`, a 0-d bool tensor made before the first
    run and after each, is true, deciding on the device. Inside a capture
    `body` is the body of a WHILE node that each replay runs as often as
    the graph's `cond()` asks; outside one `body()` runs `runs` times
    unconditionally, so each run must leave the same result whatever
    `cond()` holds, and `runs` runs must do all the work."""
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        for _ in range(runs):
            body()
        return
    from ._build import check, load
    from .ops import host_launch_counts

    if not _captures:
        raise RuntimeError("device_while: a CUDA graph capture not made by graphs.CapturedTick")
    cap = _captures[-1]
    if len(cap.bodies) == MAX_BODIES:
        raise RuntimeError(f"device_while: more than {MAX_BODIES} conditional bodies in one"
                           " capture")
    counter = cap.counters[len(cap.bodies)]
    flag = cond().to(torch.bool).contiguous()
    main, stream = torch.cuda.current_stream(flag.device), cap.body_stream
    handle = ctypes.c_uint64()
    before = host_launch_counts()
    check(load().tdt_while_begin(main.cuda_stream, stream.cuda_stream, flag.data_ptr(),
                                 ctypes.byref(handle)), "device_while (conditional node)")
    again = None
    # The body's allocations, made on the body stream, come from a pool
    # that lives as long as the captured tick, as the graph's own do.
    try:
        # Its runs are counted, not stamped: the fallback's span is the
        # node's on the capturing stream.
        with torch.cuda.use_mem_pool(cap.body_pool, flag.device), torch.cuda.stream(stream), \
                trace.paused():
            counter.add_(1)
            body()
            again = cond().to(torch.bool).contiguous()
    finally:
        err = load().tdt_while_end(stream.cuda_stream, ctypes.byref(handle),
                                   None if again is None else again.data_ptr())
    check(err, "device_while (conditional node)")
    cap.bodies.append(_Body(_diff(host_launch_counts(), before), counter))


def conditional_launches() -> dict:
    """{kernel: launches} of the live conditional bodies since their
    counters were last reset (reads the counters: synchronises)."""
    out: dict = {}
    for b in list(_bodies):
        runs = int(b.runs)
        for name, n in b.launches.items():
            out[name] = out.get(name, 0) + n * runs
    return out


def reset_conditional_runs() -> None:
    for b in list(_bodies):
        b.runs.zero_()


def _leaves(tree) -> list:
    """The tensors of a tensor, or of a (nested) tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


class _TickGraph:
    """One capture of a CapturedTick's tick: the graph, its other outputs,
    its conditional bodies (and their memory pool) and its launches per
    replay outside the bodies."""

    def __init__(self, tick, state_buf, actions_buf, pool):
        from .ops import add_launches, host_launch_counts

        cap = _Capture(_leaves(state_buf)[0].device)
        self.graph = torch.cuda.CUDAGraph()
        before = host_launch_counts()
        _captures.append(cap)
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                with trace.span("tick"):
                    new, *outs = tick(state_buf, actions_buf)
                    torch._foreach_copy_(_leaves(state_buf), _leaves(new))
        finally:
            _captures.pop()
            captured = _diff(host_launch_counts(), before)
            add_launches({k: -n for k, n in captured.items()})  # nothing ran
        self.outs = outs
        self.bodies, self.body_pool = cap.bodies, cap.body_pool
        _bodies.update(cap.bodies)
        launches = dict(captured)
        for b in cap.bodies:
            for name, n in b.launches.items():
                launches[name] -= n
        self.launches = {k: n for k, n in launches.items() if n}


class CapturedTick:
    """`tick(state, actions) -> (state, *outs)` captured as one CUDA graph
    that reads `state_buf` and `actions_buf` and writes the new state back
    into `state_buf`; `outs` are its other outputs, rewritten by every
    replay. The state is a SimState or any tuple of tensors and SimStates,
    such as a level bank's (state, active mask): every tensor of it is
    written back. The tick keeps both buffers (`state_buf`,
    `actions_buf`) and `tick` itself, with whatever its closure holds
    (a bank's stacked scenes): the graph reads their memory at every
    replay, and memory freed under a live graph is handed to the next
    allocation (a second bank's scenes read as the first's). An eager
    warm-up call under `device_decisions()` comes first (it also sets up
    the communicators of any collective in the tick); a capture that
    fails raises. The capture is thread-local: another thread of the
    process, such as NCCL's watchdog querying the warm-up's collectives,
    may call the runtime meanwhile, while a host read in the tick itself
    still fails the capture.

    This graph holds no span of `trace`: while tracing is on, `replay`
    replays a traced twin instead, captured at its first such replay from
    the same tick and buffers (and again in each tracing session), whose
    stamps are graph nodes; `outs` are then the twin's."""

    def __init__(self, tick, state_buf, actions_buf: Actions, pool=None):
        self.tick, self.state_buf, self.actions_buf = tick, state_buf, actions_buf
        self.pool = pool
        with trace.paused():
            with device_decisions():
                tick(state_buf, actions_buf)
            plain = _TickGraph(tick, state_buf, actions_buf, pool)
        self._plain, self._traced = plain, None
        self.graph, self.outs, self.bodies = plain.graph, plain.outs, plain.bodies
        self.launches = plain.launches

    def replay(self) -> None:
        from .ops import add_launches

        session = trace.session()
        g = self._plain
        if session is not None:
            if self._traced is None or self._traced[0] is not session:
                self._traced = None
                with trace.capturing():
                    self._traced = (session, _TickGraph(self.tick, self.state_buf,
                                                       self.actions_buf, self.pool))
            g = self._traced[1]
            trace.open_tick()
            with trace.host_span("replay"):
                g.graph.replay()
        else:
            self._traced = None
            g.graph.replay()
        self.outs = g.outs
        add_launches(g.launches)


class TickGraphs:
    """The captured ticks of one scene and config: `step(state, actions)
    -> state` alone, and followed by `render(state, width, height) ->
    (B, H, W) u8` when given, each captured at its first use per batch
    size (and image size) and replayed after."""

    def __init__(self, step, render=None):
        self.step = step
        self.render = render
        self.ticks: dict = {}  # ("step", B) / ("render", B, W, H) -> CapturedTick
        self._buffers: dict = {}  # B -> (state_buf, actions_buf)
        self._pool = None

    def _tick(self, key, state_buf, actions_buf) -> CapturedTick:
        if key not in self.ticks:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            if key[0] == "step":
                fn = lambda s, a: (self.step(s, a),)  # noqa: E731
            else:
                w, h = key[2], key[3]

                def fn(s, a):
                    s = self.step(s, a)
                    return s, self.render(s, w, h)
            self.ticks[key] = CapturedTick(fn, state_buf, actions_buf, self._pool)
        return self.ticks[key]

    @torch.no_grad()
    def run(self, state: SimState, action_seq, n: int, render_every: int = 0,
            width: int = 0, height: int = 0):
        """n ticks from `state` with actions `action_seq` ((n, B, ...)
        Actions, None for idle ticks). With render_every > 0 one frame per
        chunk of render_every ticks, rendered after its last tick, then
        the n % render_every trailing ticks unrendered, as the JAX
        package's `DoomSim.rollout`. Returns (final state, frames (F, B,
        H, W) u8, or None with render_every = 0)."""
        B, dev = state.pos.shape[0], state.pos.device
        chunks, rem = divmod(n, render_every) if render_every > 0 else (0, n)
        frames = (torch.empty((chunks, B, height, width), dtype=torch.uint8, device=dev)
                  if render_every > 0 else None)
        if action_seq is not None:
            action_seq = Actions(*(x.to(dev) for x in action_seq))
        plan = ([False] * (render_every - 1) + [True]) * chunks + [False] * rem

        if dev.type != "cuda":
            idle = null_actions(B, dev)
            for t, rendered in enumerate(plan):
                with trace.span("actions", ahead=1, host=True):
                    acts = idle if action_seq is None else Actions(*(x[t] for x in action_seq))
                with trace.span("tick"):
                    state = self.step(state, acts)
                    frame = self.render(state, width, height) if rendered else None
                if rendered:
                    with trace.span("frames", host=True):
                        frames[t // render_every] = frame
            return state, frames

        if B not in self._buffers:
            self._buffers[B] = (SimState(*(x.clone() for x in state)),
                                null_actions(B, dev))
        sbuf, abuf = self._buffers[B]
        torch._foreach_copy_(list(sbuf), list(state))
        if action_seq is None:
            torch._foreach_zero_(list(abuf))
        graphs = {False: self._tick(("step", B), sbuf, abuf) if False in plan else None,
                  True: (self._tick(("render", B, width, height), sbuf, abuf)
                         if True in plan else None)}
        for t, rendered in enumerate(plan):
            if action_seq is not None:
                with trace.span("actions", ahead=1, host=True):
                    torch._foreach_copy_(list(abuf), [x[t] for x in action_seq])
            graphs[rendered].replay()
            if rendered:
                with trace.span("frames", host=True):
                    frames[t // render_every].copy_(graphs[True].outs[0])
        return SimState(*(x.clone() for x in sbuf)), frames
