"""The device trace of a run's traced window (`torch.profiler`, CUPTI on
the card), reduced to what the per-layer metrics and the result's
`breakdown` read: the device operations (kernels, copies, sets) and the
host ops inside the window, the union of the device's busy intervals,
and the idle gaps by what the host was doing.

On the card the profiler records the device's activity alone (no host
op, so that tracing adds no host cost per PyTorch op): the window is
then the span from the first device operation's start to the last one's
end, and the host side is the CUDA runtime calls. Where the host's ops
are recorded (on the CPU), the window is the span of one
`record_function` range that ends after a synchronize, so every device
operation it caused ends inside it. Either way its busy time and its
span come from the same trace.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW = "benchmark_traced_window"
TOP = 10  # entries of each breakdown list
GAPS_NAMED = 256  # the longest idle gaps that are attributed to a host op
NAME_CHARS = 200


class Trace:
    """`ops`: (name, start_us, end_us) of each device operation in the
    window; `host`: the same of each host op; `start_us`, `end_us`: the
    window."""

    def __init__(self, prof):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        events = [e for e in prof.events() if e.name != WINDOW]
        win = [e for e in prof.events() if e.name == WINDOW and e.device_type == cpu]
        dev = [e for e in events if e.device_type == cuda]
        if len(win) > 1 or not (win or dev):
            raise RuntimeError(f"trace: {len(win)} windows named {WINDOW!r} and"
                               f" {len(dev)} device operations")
        if win:
            self.start_us = float(win[0].time_range.start)
            self.end_us = float(win[0].time_range.end)
        else:
            self.start_us = min(float(e.time_range.start) for e in dev)
            self.end_us = max(float(e.time_range.end) for e in dev)

        def inside(e):
            return e.time_range.end > self.start_us and e.time_range.start < self.end_us

        self.ops = [(e.name, max(float(e.time_range.start), self.start_us),
                     min(float(e.time_range.end), self.end_us))
                    for e in events if e.device_type == cuda and inside(e)]
        self.host = [(e.name, float(e.time_range.start), float(e.time_range.end))
                     for e in events if e.device_type == cpu and inside(e)]
        self.busy = self._union()

    def _union(self) -> list:
        spans = sorted((s, e) for _, s, e in self.ops if e > s)
        out: list = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def op_seconds(self, *substrings) -> float:
        """Device seconds of the operations whose name holds any of
        `substrings`."""
        return sum(e - s for n, s, e in self.ops if any(x in n for x in substrings)) / 1e6

    def device_ops(self) -> list:
        """The TOP device operations by their total seconds."""
        total: dict = {}
        for n, s, e in self.ops:
            total[n] = total.get(n, 0.0) + (e - s) / 1e6
        return [[n[:NAME_CHARS], v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """The idle gaps' seconds by the innermost host op running at
        each gap's middle ("no host op" where none ran), the TOP largest
        totals over the GAPS_NAMED longest gaps."""
        edges = [self.start_us] + [x for s, e in self.busy for x in (s, e)] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]
        if not gaps:
            return []
        names = [n for n, _, _ in self.host]
        hs = np.array([s for _, s, _ in self.host] or [0.0])
        he = np.array([e for _, _, e in self.host] or [0.0])
        total: dict = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            hit = np.nonzero((hs <= mid) & (he >= mid))[0] if names else []
            name = names[hit[np.argmin(he[hit] - hs[hit])]] if len(hit) else "no host op"
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[n[:NAME_CHARS], v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
