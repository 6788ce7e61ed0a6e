"""Frame timers: named host-side timers with a 1 Hz textual summary.

Reference: engine/src/frame_timers.rs -- id-slab of named timers with
start/stop/query and a 1 Hz log line "name  N/s (avg ms)" plus
drift/sleep stats. Device work runs asynchronously, so these wrap
host-visible spans (step dispatch, render dispatch, host readbacks and
synchronisations); pair with torch.profiler traces for on-device detail.
A copy of the JAX package's `utils/timers.py` (the port imports nothing
of that package).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)


@dataclass
class _Timer:
    name: str
    seconds_since_logged: float = 0.0
    times_since_logged: int = 0
    _start: float | None = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self) -> float:
        assert self._start is not None, f"timer {self.name} not started"
        elapsed = time.perf_counter() - self._start
        self._start = None
        self.seconds_since_logged += elapsed
        self.times_since_logged += 1
        return elapsed


@dataclass
class FrameTimers:
    """Named timers, 1 Hz summary (ref frame_timers.rs:79-137)."""

    log_period: float = 1.0
    timers: dict[str, _Timer] = field(default_factory=dict)
    _last_log: float = field(default_factory=time.perf_counter)

    def named(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def start(self, name: str):
        self.named(name).start()

    def stop(self, name: str) -> float:
        return self.timers[name].stop()

    def time(self, name: str):
        """Context manager form."""
        timers = self

        class _Span:
            def __enter__(self):
                timers.start(name)

            def __exit__(self, *exc):
                timers.stop(name)

        return _Span()

    def maybe_log(self) -> str | None:
        now = time.perf_counter()
        if now - self._last_log < self.log_period:
            return None
        self._last_log = now
        parts = []
        for t in self.timers.values():
            if t.times_since_logged == 0:
                continue
            rate = t.times_since_logged / max(t.seconds_since_logged, 1e-9)
            avg_ms = 1e3 * t.seconds_since_logged / t.times_since_logged
            parts.append(f"{t.name} {rate:9.1f}/s ({avg_ms:.2f}ms)")
            t.seconds_since_logged = 0.0
            t.times_since_logged = 0
        if not parts:
            return None
        line = "  ".join(parts)
        log.info("%s", line)
        return line
