"""The device trace of a traced run: ``torch.profiler`` over a stretch of the
window (CUDA activity only, so a layer loop's host ops do not swell the
record), read into kernel intervals. Busy time is the union of the
kernels' intervals, not their sum (a kernel launched as a programmatic
dependent starts before its primary ends). The harness records host spans
(what it was driving: a decode, a vocoder call, an admission) beside it,
to name the device's idle gaps."""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import stats


@dataclass
class Kernel:
    name: str
    start_s: float
    end_s: float


@dataclass
class DeviceTrace:
    kernels: List[Kernel]
    window_s: float                 # the traced stretch's wall
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    start_s: float = 0.0            # the stretch, on the kernels' clock
    end_s: float = 0.0

    def busy_s(self) -> float:
        return stats.union_length((k.start_s, k.end_s) for k in self.kernels)

    def time_s(self, pattern: str) -> Optional[float]:
        """Summed device time of the kernels whose name matches
        ``pattern`` (a regular expression); None where none ran."""
        rx = re.compile(pattern)
        hit = [k.end_s - k.start_s for k in self.kernels if rx.search(k.name)]
        return sum(hit) if hit else None

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + (k.end_s - k.start_s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = stats.gaps(((k.start_s, k.end_s) for k in self.kernels),
                          self.start_s, self.end_s)
        idle.sort(key=lambda g: g[0] - g[1])
        named = [[self._host_at((a + b) / 2), b - a] for a, b in idle[:top]]
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": named}

    def _host_at(self, t: float) -> str:
        inner = None
        for name, a, b in self.spans:
            if a <= t < b and (inner is None or b - a < inner[2] - inner[1]):
                inner = (name, a, b)
        return inner[0] if inner else "host: between spans"


def short(name: str, n: int = 120) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= n else name[:n - 3] + "..."


class Tracer:
    """Starts and stops ``torch.profiler`` from whichever thread drives the
    card, once; records host spans on the host's monotonic clock."""

    def __init__(self):
        self._prof = None
        self._lock = threading.Lock()
        self.started = self.stopped = False
        self._t0_ns = self._t1_ns = 0
        self._wall0 = 0
        self.spans: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self.started:
                return
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
            self._t0_ns, self._wall0 = time.monotonic_ns(), time.time_ns()
            self.started = True

    def stop(self) -> None:
        import torch

        with self._lock:
            if not self.started or self.stopped:
                return
            torch.cuda.synchronize()
            self._t1_ns = time.monotonic_ns()
            self._prof.stop()
            self.stopped = True

    def span(self, name: str, fn: Callable, *args, **kw):
        """``fn(*args, **kw)`` recorded as a host span while tracing."""
        t0 = time.monotonic_ns()
        try:
            return fn(*args, **kw)
        finally:
            if self.started and not self.stopped:
                self.spans.append((name, t0, time.monotonic_ns()))

    def read(self) -> Optional[DeviceTrace]:
        """The kernels of the traced stretch, moved from the profiler's
        clock (the wall clock, in nanoseconds) to the host's monotonic one
        by the pair of readings taken at ``start``."""
        if not self.stopped:
            return None
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if "cuda" not in str(e.device_type()).lower():
                continue
            start, dur = e.start_ns(), e.duration_ns()
            if dur > 0:
                events.append((e.name(), start, start + dur))
        window_s = (self._t1_ns - self._t0_ns) / 1e9
        shift = self._wall0 - self._t0_ns
        if events:
            mid = sorted(s for _, s, _ in events)[len(events) // 2] - shift
            if not self._t0_ns - 1e9 <= mid <= self._t1_ns + 1e9:
                raise RuntimeError(
                    "the profiler's kernels do not fall in the traced "
                    f"stretch on the wall clock (median kernel "
                    f"{(mid - self._t0_ns) / 1e9:+.3f} s from its start)")
        kernels = [Kernel(n, (a - shift) / 1e9, (b - shift) / 1e9)
                   for n, a, b in events]
        spans = [(n, a / 1e9, b / 1e9) for n, a, b in self.spans]
        return DeviceTrace(kernels=kernels, window_s=window_s, spans=spans,
                           start_s=self._t0_ns / 1e9,
                           end_s=self._t1_ns / 1e9)
