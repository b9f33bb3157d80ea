"""What the benchmark reads from torch.profiler's trace of a window: the
device's operations (name, start, end), the union of their intervals
(the device-busy seconds), the longest idle gaps labelled by the
benchmark's own `record_function` ranges, and device time by kernel
name."""

from __future__ import annotations

import re

import torch

# The benchmark's ranges around each job's calls into the program, from
# the outermost; an idle gap is labelled by the innermost that covers it.
RANGES = ("bench.job", "bench.engine_build", "bench.compare", "bench.render")


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(spans, t0: float, t1: float) -> list:
    """The (start, end) gaps of [t0, t1] that no interval covers."""
    gaps, end = [], t0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
    if end < t1:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


class Trace:
    """Device events and the benchmark's ranges of one traced window, in
    seconds on the trace's clock."""

    def __init__(self, device_ops: list, ranges: list, t0: float, t1: float):
        self.ops = device_ops  # [(name, start, end)]
        self.ranges = ranges  # [(name, start, end)]
        self.t0, self.t1 = t0, t1

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """From the profiler's raw events (its per-event Python objects
        cost seconds a window).  Annotations on the device's timeline that
        copy the benchmark's ranges are not device work."""
        ops, ranges = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if hasattr(e, "start_ns"):
                a, b = e.start_ns() / 1e9, e.end_ns() / 1e9
            else:
                a = e.start_us() / 1e6
                b = a + e.duration_us() / 1e6
            if name in RANGES:
                if e.device_type() != cuda:
                    ranges.append((name, a, b))
            elif e.device_type() == cuda and not (
                    hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                ops.append((name, a, b))
        jobs = [r for r in ranges if r[0] == RANGES[0]]
        t0 = min((a for _, a, _ in jobs), default=0.0)
        t1 = max((b for _, _, b in jobs), default=0.0)
        return cls(ops, ranges, t0, t1)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return busy_union([(a, b) for _, a, b in self.ops
                           if b > self.t0 and a < self.t1])

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.ops if rx.search(n))

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.ops if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        per = {}
        for name, a, b in self.ops:
            per[name] = per.get(name, 0.0) + (b - a)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], t] for name, t in top]

    def label(self, t: float) -> str:
        """The innermost benchmark range around time t, with how far into
        it t lies."""
        best = None
        for name, a, b in self.ranges:
            if a <= t <= b and (best is None
                                or RANGES.index(name) > RANGES.index(best[0])):
                best = (name, a)
        if best is None:
            return "between jobs"
        return f"{best[0][6:]} +{t - best[1]:.3f}s"

    def top_gaps(self, n: int = 10) -> list:
        gaps = idle_gaps([(a, b) for _, a, b in self.ops], self.t0, self.t1)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.label(a), b - a] for a, b in gaps[:n]]
