"""The program's own ranges in a traced window: the port's `PhaseTimer`
phases, which it opens as `record_function("imsame.<phase>")` while a
torch profiler records.  Seconds by phase, and the device's idle time
put down to the innermost phase around each part of it, beside what
`trace.Trace` reads of the same profiler."""

from __future__ import annotations

import heapq

import torch

from benchmark.harness.trace import idle_gaps

PREFIX = "imsame."
OUTSIDE = "outside the program"


def ranges(prof) -> list:
    """(phase, start, end) in seconds of the program's host-side ranges,
    from the profiler's raw events; their copies on the device's timeline
    are left out."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if not name.startswith(PREFIX) or e.device_type() == cuda:
            continue
        if hasattr(e, "start_ns"):
            a, b = e.start_ns() / 1e9, e.end_ns() / 1e9
        else:
            a = e.start_us() / 1e6
            b = a + e.duration_us() / 1e6
        out.append((name[len(PREFIX):], a, b))
    return out


def span_s(program, t0: float, t1: float, names) -> float:
    """Seconds of the ranges of these phases inside [t0, t1]."""
    names = set(names)
    return sum(max(0.0, min(b, t1) - max(a, t0))
               for n, a, b in program if n in names)


def innermost(program, t0: float, t1: float) -> list:
    """[t0, t1] cut at every range's ends: (start, end, phase) pieces,
    each under the innermost range over it (the latest-starting, then the
    shortest, that covers it), or OUTSIDE."""
    cuts = sorted({t0, t1} | {t for _, a, b in program for t in (a, b)
                              if t0 < t < t1})
    starts = sorted(program, key=lambda r: r[1])
    open_, i, pieces = [], 0, []
    for a, b in zip(cuts, cuts[1:]):
        while i < len(starts) and starts[i][1] <= a:
            name, s, e = starts[i]
            heapq.heappush(open_, (-s, e, i, name))
            i += 1
        while open_ and open_[0][1] <= a:  # ended before this piece
            heapq.heappop(open_)
        pieces.append((a, b, open_[0][3] if open_ else OUTSIDE))
    return pieces


def idle_by_span(trace, program, n=10) -> list:
    """The trace's idle seconds by the phase they fall in: each idle gap
    of its window split over the innermost range around each part of it,
    parts outside every range under OUTSIDE; the top n (all where n is
    None) as [phase, seconds]."""
    gaps = idle_gaps([(a, b) for _, a, b in trace.ops], trace.t0, trace.t1)
    pieces = innermost(program, trace.t0, trace.t1)
    per, j = {}, 0
    for ga, gb in gaps:
        while j < len(pieces) and pieces[j][1] <= ga:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < gb:
            a, b, name = pieces[k]
            part = min(b, gb) - max(a, ga)
            if part > 0:
                per[name] = per.get(name, 0.0) + part
            k += 1
    top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
    return [[name, t] for name, t in top]
