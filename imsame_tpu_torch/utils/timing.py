"""Wall-clock phase timing + throughput counters.

The reference reports CPU time via clock() (src/IMSAME.c:101,470); we report
wall time per phase plus derived throughput (reads/s, GCUPS).  A phase
spans host work and the device work it waits for: the engine reads device
results back with ``.cpu()``, which synchronizes, so device time lands in
the phase that fetches it.

While a torch profiler records, each phase is also a
``record_function("imsame.<name>")`` range: the profiler stamps it on
the clock of the device events, and phases nest as the with-blocks do on
the one host thread."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch


class PhaseTimer:
    """Per-name sums of phase seconds and of integer counters, over the
    life of the engine that owns it."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        # whether phases open profiler ranges; set by trace() at the start
        # of each public call (entering record_function costs ~13 us even
        # with no profiler recording)
        self.tracing = False

    def trace(self) -> None:
        """Open profiler ranges from now on if a profiler is recording."""
        self.tracing = torch.autograd._profiler_enabled()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        rng = None
        if self.tracing:
            rng = torch.profiler.record_function("imsame." + name)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)

    def count(self, name: str, n: int) -> None:
        self._counts[name] += int(n)

    def items(self) -> Iterator[Tuple[str, float]]:
        return iter(dict(self._acc).items())

    def counts(self) -> Iterator[Tuple[str, int]]:
        return iter(dict(self._counts).items())


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / max(seconds, 1e-12) / 1e9
