"""Wall-clock phase timing + throughput counters.

The reference reports CPU time via clock() (src/IMSAME.c:101,470); we report
wall time per phase plus derived throughput (reads/s, GCUPS).  A phase
spans host work and the device work it waits for: the engine reads device
results back with ``.cpu()``, which synchronizes, so device time lands in
the phase that fetches it."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple


class PhaseTimer:
    def __init__(self) -> None:
        self._acc: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0

    def accumulate(self, name: str, seconds: float) -> None:
        """Add an externally measured interval to a phase (for sub-spans
        that cannot be expressed as a with-block, e.g. dispatch/fetch
        halves of an overlapped stage)."""
        self._acc[name] += seconds

    def items(self) -> Iterator[Tuple[str, float]]:
        return iter(dict(self._acc).items())


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / max(seconds, 1e-12) / 1e9
