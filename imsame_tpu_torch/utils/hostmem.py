"""Host memory policy of a process that keeps an engine resident.

glibc serves every allocation above its mmap threshold (32 MiB at most)
from a mapping of its own and unmaps it on free.  A compare allocates
its k-mer stream tables, candidate arrays and render buffers afresh, so
a process that runs many compares against one resident engine maps,
faults in and zeroes the same gigabytes again in every compare.  Under a
sandboxed kernel the mappings and faults are system time that grows and
varies with the machine's load (on an H100 host, 1.2-1.5 s of a ~6 s
compare and render of 100k reads against a 1M-read db, 0.4-0.5 s with
freed memory kept).  `retain_freed_memory` keeps freed arrays in the
heap, where the next compare reuses them.  It is process-wide: call it
once, from the process that owns the engine."""

from __future__ import annotations

import ctypes
import ctypes.util

# mallopt parameters (malloc.h)
M_TRIM_THRESHOLD = -1
M_MMAP_MAX = -4
# glibc's defaults for them
DEFAULT_MMAP_MAX = 65536
DEFAULT_TRIM_THRESHOLD = 128 * 1024


def _libc_fn(name: str, argtypes: tuple):
    """The C library's function ``name``, declared; None where there is
    none."""
    lib = ctypes.util.find_library("c")
    fn = None if lib is None else getattr(ctypes.CDLL(lib), name, None)
    if fn is not None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def retain_freed_memory(on: bool = True) -> bool:
    """With ``on``, serve every allocation from the heap and never give
    the heap's freed top back to the system; with ``on`` False, restore
    glibc's default values (its sliding mmap threshold stays off) and
    give back the free heap the policy kept (``malloc_trim(0)``), so
    that a large array is mapped on its own again.  Returns False where
    the C library has no ``mallopt`` (not glibc), and then changes
    nothing."""
    mallopt = _libc_fn("mallopt", (ctypes.c_int, ctypes.c_int))
    if mallopt is None:
        return False
    if on:
        return bool(mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
                    and mallopt(M_MMAP_MAX, 0))
    restored = bool(mallopt(M_MMAP_MAX, DEFAULT_MMAP_MAX)
                    and mallopt(M_TRIM_THRESHOLD, DEFAULT_TRIM_THRESHOLD))
    _libc_fn("malloc_trim", (ctypes.c_size_t,))(0)
    return restored
