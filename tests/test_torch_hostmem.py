"""The host memory policy of a process with a resident engine
(`imsame_tpu_torch/utils/hostmem.py`): with it, a large array comes from
the heap and its memory stays there once freed; without it, glibc maps
the array on its own and unmaps it on free.

Each case runs in a fresh interpreter: a test worker's heap, after other
files, may hold a free chunk larger than SIZE, which glibc serves before
it maps anything, with the policy or without it."""

import ctypes
import ctypes.util
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from imsame_tpu_torch.utils import hostmem

SIZE = 64 << 20  # above glibc's largest mmap threshold (32 MiB)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Mallinfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


@functools.cache
def _mallinfo2():
    fn = ctypes.CDLL(ctypes.util.find_library("c")).mallinfo2
    fn.restype = _Mallinfo2
    return fn


def _mallinfo():
    # looked up once: find_library allocates and frees, and a free lets
    # glibc trim the heap's top between the readings it should compare
    return _mallinfo2()()


def _in_a_fresh_process(case: str, *args: str) -> None:
    """Run this module's function ``case`` in a new interpreter; its
    assertions fail the test."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, os.path.abspath(__file__), case,
                          *args], env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def _with_the_policy() -> None:
    assert hostmem.retain_freed_memory()
    before = _mallinfo()
    a = np.ones(SIZE, np.uint8)
    held = _mallinfo()
    assert held.hblkhd - before.hblkhd < SIZE // 2
    assert held.arena - before.arena >= SIZE // 2 or (
        before.fordblks >= SIZE)
    del a
    after = _mallinfo()
    # nothing given back to the system: the heap is as large as it was
    assert after.arena == held.arena
    b = np.ones(SIZE, np.uint8)
    assert _mallinfo().arena == held.arena  # the freed memory, reused
    del b
    assert hostmem.retain_freed_memory(False)


def _without_the_policy(first: str) -> None:
    if first != "False":  # the defaults come back after the policy was on
        assert hostmem.retain_freed_memory()
        if first == "held":  # ... and kept a freed large array's memory
            a = np.ones(SIZE, np.uint8)
            del a
        assert hostmem.retain_freed_memory(False)
    before = _mallinfo()
    a = np.ones(SIZE, np.uint8)
    assert _mallinfo().hblkhd - before.hblkhd >= SIZE
    del a
    assert _mallinfo().hblkhd == before.hblkhd


def test_with_the_policy_a_large_array_lives_and_stays_in_the_heap():
    _in_a_fresh_process("_with_the_policy")


@pytest.mark.parametrize("first", [False, True, "held"])
def test_without_the_policy_glibc_maps_a_large_array_on_its_own(first):
    _in_a_fresh_process("_without_the_policy", str(first))


if __name__ == "__main__":
    _mallinfo2()  # looked up before the case reads the heap
    globals()[sys.argv[1]](*sys.argv[2:])
