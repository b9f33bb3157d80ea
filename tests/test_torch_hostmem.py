"""The host memory policy of a process with a resident engine
(`imsame_tpu_torch/utils/hostmem.py`): with it, a large array comes from
the heap and its memory stays there once freed; without it, glibc maps
the array on its own and unmaps it on free."""

import ctypes
import ctypes.util

import numpy as np
import pytest

from imsame_tpu_torch.utils import hostmem

SIZE = 64 << 20  # above glibc's largest mmap threshold (32 MiB)


class _Mallinfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def _mallinfo():
    fn = ctypes.CDLL(ctypes.util.find_library("c")).mallinfo2
    fn.restype = _Mallinfo2
    return fn()


@pytest.fixture
def retained():
    assert hostmem.retain_freed_memory()
    yield
    assert hostmem.retain_freed_memory(False)


def test_with_the_policy_a_large_array_lives_and_stays_in_the_heap(retained):
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


@pytest.mark.parametrize("first", [False, True])
def test_without_the_policy_glibc_maps_a_large_array_on_its_own(first):
    if first:  # the defaults come back after the policy was on
        assert hostmem.retain_freed_memory()
        assert hostmem.retain_freed_memory(False)
    before = _mallinfo()
    a = np.ones(SIZE, np.uint8)
    assert _mallinfo().hblkhd - before.hblkhd >= SIZE
    del a
    assert _mallinfo().hblkhd == before.hblkhd
