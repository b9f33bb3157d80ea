"""The port's native index build (native/host.c imsame_index_build, a
two-level partitioned counting sort) against the numpy path of
``index.kmer.build_index`` (``native.load`` patched to None), which
defines the index: ``bucket_start`` and the packed words in the packable
mode, ``pos`` and ``sid`` in the wide mode, byte for byte.  Cases: an
empty db, fewer bases than k, one read, window resets mid-read, a db
where one k-mer repeats across every thread's range (newest-first order
across the seams) built with 1, 2, 3, 7 and 32 threads, inputs just
below and just above the window ends that take a second thread, and k
other than 12.  The counter ``index_built_entries`` counts the entries
of an index the engine builds, and nothing for an index passed in."""

import functools
import re

import numpy as np
import pytest

from imsame_tpu_torch import native
from imsame_tpu_torch.config import Config
from imsame_tpu_torch.index import kmer
from imsame_tpu_torch.io.fasta import SeqInfo
from imsame_tpu_torch.pipeline import TorchEngine


def _min_entries_per_thread() -> int:
    with open(native.SRC) as f:
        m = re.search(r"#define IDX_MIN_ENTRIES_PER_THREAD (.+)", f.read())
    return int(eval(m.group(1), {"__builtins__": {}}))


MIN_PER_THREAD = _min_entries_per_thread()


@pytest.fixture(autouse=True)
def _needs_the_library():
    if native.load() is None:
        pytest.skip("no C compiler: the native index build cannot be built")


def _db(lens, seed, resets=0.0, poly_a=0.0):
    """A SeqInfo of random reads of the given lengths; ``resets`` of the
    bases restart the k-mer window mid-read, and ``poly_a`` of the reads
    are all A (one k-mer, repeated)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    codes = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    for r in np.flatnonzero(rng.random(len(lens)) < poly_a):
        codes[start[r]:start[r] + lens[r]] = 0
    fresh = rng.random(len(codes)) < resets
    fresh[start[lens > 0]] = True
    return SeqInfo(codes, start, fresh, [b""] * len(lens))


@functools.cache
def _db_and_numpy_index(lens, seed, resets, poly_a, k):
    """The db and the numpy path's (bucket_start, pos, sid) over it; the
    seams cases share one."""
    db = _db(lens, seed, resets, poly_a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "load", lambda: None)
        idx = kmer.build_index(db, k)
    assert idx.packed is None
    # the numpy path's table spans 4^FIXED_K keys; a k-mer's keys lie
    # below 4^k
    return db, (idx.bucket_start[:4**k + 1], idx.pos, idx.sid)


def _native(db, k, packable, n_threads):
    """imsame_index_build called directly with ``n_threads``:
    (bucket_start, packed words or None, pos or None, sid or None)."""
    lib = native.load()
    n = db.total_len
    bucket_start = np.empty(4**k + 1, np.int32)
    cap = max(n, 1)
    packed = np.empty(cap, np.uint32)
    pos = np.empty(cap, np.int32)
    sid = np.empty(cap, np.int32)
    total = lib.imsame_index_build(
        np.ascontiguousarray(db.codes, np.uint8),
        np.ascontiguousarray(db.fresh, np.uint8),
        np.ascontiguousarray(db.start, np.int64), db.n_seqs, n, k, 4**k,
        n_threads, bucket_start, packed, int(packable), pos, sid)
    assert total == bucket_start[-1]
    if packable:
        return bucket_start, packed[:total], None, None
    return bucket_start, None, pos[:total], sid[:total]


def _reads_of(total):
    """Read lengths of 250 bp summing to ``total`` bases."""
    return (250,) * (total // 250) + (total % 250,)


# A db where one k-mer repeats in every thread's range: 30 % of the
# reads all A, 0.5 % resets, 32 threads' worth of window ends.
SEAMS = _reads_of(32 * MIN_PER_THREAD + 1000)
# Window ends one short of a second thread's, and exactly a second's.
SECOND = 2 * MIN_PER_THREAD
# name: (read lengths, seed, resets, poly_a, k, n_threads)
CASES = {
    "empty db": ((), 1, 0.0, 0.0, 12, 8),
    "a read of no bases": ((0,), 1, 0.0, 0.0, 12, 8),
    "fewer bases than k": ((7,), 2, 0.0, 0.0, 12, 8),
    "one read": ((300,), 3, 0.0, 0.0, 12, 8),
    "window resets mid-read": ((150,) * 180 + (5, 11, 12, 13) * 5, 4, 0.01,
                               0.0, 12, 8),
    **{f"one k-mer over the seams, {t} threads":
       (SEAMS, 5, 0.005, 0.3, 12, t) for t in (1, 2, 3, 7, 32)},
    "just below a second thread": (_reads_of(SECOND - 1), 6, 0.002, 0.05,
                                   12, 32),
    "just at a second thread": (_reads_of(SECOND), 6, 0.002, 0.05, 12, 32),
    "k = 5": ((150,) * 300, 7, 0.01, 0.05, 5, 8),
    "k = 8": ((150,) * 300 + (3, 8, 9), 8, 0.01, 0.05, 8, 8),
}
# the threads imsame_index_build takes in the cases that set them
THREADS = {
    **{f"one k-mer over the seams, {t} threads": t for t in (1, 2, 3, 7, 32)},
    "just below a second thread": 1,
    "just at a second thread": 2,
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_build_equals_the_numpy_path(case):
    lens, seed, resets, poly_a, k, n_threads = CASES[case]
    db, (bs_ref, pos_ref, sid_ref) = _db_and_numpy_index(
        lens, seed, resets, poly_a, k)
    if case in THREADS:
        # one thread an IDX_MIN_ENTRIES_PER_THREAD window ends, at most
        # the threads asked for
        assert min(n_threads, max(1, db.total_len // MIN_PER_THREAD)) == (
            THREADS[case])
    doff = pos_ref.astype(np.int64) - db.start[sid_ref]
    packed_ref = ((sid_ref.astype(np.uint32) << np.uint32(12))
                  | doff.astype(np.uint32))

    bs, packed, _, _ = _native(db, k, True, n_threads)
    assert bs.tobytes() == bs_ref.tobytes()
    assert packed.tobytes() == packed_ref.tobytes()
    bs, _, pos, sid = _native(db, k, False, n_threads)
    assert bs.tobytes() == bs_ref.tobytes()
    assert pos.tobytes() == pos_ref.astype(np.int32).tobytes()
    assert sid.tobytes() == sid_ref.astype(np.int32).tobytes()

    if k == kmer.FIXED_K:
        # build_index's native path, in the mode the db takes
        idx = kmer.build_index(db, k)
        assert idx.bucket_start.tobytes() == bs_ref.tobytes()
        assert idx.pos.tobytes() == pos_ref.astype(np.int32).tobytes()
        assert idx.sid.tobytes() == sid_ref.astype(np.int32).tobytes()


def test_index_built_entries_counts_the_engines_builds():
    db = _db((150,) * 40, 9)
    built = TorchEngine(db, Config(), device="cpu")
    counts = dict(built.timer.counts())
    assert counts["index_built_entries"] == built.index.n_entries > 0
    passed = TorchEngine(db, Config(), index=kmer.build_index(db),
                         device="cpu")
    assert dict(passed.timer.counts()).get("index_built_entries", 0) == 0
