"""ctypes loader for the native host runtime.

The C source is this package's own ``native/host.c`` (a copy of the JAX
package's host runtime, kept here so that the port reads no file of that
package), compiled with the system gcc into the repository's ``build/``
directory, keyed by the source's hash, so an edited source rebuilds.

Nothing is built at import: the library is compiled and loaded on the
first read of ``lib`` (or a call to ``load``).  If no compiler is
available ``lib`` is ``None`` and callers take their numpy paths, which
are bit-identical.  ``build`` raises instead, for callers that need the
native path (chip_smoke.py).

Plain C symbols + ctypes keep the build a single gcc invocation with no
Python build-time dependencies.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "host.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")

i8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
u32 = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def build() -> str:
    """Compile host.c unless a library for its current hash exists;
    returns the library's path.  Raises OSError or
    subprocess.SubprocessError when the build fails."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libhost_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            [
                "gcc", "-O3", "-shared", "-fPIC", "-fvisibility=hidden",
                SRC, "-o", tmp, "-lpthread",
            ],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)  # atomic: concurrent processes race safely
    return so


_LOAD_LOCK = threading.Lock()


def load():
    """The loaded library with typed symbols, or None without a compiler.
    Built and loaded once per process: threads that ask together wait for
    one build."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load():
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None

    lib.imsame_index_build.restype = ctypes.c_int64
    lib.imsame_index_build.argtypes = [
        i8, i8, i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, i32, u32, ctypes.c_int32, i32, i32,
    ]

    lib.imsame_parse_fasta.restype = ctypes.c_int64
    lib.imsame_parse_fasta.argtypes = [
        i8, ctypes.c_int64, i8, i8, i8, i64, i64,
        ctypes.POINTER(ctypes.c_int64),
    ]

    lib.imsame_kmer_stream.restype = None
    lib.imsame_kmer_stream.argtypes = [
        i8, i64, i64, ctypes.c_int64, ctypes.c_int32, i32, i64, i32, i32, i64,
        ctypes.c_int32,
    ]

    lib.imsame_build_flat.restype = ctypes.c_int64
    lib.imsame_build_flat.argtypes = [
        i64, i64, i64, ctypes.c_int64, i64, i64, i64, i32, i32, i64, i64,
        ctypes.c_int32, i32, i32, i32,
    ]

    lib.imsame_seg_encode.restype = ctypes.c_int64
    lib.imsame_seg_encode.argtypes = [
        i32, i32, i32, ctypes.c_int64, ctypes.c_int64, i32, i32, i32,
    ]

    lib.imsame_render_report.restype = ctypes.c_int64
    lib.imsame_render_report.argtypes = [
        i8, i8, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32, i64,
        ctypes.c_int64, i64, i8, i32, ctypes.c_int32,
    ]
    return lib


def __getattr__(name):
    # ``native.lib`` loads on first read, not at import
    if name == "lib":
        return load()
    raise AttributeError(name)


def build_index_arrays(codes, fresh, start, k: int, packable: bool):
    """Parallel index build (host.c imsame_index_build: a partitioned
    counting sort over pthreads: one thread per IDX_MIN_ENTRIES_PER_THREAD
    window ends, up to the cores).  Returns (bucket_start, packed, pos,
    sid) sorted by (key asc, pos desc), or None if the native lib is
    unavailable or its temporaries cannot be allocated.  In the packable
    regime (n_seqs < 2^20 and read lengths < 4096) only the (sid << 12 |
    doff) device-payload words are written and pos/sid come back None
    (KmerIndex derives them lazily); otherwise packed is None and pos/sid
    are filled."""
    lib = load()
    if lib is None:
        return None
    n = len(codes)
    nb = 4**k
    bucket_start = np.empty(nb + 1, np.int32)
    codes = np.ascontiguousarray(codes, np.uint8)
    fresh_u8 = np.ascontiguousarray(fresh, np.uint8)
    start = np.ascontiguousarray(start, np.int64)
    cap = max(n, 1)
    dummy_u32 = np.empty(1, np.uint32)
    dummy_i32 = np.empty(1, np.int32)
    if packable:
        packed = np.empty(cap, np.uint32)
        pos = sid = None
        args = (packed, 1, dummy_i32, dummy_i32)
    else:
        packed = None
        pos = np.empty(cap, np.int32)
        sid = np.empty(cap, np.int32)
        args = (dummy_u32, 0, pos, sid)
    total = lib.imsame_index_build(
        codes, fresh_u8, start, len(start), n, k, nb,
        os.cpu_count() or 1, bucket_start, *args,
    )
    if total < 0:  # allocation failure in C; numpy fallback
        return None
    t = int(total)
    if packable:
        return bucket_start, packed[:t], None, None
    return bucket_start, None, pos[:t], sid[:t]


def parse_fasta_arrays(data: bytes, lut):
    """Single-pass FASTA ingest.  Returns (codes, fresh, start, hdr_se,
    n_reads) with start[r] == -1 for base-less reads (caller back-fills),
    or None if the native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    raw = np.frombuffer(data, np.uint8)
    n = len(raw)
    cap_reads = max(data.count(b">"), 1)  # upper bound: every '>' byte
    codes = np.empty(max(n, 1), np.uint8)
    fresh = np.empty(max(n, 1), np.uint8)
    start = np.empty(cap_reads, np.int64)
    hdr_se = np.empty(2 * cap_reads, np.int64)
    n_reads = ctypes.c_int64(0)
    m = lib.imsame_parse_fasta(
        raw, n, np.ascontiguousarray(lut, np.uint8),
        codes, fresh, start, hdr_se, ctypes.byref(n_reads),
    )
    nr = int(n_reads.value)
    return codes[:m], fresh[:m], start[:nr], hdr_se[: 2 * nr], nr


def kmer_stream_arrays(codes, qlo, n_kmers, k: int, bucket_start):
    """Fused per-slot stream tables.  Returns (kp, lo, cnt, Ccum) or None."""
    lib = load()
    if lib is None:
        return None
    total = int(n_kmers.sum())
    kp = np.empty(total, np.int64)
    lo = np.empty(total, np.int32)
    cnt = np.empty(total, np.int32)
    Ccum = np.empty(total + 1, np.int64)
    lib.imsame_kmer_stream(
        np.ascontiguousarray(codes, np.uint8),
        np.ascontiguousarray(qlo, np.int64),
        np.ascontiguousarray(n_kmers, np.int64),
        len(qlo), k,
        bucket_start, kp, lo, cnt, Ccum,
        os.cpu_count() or 1,
    )
    return kp, lo, cnt, Ccum


# Bytes a record's header may take: "(q, db) : id% cov% ylen\n $$$$$$$ \n"
# with two int64 and one int32 in decimal.
RECORD_HEADER_CAP = 80


def render_report(
    xcodes, ycodes, qread, dbread, xoff, yoff, xlen, ylen, length,
    identities, rec_ylen, n_steps, chains, chain_off,
):
    """The whole report of P accepted pairs in one native pass
    (host.c imsame_render_report): record p's header from (qread,
    dbread, identities, length, rec_ylen)[p], then its blocks, rebuilt
    from chains[chain_off[p]:chain_off[p + 1]] (n_steps[p] + 1 entries
    used) over the 2-bit codes xcodes[xoff[p]:][:xlen[p]] (db) and
    ycodes[yoff[p]:][:ylen[p]] (query).  Threads: one below 4,096
    records, above that one per 2,048 records, up to the cores.  Returns
    (report, emitted): the report as a uint8 array and the identity
    count each record's render emitted; None without the library or for
    records the renderer refuses (a zero length or query length, a
    chain shorter than its steps)."""
    lib = load()
    if lib is None:
        return None
    P = len(qread)
    if len(chain_off) != P + 1 or (P and (
            chain_off[-1] > len(chains)
            or (np.asarray(xoff) + xlen).max() > len(xcodes)
            or (np.asarray(yoff) + ylen).max() > len(ycodes))):
        raise ValueError("render_report: records past their arrays")
    span = 2 * np.maximum(xlen, ylen).astype(np.int64)
    out_off = np.zeros(P + 1, np.int64)
    np.cumsum(RECORD_HEADER_CAP + 3 * span + 3 * (span // 60 + 2) + 8,
              out=out_off[1:])
    out = np.empty(max(int(out_off[-1]), 1), np.uint8)
    emitted = np.empty(P, np.int32)
    n = lib.imsame_render_report(
        np.ascontiguousarray(xcodes, np.uint8),
        np.ascontiguousarray(ycodes, np.uint8),
        *(np.ascontiguousarray(a, np.int64) for a in (qread, dbread, xoff,
                                                      yoff)),
        *(np.ascontiguousarray(a, np.int32) for a in (
            xlen, ylen, length, identities, rec_ylen, n_steps, chains)),
        np.ascontiguousarray(chain_off, np.int64),
        P, out_off, out, emitted,
        os.cpu_count() or 1,
    )
    if n < 0:
        return None
    return out[:n], emitted


def build_flat_arrays(
    read_ids, from_rank, to_rank, K_off, C_off, kp, lo, cnt, Ccum, q_start,
    k: int, out_size: int,
):
    """Flat candidate expansion.  Returns (rids, hits, qoffs) or None."""
    lib = load()
    if lib is None:
        return None
    rids = np.empty(out_size, np.int32)
    hits = np.empty(out_size, np.int32)
    qoffs = np.empty(out_size, np.int32)
    n = lib.imsame_build_flat(
        np.ascontiguousarray(read_ids, np.int64),
        np.ascontiguousarray(from_rank, np.int64),
        np.ascontiguousarray(to_rank, np.int64),
        len(read_ids),
        K_off, C_off, kp, lo, cnt, Ccum,
        np.ascontiguousarray(q_start, np.int64), k,
        rids, hits, qoffs,
    )
    assert n == out_size, (n, out_size)
    return rids, hits, qoffs


def seg_encode(rids, qoffs, hits, size: int, seg_cap: int):
    """Native single-pass segment encoding (host.c imsame_seg_encode);
    returns (cand[size], rtab[seg_cap], rbase[seg_cap], n_seg) int32
    arrays or None when unavailable / segment overflow (callers fall
    back)."""
    lib = load()
    if lib is None:
        return None
    n = len(rids)
    cand = np.zeros(size, np.int32)
    rtab = np.zeros(seg_cap, np.int32)
    rbase = np.zeros(seg_cap, np.int32)
    nseg = lib.imsame_seg_encode(
        np.ascontiguousarray(rids, np.int32),
        np.ascontiguousarray(qoffs, np.int32),
        np.ascontiguousarray(hits, np.int32),
        n, seg_cap, cand, rtab, rbase,
    )
    if nseg < 0:
        return None
    return cand, rtab, rbase, int(nseg)
