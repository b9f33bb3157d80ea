"""The port's extension gate (imsame_tpu_torch.ops.extend_packed,
ops.candidates) against the JAX package's, on the same seeded inputs:
device row packing, the packed extension, and both candidate encodings of
the flat gate, at the gate's two windows (64 and 256).  Integer results,
so the tolerance is exact equality -- the pass bit and the exactness bit
included."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsame_tpu.constants import FIXED_K
from imsame_tpu.index.kmer import build_index, pack_kmers
from imsame_tpu.io.fasta import parse_fasta_bytes
from imsame_tpu.ops import candidates as jcand
from imsame_tpu.ops import extend_packed as jext
from imsame_tpu.ops.extend import raw_score_threshold
from imsame_tpu_torch.ops import candidates as tcand
from imsame_tpu_torch.ops import extend_packed as text
from util_synth import mutate, random_read


def _t(a):
    """numpy -> torch, with uint32 words bit-cast to int32."""
    a = np.asarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _eq(got, want, what=""):
    got = np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("row_len", [128, 256])
def test_rows_from_stream_matches_jax(row_len):
    rng = np.random.default_rng(row_len)
    lens = rng.integers(1, row_len + 1, 37).astype(np.int64)
    start = np.concatenate(([0], np.cumsum(lens)[:-1]))
    codes = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    # zero-length rows, and reads starting on every word offset
    start_p = np.concatenate([start, [0, 5]]).astype(np.int32)
    lens_p = np.concatenate([lens, [0, 0]]).astype(np.int32)
    stream = jext.pack_stream(codes)
    want = jext.rows_from_stream(
        jnp.asarray(stream), jnp.asarray(start_p), jnp.asarray(lens_p),
        row_len=row_len,
    )
    got = text.rows_from_stream(
        _t(stream), _t(start_p), _t(lens_p), row_len=row_len
    )
    _eq(got, want)
    _eq(text.pack_read_rows(codes, start, lens, row_len),
        jext.pack_read_rows(codes, start, lens, row_len))


def _real_candidates(seed, W):
    """Real k-mer hits between variable-length reads (mutated copies and
    random reads), in packed-row coordinates."""
    rng = random.Random(seed)
    q = [random_read(rng, rng.randint(40, W - 10)) for _ in range(24)]
    db = [mutate(rng, r, 0.08, 0.05) for r in q[:12]]
    db += [random_read(rng, rng.randint(40, W - 10)) for _ in range(12)]
    qi = parse_fasta_bytes("".join(f">q{i}\n{r}\n" for i, r in enumerate(q)).encode())
    di = parse_fasta_bytes("".join(f">d{i}\n{r}\n" for i, r in enumerate(db)).encode())
    idx = build_index(di)
    cands = []
    for r in range(qi.n_seqs):
        s, e = int(qi.start[r]), qi.read_end(r)
        for p in range(s, e - FIXED_K + 1):
            key = int(pack_kmers(qi.codes, np.array([p], dtype=np.int64))[0])
            lo, hi = idx.lookup_range(key)
            for h in range(lo, hi):
                sid = int(idx.sid[h])
                cands.append((r, sid, p + FIXED_K - s,
                              int(idx.pos[h]) - int(di.start[sid])))
    c = np.array(cands, np.int64)
    qlens, dlens = qi.read_lens(), di.read_lens()
    thr = raw_score_threshold(qlens, di.total_len, 1e-20)
    qp = jext.pack_read_rows(qi.codes, qi.start, qlens, W)
    dp = jext.pack_read_rows(di.codes, di.start, dlens, W)
    r, s = c[:, 0], c[:, 1]
    args = [qp, dp, r, s, c[:, 2], c[:, 3], qlens[r], dlens[s], thr[r]]
    return [a if a.dtype == np.uint32 else a.astype(np.int32) for a in args]


@pytest.mark.parametrize("W", [64, 256])
def test_extend_packed_matches_jax(W):
    args = _real_candidates(W, 256)
    want = jext.extend_packed(*[jnp.asarray(a) for a in args], W=W)
    got = text.extend_packed(*[_t(a) for a in args], W=W)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    # both tiers and both verdicts occur
    assert np.asarray(got.passes).any() and not np.asarray(got.passes).all()
    if W == 64:
        assert not np.asarray(got.exact).all()


def _gate_inputs(seed):
    """Random rows and index words with a stream-ordered candidate list
    (read-major, qoff non-decreasing per read, deltas that overflow the
    6-bit field to force extra segments), padded to a multiple of 32."""
    rng = np.random.default_rng(seed)
    n_q, n_db, L = 64, 64, 256
    qp = rng.integers(0, 2**32, (n_q, L // 16), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (n_db, L // 16), dtype=np.uint32)
    dp[:16] = qp[:16]  # identical rows: long walks that pass
    qlen = rng.integers(100, 250, n_q).astype(np.int32)
    dlen = rng.integers(100, 250, n_db).astype(np.int32)
    dlen[:16] = qlen[:16]
    n_idx = 500
    sid = rng.integers(0, n_db, n_idx).astype(np.uint32)
    doff = rng.integers(12, 200, n_idx).astype(np.uint32)
    idx_tab = ((sid << np.uint32(12)) | doff).view(np.int32)
    thr = rng.integers(-50, 200, n_q).astype(np.int32)
    N, size = 300, 320
    rids = np.sort(rng.integers(0, n_q, N)).astype(np.int32)
    qoffs = np.empty(N, np.int32)
    for r in np.unique(rids):
        m = rids == r
        qoffs[m] = np.sort(rng.integers(12, 250, int(m.sum()))).astype(np.int32)
    hits = rng.integers(0, n_idx, N).astype(np.int32)
    # a diagonal hit on an identical row pair for every read < 16
    same = np.flatnonzero(rids < 16)
    hits[same[::2]] = 0
    idx_tab[0] = (int(rids[same[0]]) << 12) | int(qoffs[same[0]])
    tables = [qp, dp, qlen, dlen, idx_tab]
    cand = np.zeros((2, size), np.int32)
    cand[0, :N] = hits
    cand[1, :N] = ((rids.astype(np.uint32) << np.uint32(12))
                   | qoffs.astype(np.uint32)).view(np.int32)
    return tables, thr, cand, (rids, qoffs, hits, size), N


@pytest.mark.parametrize("window", [64, 256])
def test_flat_gate_packed_matches_jax(window):
    tables, thr, cand, _, N = _gate_inputs(7)
    want = jcand.flat_gate_packed(
        *[jnp.asarray(a) for a in tables], jnp.asarray(cand), jnp.asarray(thr),
        window=window, packed_idx=True,
    )
    got = tcand.flat_gate_packed(
        *[_t(a) for a in tables], _t(cand), _t(thr), window=window
    )
    _eq(got, want)
    assert _bits(got, N)[0].any() and _bits(got, N)[1].any()


@pytest.mark.parametrize("window", [64, 256])
def test_flat_gate_seg_matches_jax(window):
    tables, thr, _, seg_args, N = _gate_inputs(8)
    c1, rtab, rbase = tcand.encode_seg_chunk(*seg_args)
    jc1, jrtab, jrbase = jcand.encode_seg_chunk(*seg_args)
    _eq(c1, jc1)
    _eq(rtab, jrtab)
    _eq(rbase, jrbase)
    # one flagged candidate per segment; segments break on read change
    # and also on qoff-delta overflow
    assert (c1 < 0).sum() == len(rtab) > len(np.unique(seg_args[0]))
    want = jcand.flat_gate_seg(
        *[jnp.asarray(a) for a in tables], jnp.asarray(c1), jnp.asarray(rtab),
        jnp.asarray(rbase), jnp.asarray(thr), window=window, packed_idx=True,
    )
    got = tcand.flat_gate_seg(
        *[_t(a) for a in tables], _t(c1), _t(rtab), _t(rbase), _t(thr),
        window=window,
    )
    _eq(got, want)


def _bits(words, n):
    pb = np.ascontiguousarray(np.asarray(words), dtype="<i4")
    return np.unpackbits(
        pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
    )[:, :n]
