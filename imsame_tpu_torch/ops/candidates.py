"""Flat candidate gate over packed read rows.

The reference walks each query read's candidate stream sequentially --
k-mer scan positions x posting-list hits -- running the ungapped
extension + e-value gate per candidate (src/alignmentFunctions.c:118-199).
Here the host enumerates the exact candidate list to gate (it owns the
cheap stream tables: k-mer slots, bucket offsets, per-read ranks) and
ships it in one of three encodings (segment words, two words, or the wide
three-word format of queries of >= 2^20 reads); the device maps index hits
to (db read, row offset) from the engine-resident index -- one gather from
the packed index words, or three from the wide (pos, sid, db_start)
triple -- and runs the packed extension (ops/extend_packed.py), returning
a pass bit and an exactness bit per candidate, packed 32 per int32 word as
a [2, N/32] array (row 0 = pass, row 1 = exact; bit k of word w is
candidate 32w+k).

flat_gate_seg, flat_gate_packed and flat_gate dispatch through
ops/gate_cuda.py gate: CPU tensors take the plain version here
(gate_plain, any format), CUDA tensors the csrc/gate.cu kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gate_cuda
from .extend_packed import as_u32, extend_packed


def lookup_index(idx_tab, hit: torch.Tensor):
    """Index rows -> (db read id, offset of the k-mer's end in its row).

    ``idx_tab`` is either the int32 tensor of (sid << 12) | doff index
    words (the packed index format: n_db < 2^20 reads, db read length <
    4096) or the wide (idx_pos, idx_sid, db_start) int32 triple.  Rows
    are clamped into the table."""
    if isinstance(idx_tab, torch.Tensor):
        hit = hit.clamp(0, max(idx_tab.shape[0] - 1, 0))
        w = idx_tab[hit]
        s = (w >> 12) & 0xFFFFF  # arithmetic shift, then mask: sid < 2^20
        return s, w & 0xFFF
    idx_pos, idx_sid, db_start = idx_tab
    hit = hit.clamp(0, max(idx_pos.shape[0] - 1, 0))
    s = idx_sid[hit]
    return s, idx_pos[hit] - db_start[s]


def gate_core(qp, dp, qlen, dlen, idx_tab, r, hit, qoff, thr, *, window: int):
    """Candidate -> (pass bool, exact bool): the plain gate body (index
    payload as lookup_index takes it)."""
    s, doff = lookup_index(idx_tab, hit)
    res = extend_packed(
        qp, dp, r, s, qoff, doff, qlen[r], dlen[s], thr, W=window
    )
    return res.passes, res.exact


def pack_bits(passes: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """[N] bools x 2 -> [2, N/32] int32 words, bit k = candidate 32w+k."""
    N = passes.shape[0]
    bits = torch.stack([passes, exact]).reshape(2, N // 32, 32).to(torch.int32)
    # 1 << 31 wraps to -2^31; sums of distinct powers never overflow
    weights = torch.ones(32, dtype=torch.int32, device=bits.device) << (
        torch.arange(32, dtype=torch.int32, device=bits.device)
    )
    return (bits * weights).sum(dim=2, dtype=torch.int32)


def decode_candidates(cand: torch.Tensor, rtab=None, rbase=None):
    """(query read id, index row, qoff) of a chunk in any of the three
    formats, told apart by shape: [C] seg words (with ``rtab`` and
    ``rbase``; see flat_gate_seg), [2, N] two words (flat_gate_packed) or
    [3, N] three words (flat_gate)."""
    if cand.dim() == 1:
        w = as_u32(cand)
        flag = w >> 31
        qd = (w >> 25) & 0x3F
        hit = (w & 0x1FFFFFF).to(torch.int32)
        rix = (torch.cumsum(flag, dim=0) - 1).clamp(0, rtab.shape[0] - 1)
        qoff = (rbase[rix] + torch.cumsum(qd, dim=0)).to(torch.int32)
        return rtab[rix], hit, qoff
    if cand.shape[0] == 2:
        rq = as_u32(cand[1])
        return rq >> 12, cand[0], (rq & 0xFFF).to(torch.int32)
    hit, r, qoff = cand
    return r, hit, qoff


def gate_plain(qp, dp, qlen, dlen, idx_tab, cand, thr_tab, rtab=None,
               rbase=None, *, window: int) -> torch.Tensor:
    """The plain gate of a chunk in any format (decode_candidates):
    [2, N/32] pass/exact words.  The per-read threshold is gathered from
    ``thr_tab``."""
    r, hit, qoff = decode_candidates(cand, rtab, rbase)
    passes, exact = gate_core(
        qp, dp, qlen, dlen, idx_tab, r, hit, qoff, thr_tab[r], window=window
    )
    return pack_bits(passes, exact)


def flat_gate_packed(
    qp: torch.Tensor,  # [n_q, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    qlen: torch.Tensor,  # [n_q] int32
    dlen: torch.Tensor,  # [n_db] int32
    idx_tab,  # packed index words, or (idx_pos, idx_sid, db_start) triple
    cand: torch.Tensor,  # [2, N] int32: row 0 index-hit row, row 1 the
    # (query read id << 12) | qoff word (bit-cast from uint32)
    thr_tab: torch.Tensor,  # [n_q] int32 per-READ raw-score threshold
    *,
    window: int,
) -> torch.Tensor:
    """Gate N candidates given as two words each (N % 32 == 0): the read id
    and the k-mer's one-past-end offset share one uint32 (qoff <=
    MAX_READ_SIZE < 2^12; requires n_q < 2^20), and the per-read threshold
    lives in a table uploaded once per compare.  Padding entries return
    garbage bits; callers read only the bits of real candidates.  The
    kernel on CUDA tensors (ops/gate_cuda.py gate)."""
    return gate_cuda.gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab,
                          window=window)


def flat_gate_seg(
    qp: torch.Tensor,  # [n_q, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    qlen: torch.Tensor,  # [n_q] int32
    dlen: torch.Tensor,  # [n_db] int32
    idx_tab,  # packed index words, or (idx_pos, idx_sid, db_start) triple
    cand: torch.Tensor,  # [C] int32 words: new_seg<<31 | qoff_delta<<25 | hit
    rtab: torch.Tensor,  # [S] int32 query read id per segment
    rbase: torch.Tensor,  # [S] int32 qoff decode base per segment
    thr_tab: torch.Tensor,  # [n_q] int32 per-READ raw-score threshold
    *,
    window: int,
) -> torch.Tensor:
    """Segment-encoded twin of flat_gate_packed at half the per-candidate
    host-to-device bytes.

    The host exploits stream order (read-major, qoff non-decreasing
    within a read): each candidate is ONE int32 -- bit 31 a new-segment
    flag, bits 25..30 the qoff delta vs the previous candidate (0..63),
    bits 0..24 the index-hit row -- plus two per-SEGMENT words (read id,
    qoff decode base).  Segments break on read change, qoff-delta
    overflow, or chunk start, so decoding is exact:

        rix  = cumsum(flag) - 1
        r    = rtab[rix]
        qoff = rbase[rix] + cumsum(delta)

    Requires index rows < 2^25 (the host falls back to flat_gate_packed
    otherwise).  Padding candidates decode to garbage but their bits are
    ignored by the caller, like flat_gate_packed.  The kernel on CUDA
    tensors (ops/gate_cuda.py gate)."""
    return gate_cuda.gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab, rtab,
                          rbase, window=window)


def encode_seg_chunk(rids, qoffs, hits, size: int):
    """Host-side segment encoding for one chunk slice (numpy, vectorized).

    Returns (cand[size] int32, rtab[n_seg] int32, rbase[n_seg] int32)."""
    n = len(rids)
    new_seg = np.empty(n, bool)
    new_seg[0] = True
    dq = np.empty(n, np.int64)
    dq[0] = 0
    dq[1:] = qoffs[1:].astype(np.int64) - qoffs[:-1]
    new_seg[1:] = (rids[1:] != rids[:-1]) | (dq[1:] < 0) | (dq[1:] > 63)
    qd = np.where(new_seg, 0, dq)
    cs = np.cumsum(qd)
    cand = np.zeros(size, np.int32)
    cand[:n] = (
        (new_seg.astype(np.uint32) << np.uint32(31))
        | (qd.astype(np.uint32) << np.uint32(25))
        | hits.astype(np.uint32)
    ).view(np.int32)
    rtab = rids[new_seg].astype(np.int32)
    rbase = (qoffs.astype(np.int64) - cs)[new_seg].astype(np.int32)
    return cand, rtab, rbase


def flat_gate(
    qp: torch.Tensor,  # [n_q, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    qlen: torch.Tensor,  # [n_q] int32
    dlen: torch.Tensor,  # [n_db] int32
    idx_tab,  # packed index words, or (idx_pos, idx_sid, db_start) triple
    cand: torch.Tensor,  # [3, N] int32: index-hit row, query read id, qoff
    thr_tab: torch.Tensor,  # [n_q] int32 per-READ raw-score threshold
    *,
    window: int,
) -> torch.Tensor:
    """Wide candidate format, for queries of >= 2^20 reads (and the device
    enumeration's triples), whose read id no longer shares a word with the
    k-mer offset: three int32 values per candidate (N % 32 == 0).  The
    threshold is gathered from the per-read table, as the other formats
    do.  Padding entries return garbage bits; callers read only the bits
    of real candidates.  The kernel on CUDA tensors (ops/gate_cuda.py
    gate)."""
    return gate_cuda.gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab,
                          window=window)
