"""Device-side candidate enumeration for the extension gate.

The host candidate path (pipeline.build_flat + ops/candidates.py) expands
every read's candidate stream on the host and uploads it, one to three
int32 words per candidate.  This module rebuilds the reference worker's
candidate stream (src/alignmentFunctions.c:91-186: k-mer scan positions in
order x bucket hits newest-first) on the device from data already there:

  * the packed 2-bit query rows (uploaded once per compare),
  * the index bucket prefix table ``bucket_start`` (4^12 + 1 int32 words,
    uploaded once per engine),
  * per-read scalars (lengths, boundary flags, rank windows): O(n_reads)
    words per stage instead of O(candidates).

Layout: an [R, S] slot grid, S = row_len - K + 2 slot columns per read.
Slot j of read r is the j-th k-mer of the read's scan stream, including
the reference's boundary-base quirk (SURVEY.md 6.5): a read whose stream
inherits the previous read's trailing base (hasb[r] = 1) has slot 0 =
that base + its own first K-1 bases, and slot j covers row offsets
[j - hasb, j - hasb + K - 1].  hasb comes from the host (it owns the
n_threads split semantics), one word per read.

Candidate rank windows [frm[r], to[r]) select per-read slices of the
stream in stream order; a chunk call materializes C consecutive selected
candidates (one inverse-prefix search) and gates them as three-word
candidates (ops/candidates.py flat_gate: the csrc/gate.cu kernel on the
card): the same verdict bits as the host path.

Packed words are int32 on the device: the key build widens them to int64
values in [0, 2^32) (extend_packed.as_u32), where every right shift is
logical, in blocks of rows that bound those temporaries.  The tables and
the rank prefix are int32, as in the JAX engine; the engine takes the
host gate when a compare's candidate total would overflow them.
"""

from __future__ import annotations

import torch

from ..constants import FIXED_K
from .candidates import flat_gate
from .extend_packed import as_u32

_U32 = 0xFFFFFFFF
# Slots of one row block of build_enum_tables: bounds each of its int64
# temporaries to this many elements.
BUILD_BLOCK_SLOTS = 1 << 24


def _rev2_groups(w: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each word (int64 values in
    [0, 2^32))."""
    w = ((w & 0x33333333) << 2) | ((w >> 2) & 0x33333333)
    w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return ((w << 16) | (w >> 16)) & _U32


def build_enum_tables(
    qp: torch.Tensor,  # [R, WP] int32 packed query rows
    bs: torch.Tensor,  # [4^K + 1] int32 bucket prefix table
    hasb: torch.Tensor,  # [R] int32 1 iff the read inherits a boundary base
    n_kmers: torch.Tensor,  # [R] int32 slots per read
    qlen: torch.Tensor,  # [R] int32 read lengths
    *,
    row_len: int,
):
    """Per-compare slot tables: (lo, cnt, Rcum, tot), int32.

    lo[r, j]   first index row of slot j's bucket
    cnt[r, j]  bucket size (0 outside the read's slot range)
    Rcum[r, j] exclusive per-read prefix of cnt (candidate rank base)
    tot[r]     candidate count of read r (N_r of the host stream)
    """
    R, WP = qp.shape
    S = row_len - FIXED_K + 2
    dev = qp.device
    i64 = torch.int64
    lo = torch.empty((R, S), dtype=torch.int32, device=dev)
    cnt = torch.empty_like(lo)
    # 16-base windows at every row offset t in [0, S-2] (slot offsets)
    t = torch.arange(S - 1, dtype=i64, device=dev)
    wi = t >> 4
    wi1 = (wi + 1).clamp(max=WP - 1)
    sh = 2 * (t & 15)
    col = torch.arange(S, dtype=torch.int32, device=dev)
    rb = max(1, BUILD_BLOCK_SLOTS // S)
    for a in range(0, R, rb):
        b = min(R, a + rb)
        words = as_u32(qp[a:b])
        # in int64 a shift by 32 - 0 leaves no bits below 2^32
        w16 = ((words[:, wi] >> sh) | (words[:, wi1] << (32 - sh))) & _U32
        # big-endian 12-mer key starting at offset t (reference rolling-key
        # convention: first base in the high bits, src/IMSAME.c:236-239)
        key_at = (_rev2_groups(w16) >> 8) & 0xFFFFFF
        # boundary slot key: previous read's last base + own first 11 bases
        prev = (torch.arange(a, b, dtype=i64, device=dev) - 1).clamp(min=0)
        pl_off = (qlen[prev].to(i64) - 1).clamp(min=0)
        pword = as_u32(qp[prev, pl_off >> 4])
        prev_last = (pword >> (2 * (pl_off & 15))) & 3
        key_m1 = (prev_last << 22) | (key_at[:, 0] >> 2)
        zero = torch.zeros((b - a, 1), dtype=i64, device=dev)
        keys = torch.where(
            (hasb[a:b] == 1)[:, None],
            torch.cat([key_m1[:, None], key_at], dim=1),
            torch.cat([key_at, zero], dim=1),
        )
        valid = col[None, :] < n_kmers[a:b, None]
        keys = torch.where(valid, keys, 0)
        blo = bs[keys]
        lo[a:b] = blo
        cnt[a:b] = torch.where(valid, bs[keys + 1] - blo, 0)
    ccum = torch.cumsum(cnt, dim=1, dtype=torch.int32)
    tot = ccum[:, -1].clone()
    return lo, cnt, ccum.sub_(cnt), tot


def enum_select_prefix(
    cnt: torch.Tensor,  # [R, S] int32
    Rcum: torch.Tensor,  # [R, S] int32
    frm: torch.Tensor,  # [R] int32 first selected rank per read
    to: torch.Tensor,  # [R] int32 one past the last selected rank
):
    """Inclusive prefix of the per-slot selected-candidate counts, and the
    flattened per-slot selection start offsets.  One call per stage; the
    chunk calls below search it."""
    lo_r = torch.maximum(frm[:, None], Rcum)
    hi_r = torch.minimum(to[:, None], Rcum + cnt)
    sel = (hi_r - lo_r).clamp_(min=0)
    start_off = lo_r.sub_(Rcum)  # valid where sel > 0
    scum = torch.cumsum(sel.reshape(-1), dim=0, dtype=torch.int32)
    return scum, start_off.reshape(-1)


def enum_candidates(lo_g, scum, start_off, hasb, o_base: int, *, chunk: int,
                    row_len: int):
    """Candidate triples (rid, hit, qoff), int32 [chunk] each, of selected
    ranks [o_base, o_base + chunk) of a stage: the addressing of
    enum_gate_chunk (entries past the stage total are garbage)."""
    S = row_len - FIXED_K + 2
    RS = lo_g.shape[0] * S
    o = o_base + torch.arange(chunk, dtype=torch.int64, device=scum.device)
    o = o.clamp_(max=2**31 - 1).to(torch.int32)
    p = torch.searchsorted(scum, o, right=True, out_int32=True).clamp_(max=RS - 1)
    r = p // S
    j = p - r * S
    sel_before = torch.where(p > 0, scum[(p - 1).clamp(min=0)], 0)
    hit = lo_g.reshape(-1)[p] + start_off[p] + (o - sel_before)
    qoff = j - hasb[r] + FIXED_K
    return r, hit, qoff


def enum_gate_chunk(
    qp: torch.Tensor,  # [R, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    qlen: torch.Tensor,  # [R] int32
    dlen: torch.Tensor,  # [n_db] int32
    idx_tab: torch.Tensor,  # packed index words
    thr_tab: torch.Tensor,  # [R] int32 per-read raw-score thresholds
    lo_g: torch.Tensor,  # [R, S] from build_enum_tables
    scum: torch.Tensor,  # [R*S] from enum_select_prefix
    start_off: torch.Tensor,  # [R*S]
    hasb: torch.Tensor,  # [R]
    o_base: int,  # selected rank of this chunk's first candidate
    *,
    chunk: int,
    window: int,
    row_len: int,
) -> torch.Tensor:
    """Gate selected candidates [o_base, o_base + chunk) of the current
    stage (chunk % 32 == 0); returns the pass/exact bits as [2, chunk / 32]
    int32 words, the contract of flat_gate_packed (entries past the stage
    total are garbage)."""
    r, hit, qoff = enum_candidates(lo_g, scum, start_off, hasb, o_base,
                                   chunk=chunk, row_len=row_len)
    return flat_gate(qp, dp, qlen, dlen, idx_tab, torch.stack([hit, r, qoff]),
                     thr_tab, window=window)
