"""Packed-row ungapped extension, in plain torch.

Same semantics as the reference extension (src/alignmentFunctions.c:
276-387), reformulated so the device never gathers single bases from the
concatenated sequence arrays:

  * The extension walk never leaves the query read / db read that owns
    the hit: the reference's bound checks (array end, read end with the
    last-read asymmetry) all reduce in row coordinates to
    ``o <= read_len - 1 - offset`` (forward) and ``o <= offset - 13``
    (backward) -- see the derivation in the pipeline module docstring.
  * Both walks compare bases at a *fixed relative shift* (the hit
    diagonal), so one contiguous match-bit window per candidate covers
    forward and backward passes.
  * The walk's stop condition maps to "first index where" reductions
    over prefix-sum scores, and the ``high <= score`` watermark to the
    last processed index attaining the running max.

Layout: reads are packed 2 bits/base into 32-bit words (base b of a row
at bits 2*(b%16) of word b//16).  Device tensors hold the words as int32
(torch's uint32 lacks right shifts on the CPU): every right shift widens
to int64 or masks after shifting, and results are bit-cast back with
``to_i32``.  Per candidate the gate gathers EW+1 consecutive words per
side, funnel-shifts to base alignment, XORs to match bits, and scans the
unpacked [N, W] window.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import FIXED_K, POINT

SEED_SCORE = FIXED_K * POINT  # 48
BASES_PER_WORD = 16
_U32 = 0xFFFFFFFF


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Bit-cast int64 values in [0, 2^32) to int32 (two's complement)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned values, widened to int64."""
    return x.to(torch.int64) & _U32


def pack_read_rows(
    codes: np.ndarray, start: np.ndarray, lens: np.ndarray, row_len: int
) -> np.ndarray:
    """Pack reads into [n, row_len//16] uint32 rows (2 bits/base,
    little-endian within each word).  Bases past a read's length are 0
    (matching garbage is masked by the kernel's bounds)."""
    assert row_len % BASES_PER_WORD == 0
    n = len(start)
    wp = row_len // BASES_PER_WORD
    if n == 0:
        return np.zeros((0, wp), np.uint32)
    total = len(codes)
    idx = start.astype(np.int64)[:, None] + np.arange(row_len, dtype=np.int64)
    valid = np.arange(row_len)[None, :] < lens[:, None]
    mat = np.where(valid, codes[np.minimum(idx, max(total - 1, 0))], 0).astype(
        np.uint32
    )
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(
        mat.reshape(n, wp, BASES_PER_WORD) << shifts, axis=2
    )


def pack_stream(codes: np.ndarray) -> np.ndarray:
    """Pack a concatenated code array 2 bits/base into uint32 words (base b
    at bits 2*(b%16) of word b//16) -- the minimal host-to-device
    representation of a sample (0.25 B/base); rows_from_stream rebuilds
    per-read rows on the device.  Tail bases of the last word are zero."""
    n = len(codes)
    wp = -(-max(n, 1) // BASES_PER_WORD)
    pad = np.zeros(wp * BASES_PER_WORD, np.uint8)
    pad[:n] = codes
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(
        pad.reshape(wp, BASES_PER_WORD).astype(np.uint32) << shifts, axis=1
    )


def rows_from_stream(
    stream: torch.Tensor,  # [W_s] int32 packed concatenated codes
    start: torch.Tensor,  # [n] int32 read start offsets (base coords)
    lens: torch.Tensor,  # [n] int32 read lengths
    *,
    row_len: int,
) -> torch.Tensor:
    """Device-side pack_read_rows: funnel-shift each read's packed words
    out of the concatenated stream and mask bases past the read length.
    Returns [n, row_len//16] int32 words, bit-identical to pack_read_rows."""
    assert row_len % BASES_PER_WORD == 0
    wp = row_len // BASES_PER_WORD
    Ws = stream.shape[0]
    j = torch.arange(wp, dtype=torch.int64, device=stream.device)[None, :]
    start = start.to(torch.int64)
    wi = (start >> 4)[:, None] + j
    words = as_u32(stream)
    lo = words[wi.clamp(0, Ws - 1)]  # [n, wp]
    hi = words[(wi + 1).clamp(0, Ws - 1)]
    sh = (2 * (start & 15))[:, None]
    rows = ((lo >> sh) | (hi << (32 - sh))) & _U32
    # mask bases past the read length: word w keeps nb = len - 16w bases
    nb = (lens.to(torch.int64)[:, None] - BASES_PER_WORD * j).clamp(
        0, BASES_PER_WORD
    )
    mask = (torch.ones_like(nb) << (2 * nb)) - 1
    return to_i32(rows & mask)


class ExtendPackedResult(NamedTuple):
    raw: torch.Tensor  # [N] int32 raw scores
    passes: torch.Tensor  # [N] bool e-value gate
    t_len: torch.Tensor  # [N] int32 (diagnostics)
    idents: torch.Tensor  # [N] int32 (diagnostics)
    exact: torch.Tensor  # [N] bool: both walks terminated inside the window
    # (score died or read bound hit), so the result equals any larger-W
    # run.  Enables a cheap small-window first tier that escalates only
    # the rare candidates whose walks outrun it (pipeline gate_begin).


def _first_true(mask: torch.Tensor, o: torch.Tensor, size: int) -> torch.Tensor:
    return torch.where(mask, o, size).amin(dim=1)


def _last_true(mask: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, o, -1).amax(dim=1)


def _window_words(packed, row, ws, EW):
    """Gather EW funnel-shifted words as int64 in [0, 2^32): word j covers
    bases ws+16j .. ws+16j+15 of ``row`` (garbage outside the row; callers
    mask by bounds).  ``packed`` is the [n_rows, wp] int32 table."""
    wp = packed.shape[1]
    j = torch.arange(EW + 1, dtype=torch.int64, device=packed.device)[None, :]
    wi = (ws >> 4).to(torch.int64)[:, None] + j  # >> 4 floors negatives
    flat = row.to(torch.int64)[:, None] * wp + wi.clamp(0, wp - 1)
    W1 = as_u32(packed.reshape(-1)[flat])  # [N, EW+1]
    sh = (2 * (ws & 15)).to(torch.int64)[:, None]
    # in int64 a shift by 32 - 0 leaves no bits below 2^32: no sh == 0 case
    return ((W1[:, :-1] >> sh) | (W1[:, 1:] << (32 - sh))) & _U32


def match_windows(qp, dp, r, s, qoff, doff, W: int):
    """[N, W] match bits of each candidate's forward walk (bases qoff+o,
    doff+o) and backward walk (qoff-13-o, doff-13-o), from one aligned
    match-bit window covering both: base index b of the window = query
    base ws_q + b = db base ws_d + b."""
    N = r.shape[0]
    i32 = torch.int32
    EW = (2 * W + 32) // BASES_PER_WORD  # window words
    qw = _window_words(qp, r, qoff - (W + BASES_PER_WORD), EW)
    dw = _window_words(dp, s, doff - (W + BASES_PER_WORD), EW)
    m = ~(qw ^ dw)
    m2 = (m & (m >> 1) & 0x55555555).to(i32)  # < 2^31: int32 is exact
    bitpos = 2 * torch.arange(BASES_PER_WORD, dtype=i32, device=qp.device)
    matchall = ((m2[:, :, None] >> bitpos) & 1).to(torch.bool)
    matchall = matchall.reshape(N, EW * BASES_PER_WORD)
    return matchall[:, W + 16 : 2 * W + 16], matchall[:, 4 : W + 4].flip(1)


def walk(match, lim, seed, o, W: int):
    """One ungapped walk over [N, W] match bits (``o`` the [1, W] step
    indexes): +POINT a match, -POINT a mismatch from ``seed``, within
    ``o <= lim``.  Returns (S, stop, first_np): the running scores, the
    bases processed (up to and including the first step whose score is
    <= 0, or to the bound or W) and that first step (W if none)."""
    in_b = o <= lim[:, None]
    pm = torch.where(in_b, torch.where(match, POINT, -POINT), 0)
    S = seed + torch.cumsum(pm.to(torch.int32), dim=1, dtype=torch.int32)
    first_np = _first_true((S <= 0) & in_b, o, W)
    stop = torch.minimum((lim + 1).clamp(0, W), first_np + 1)
    return S, stop, first_np


def extend_packed(
    qp: torch.Tensor,  # [n_q, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    r: torch.Tensor,  # [N] int32 query read ids
    s: torch.Tensor,  # [N] int32 db read ids
    qoff: torch.Tensor,  # [N] int32 one past seed end, row coords
    doff: torch.Tensor,  # [N] int32 one past seed end, row coords
    qlen: torch.Tensor,  # [N] int32 query read length
    dlen: torch.Tensor,  # [N] int32 db read length
    raw_min: torch.Tensor,  # [N] int32 per-candidate gate threshold
    *,
    W: int,
) -> ExtendPackedResult:
    assert W % BASES_PER_WORD == 0
    o = torch.arange(W, dtype=torch.int32, device=qp.device)[None, :]
    NEGI = -(2**30)
    i32 = torch.int32
    fwd, bwd = match_windows(qp, dp, r, s, qoff, doff, W)

    # ---- forward pass ----
    flim = torch.minimum(dlen - 1 - doff, qlen - 1 - qoff)  # [N]
    S, stop, first_np = walk(fwd, flim, SEED_SCORE, o, W)
    processed = o < stop[:, None]

    idents_fwd = (fwd & processed).sum(dim=1, dtype=i32)
    M = torch.where(processed, S, NEGI).amax(dim=1)
    has_high = M >= SEED_SCORE
    o_best = _last_true(processed & (S == M[:, None]), o)
    end_row = torch.where(has_high, doff + o_best, doff - 1)
    high_right = M.clamp(min=SEED_SCORE)

    # ---- backward pass (running score seeded with high_right) ----
    blim = torch.minimum(doff, qoff) - (FIXED_K + 1)
    S2, stop2, first_np2 = walk(bwd, blim, high_right[:, None], o, W)
    processed2 = o < stop2[:, None]

    idents_bwd = (bwd & processed2).sum(dim=1, dtype=i32)
    M2 = torch.where(processed2, S2, NEGI).amax(dim=1)
    has_high2 = M2 >= SEED_SCORE
    o_best2 = _last_true(processed2 & (S2 == M2[:, None]), o)
    start_row = torch.where(
        has_high2, (doff - FIXED_K - 1) - o_best2, doff - FIXED_K
    )

    idents = FIXED_K + idents_fwd + idents_bwd
    t_len = (end_row - start_row).to(i32)
    raw = (2 * idents - t_len) * POINT

    # A walk is fully determined inside the window iff it stopped for a
    # real reason (read bound: lim < W, or score death: first_np < W)
    # rather than running out of window.  The backward walk seeds its
    # running score from the forward watermark, so forward exactness is
    # required for backward exactness (covered by the conjunction).
    fwd_exact = (flim < W) | (first_np < W)
    bwd_exact = (blim < W) | (first_np2 < W)

    return ExtendPackedResult(
        raw=raw,
        passes=raw >= raw_min,
        t_len=t_len,
        idents=idents,
        exact=fwd_exact & bwd_exact,
    )
