"""Batched anti-diagonal wavefront formulation of the reference aligner, in
plain torch: the CPU path and the oracle of the hand-written CUDA kernels
(ops/nw_cuda.py).

The reference computes the DP row-major with two running trackers: a row
maximum ``mf`` and per-column maxima ``mc`` used for "long gap" moves
(src/alignmentFunctions.c:389-489).  All four score reads of cell (i, j)
live on anti-diagonals d-2 and d-3 (d = i+j):

    T[i-1][j-1]  diag d-2   (diagonal move)
    T[i][j-2]    diag d-2   (mf compare quirk, SURVEY.md 6.3)
    T[i-1][j-2]  diag d-3   (mf assign quirk)
    T[i-2][j-1]  diag d-3   (mc update, SURVEY.md 6.4)

and the mf/mc trackers advance exactly once per (row, diagonal) /
(column, diagonal), so the whole recurrence -- quirks included -- maps onto
a wavefront with carried state vectors.

Everything is kept in *row-aligned diagonal coordinates*: for the cells of
diagonal d, index i is the row and the column is j = d - i.  Then:

  * score diagonals are row-indexed; the four reads above are static
    shift-by-one/two of those vectors;
  * the per-row ``mf`` state is row-indexed: elementwise updates;
  * the per-column ``mc`` state is stored *aligned*: slot i holds the state
    of column d-1-i, exactly the column cell (i, d-i) consults for its
    "up-gap" move.  Advancing d moves every column's slot down by one, so
    the whole tracker is a static shift per step, with the freshly
    initialized column (from this diagonal's row-0 cell) entering at slot 0;
  * the query chars along the diagonal shift the same way.

Backpointers are stored in diagonal layout: bp[b, d, i] = packed word for
cell (i, d-i), -1 outside; the traceback reads bp[b, px+py, px].

Tie-breaking parity: the reference picks the best cell by scanning the last
row/column in row-major order with ``>=`` (src/alignmentFunctions.c:481-484),
i.e. the lexicographic max of (score, i, j); reproduced with a packed
(score, i) reduction per diagonal plus (score, i) comparison across
diagonals (same i on a later diagonal implies larger j).

All arithmetic is int32, as in the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..constants import POINT

NEG = -(2**28)  # "minus infinity" safe against int32 overflow
PACK = 4096  # coordinate packing base; MAX_READ_SIZE=3000 < 4096

# Backpointer word layout (int32): bits 0-23 = xfrom*PACK+yfrom (< 2^24
# since coords < 3072), bits 24-27 = length of the diagonal-move run
# ending at this cell (capped at RUN_CAP, 0 for gap moves), bits 28-31 =
# matches within that run (words go negative at >= 8 matches).  The run
# fields let the traceback jump whole diagonal runs per iteration while
# staying bit-equivalent.  -1 stays the no-cell sentinel: its low 24 bits
# decode to coords >= 3072, unreachable.
RUN_CAP = 15
BP_MASK = 0x00FFFFFF
_NO_BEST = -(2**31) + 1


class NWResult(NamedTuple):
    bp: torch.Tensor  # [B, 2L-1, L] int32 packed words (see layout above)
    best_score: torch.Tensor  # [B] int32
    best_i: torch.Tensor  # [B] int32
    best_j: torch.Tensor  # [B] int32


class NWStatsResult(NamedTuple):
    """Forward-only result: the accept-gate stats of the best path, with no
    backpointer tensor (see nw_stats_batch)."""

    best_score: torch.Tensor  # [B] int32
    best_i: torch.Tensor  # [B] int32
    best_j: torch.Tensor  # [B] int32
    length: torch.Tensor  # [B] int32 alignment length of the best path
    identities: torch.Tensor  # [B] int32 matches on the best path


def _shift1(a: torch.Tensor, fill: int = NEG) -> torch.Tensor:
    """a'[:, i] = a[:, i-1]; a'[:, 0] = fill."""
    return F.pad(a[:, :-1], (1, 0), value=fill)


def _best_fold(elig, s0, i_idx, d, bs, bi, bj):
    """Fold diagonal d's eligible cells into the running best (lex-max of
    (score, i, j)); returns (take, di, bs, bi, bj)."""
    packed = torch.where(elig, s0 * 8192 + i_idx, _NO_BEST)
    dbest = packed.amax(dim=1)
    ds = torch.div(dbest, 8192, rounding_mode="floor")
    di = dbest - ds * 8192
    take = elig.any(dim=1) & ((ds > bs) | ((ds == bs) & (di >= bi)))
    bs = torch.where(take, ds, bs)
    bi = torch.where(take, di, bi)
    bj = torch.where(take, d - di, bj)
    return take, di, bs, bi, bj


def nw_forward_batch(
    X: torch.Tensor,  # [B, L] uint8 codes, padded
    Y: torch.Tensor,  # [B, L] uint8 codes, padded
    xlen: torch.Tensor,  # [B] int32 actual db-read lengths (>= 2)
    ylen: torch.Tensor,  # [B] int32 actual query-read lengths (>= 2)
    igap: int,  # negative
    egap: int,  # negative
    *,
    max_len: int,
) -> NWResult:
    """Forward DP with a backpointer word per cell."""
    B, L = X.shape
    assert L == max_len
    ND = 2 * L - 1
    dev = X.device
    i32 = torch.int32
    i_idx = torch.arange(L, dtype=i32, device=dev)[None, :]
    xlenc = xlen.to(i32)[:, None]
    ylenc = ylen.to(i32)[:, None]
    Xc = X.to(i32)
    Yc = Y.to(i32)

    def full(v):
        return torch.full((B, L), v, dtype=i32, device=dev)

    s1, s2, s3 = full(NEG), full(NEG), full(NEG)
    rn1, rn2, mr1, mr2 = full(0), full(0), full(0), full(0)
    mf_s, mf_x, mf_y = full(NEG), full(0), full(0)
    mc_s, mc_x = full(NEG), full(0)
    yd = full(0)
    bs = torch.full((B,), _NO_BEST, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bj = torch.zeros(B, dtype=i32, device=dev)
    bp = torch.full((B, ND, L), -1, dtype=i32, device=dev)

    for d in range(ND):
        j_idx = d - i_idx  # [1, L] column per row on this diagonal

        # Query chars along the diagonal: yd[:, i] == Y[:, d-i] (the
        # column index clamps at L-1, like a dynamic slice; such chars
        # only reach invalid cells).
        yd = torch.cat([Yc[:, min(d, L - 1), None], yd[:, :-1]], dim=1)

        valid = (j_idx >= 0) & (i_idx < xlenc) & (j_idx < ylenc)
        inner = valid & (i_idx >= 1) & (j_idx >= 1)
        eq = Xc == yd
        s_pm = torch.where(eq, POINT, -POINT).to(i32)

        t_im1_jm1 = _shift1(s2)
        t_i_jm2 = s2
        t_im1_jm2 = _shift1(s3)
        t_im2_jm1 = _shift1(t_im1_jm2)

        # --- mf update (before the cell), rows with j > 1 ---
        mf_upd = valid & (i_idx >= 1) & (j_idx >= 2) & (mf_s <= t_i_jm2)
        mf_s = torch.where(mf_upd, t_im1_jm2, mf_s)
        mf_x = torch.where(mf_upd, i_idx - 1, mf_x)
        mf_y = torch.where(mf_upd, j_idx - 2, mf_y)

        # --- cell scores ---
        score_diag = t_im1_jm1 + s_pm
        score_left = torch.where(
            j_idx >= 2, mf_s + igap + (j_idx - (mf_y + 1)) * egap + s_pm, NEG
        )
        # mc state for column j-1 sits at aligned slot i.
        score_right = torch.where(
            i_idx >= 2, mc_s + igap + (i_idx - (mc_x + 1)) * egap + s_pm, NEG
        )
        pick_diag = (score_diag >= score_left) & (score_diag >= score_right)
        pick_right = (~pick_diag) & (score_right > score_left)
        cell = torch.where(
            pick_diag, score_diag,
            torch.where(pick_right, score_right, score_left),
        )
        xfrom = torch.where(
            pick_diag, i_idx - 1, torch.where(pick_right, mc_x, mf_x)
        )
        yfrom = torch.where(
            pick_diag | pick_right, j_idx - 1, mf_y
        )

        # Diagonal-run tracking for the jumping traceback: cell (i-1,j-1)
        # lives on diagonal d-2 at row i-1.
        match_i = eq.to(i32)
        run_prev = _shift1(rn2, 0)
        mr_prev = _shift1(mr2, 0)
        is_diag = pick_diag & inner
        capped = run_prev == RUN_CAP
        run_cur = torch.where(
            is_diag, torch.where(capped, 1, run_prev + 1), 0
        ).to(i32)
        mr_cur = torch.where(
            is_diag, torch.where(capped, match_i, mr_prev + match_i), 0
        ).to(i32)

        # Border cells (i==0 or j==0) score +/-POINT with no gap moves.
        border = valid & ((i_idx == 0) | (j_idx == 0))
        cell = torch.where(border, s_pm, cell)
        s0 = torch.where(valid, cell, NEG).to(i32)

        # --- mc update (after the cell), strict >, from two rows up ---
        mc_upd = inner & (i_idx >= 2) & (j_idx >= 2) & (t_im2_jm1 > mc_s)
        mc_s = torch.where(mc_upd, t_im2_jm1, mc_s)
        mc_x = torch.where(mc_upd, i_idx - 2, mc_x)

        # --- mf re-init from this diagonal's column-0 cell (d, 0) ---
        if d < L:
            col0_ok = xlenc > d  # [B, 1]
            col0_score = torch.where(
                Xc[:, d, None] == Yc[:, :1], POINT, -POINT
            ).to(i32)
            upd_col = (i_idx == d) & col0_ok
            mf_s = torch.where(upd_col, col0_score, mf_s)
            mf_x = torch.where(upd_col, d, mf_x)
            mf_y = torch.where(upd_col, 0, mf_y)

        # --- advance mc to diagonal d+1: shift down, push column d ---
        row0_ok = (ylenc > d) if d < L else torch.zeros_like(ylenc, dtype=torch.bool)
        new_col_s = torch.where(row0_ok, s0[:, :1], NEG).to(i32)
        mc_s = torch.cat([new_col_s, mc_s[:, :-1]], dim=1)
        mc_x = _shift1(mc_x, 0)

        # --- best cell on last row/column, reference tie-break ---
        elig = inner & ((i_idx == xlenc - 1) | (j_idx == ylenc - 1))
        _, _, bs, bi, bj = _best_fold(elig, s0, i_idx, d, bs, bi, bj)

        # --- backpointers for this diagonal (packed with run fields) ---
        bp[:, d, :] = torch.where(
            inner,
            (xfrom * PACK + yfrom) | (run_cur << 24) | (mr_cur << 28),
            -1,
        )

        # Rotate score diagonals: next (d-1, d-2, d-3) = (d, d-1, d-2).
        s1, s2, s3 = s0, s1, s2
        rn1, rn2 = run_cur, rn1
        mr1, mr2 = mr_cur, mr1

    return NWResult(bp=bp, best_score=bs, best_i=bi, best_j=bj)


def nw_stats_batch(
    X: torch.Tensor,  # [B, L] uint8 codes, padded
    Y: torch.Tensor,  # [B, L] uint8 codes, padded
    xlen: torch.Tensor,  # [B] int32 actual db-read lengths (>= 2)
    ylen: torch.Tensor,  # [B] int32 actual query-read lengths (>= 2)
    igap: int,  # negative
    egap: int,  # negative
    *,
    max_len: int,
) -> NWStatsResult:
    """Forward-only aligner: same recurrence and tie-breaks as
    nw_forward_batch, but instead of materializing the [B, 2L-1, L]
    backpointer tensor it *propagates the accept-gate statistics of the
    best path through the DP itself*.

    Each cell carries (length, identities) of the path the traceback would
    reconstruct from it; the per-move contributions mirror
    ops/traceback.py exactly (which itself mirrors the reference
    backtracker, src/alignmentFunctions.c:493-560):

      border cell (i==0 or j==0)   len = 0, id = 0 (the traceback stops
                                   there without reading its move)
      diagonal from (i-1, j-1)     len+1, id+match(i,j)
      gap from (fx, fy)            len += max-side run (dx if dx>dy else
                                   dy), id += 0

    The mf/mc gap trackers therefore carry the (len, id) of their tracked
    cell next to its score: mf assigns from T[i-1][j-2] (diag d-3), mc
    from T[i-2][j-1] (diag d-3), and both re-initialize from border cells
    (len = id = 0).  Both stats ride ONE int32 word w = len + (id << 16):
    every update is an add or a select, and len < 2*MAX_READ_SIZE < 2^16
    never carries into the id half.
    """
    B, L = X.shape
    assert L == max_len
    ND = 2 * L - 1
    dev = X.device
    i32 = torch.int32
    i_idx = torch.arange(L, dtype=i32, device=dev)[None, :]
    xlenc = xlen.to(i32)[:, None]
    ylenc = ylen.to(i32)[:, None]
    Xc = X.to(i32)
    Yc = Y.to(i32)

    def full(v):
        return torch.full((B, L), v, dtype=i32, device=dev)

    s1, s2, s3 = full(NEG), full(NEG), full(NEG)
    w1, w2, w3 = full(0), full(0), full(0)
    mf_s, mf_x, mf_y, mf_w = full(NEG), full(0), full(0), full(0)
    mc_s, mc_x, mc_w = full(NEG), full(0), full(0)
    yd = full(0)
    bs = torch.full((B,), _NO_BEST, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bj = torch.zeros(B, dtype=i32, device=dev)
    bw = torch.zeros(B, dtype=i32, device=dev)

    for d in range(ND):
        j_idx = d - i_idx

        yd = torch.cat([Yc[:, min(d, L - 1), None], yd[:, :-1]], dim=1)

        valid = (j_idx >= 0) & (i_idx < xlenc) & (j_idx < ylenc)
        inner = valid & (i_idx >= 1) & (j_idx >= 1)
        eq = Xc == yd
        s_pm = torch.where(eq, POINT, -POINT).to(i32)
        # diag-move stat increment: len +1, id +match
        diag_add = torch.where(eq, (1 << 16) + 1, 1).to(i32)

        t_im1_jm1 = _shift1(s2)
        t_i_jm2 = s2
        t_im1_jm2 = _shift1(s3)
        t_im2_jm1 = _shift1(t_im1_jm2)
        # packed path stats of the same from-cells
        w_im1_jm1 = _shift1(w2, 0)
        w_im1_jm2 = _shift1(w3, 0)
        w_im2_jm1 = _shift1(w_im1_jm2, 0)

        # --- mf update (before the cell), rows with j > 1 ---
        mf_upd = valid & (i_idx >= 1) & (j_idx >= 2) & (mf_s <= t_i_jm2)
        mf_s = torch.where(mf_upd, t_im1_jm2, mf_s)
        mf_x = torch.where(mf_upd, i_idx - 1, mf_x)
        mf_y = torch.where(mf_upd, j_idx - 2, mf_y)
        mf_w = torch.where(mf_upd, w_im1_jm2, mf_w)

        # --- cell scores (identical decision logic to nw_forward_batch) ---
        score_diag = t_im1_jm1 + s_pm
        score_left = torch.where(
            j_idx >= 2, mf_s + igap + (j_idx - (mf_y + 1)) * egap + s_pm, NEG
        )
        score_right = torch.where(
            i_idx >= 2, mc_s + igap + (i_idx - (mc_x + 1)) * egap + s_pm, NEG
        )
        pick_diag = (score_diag >= score_left) & (score_diag >= score_right)
        pick_right = (~pick_diag) & (score_right > score_left)
        cell = torch.where(
            pick_diag, score_diag,
            torch.where(pick_right, score_right, score_left),
        )

        # --- path stats of this cell ---
        # gap-move length adds: the traceback's where(dx > dy, dx, dy).
        add_left = torch.maximum(i_idx - mf_x, j_idx - mf_y)
        add_right = (i_idx - mc_x).clamp(min=1)
        w_new = torch.where(
            pick_diag,
            w_im1_jm1 + diag_add,
            torch.where(pick_right, mc_w + add_right, mf_w + add_left),
        )

        border = valid & ((i_idx == 0) | (j_idx == 0))
        cell = torch.where(border, s_pm, cell)
        s0 = torch.where(valid, cell, NEG).to(i32)
        w0 = torch.where(inner, w_new, 0).to(i32)

        # --- mc update (after the cell), strict >, from two rows up ---
        mc_upd = inner & (i_idx >= 2) & (j_idx >= 2) & (t_im2_jm1 > mc_s)
        mc_s = torch.where(mc_upd, t_im2_jm1, mc_s)
        mc_x = torch.where(mc_upd, i_idx - 2, mc_x)
        mc_w = torch.where(mc_upd, w_im2_jm1, mc_w)

        # --- mf re-init from this diagonal's column-0 cell (d, 0) ---
        if d < L:
            col0_ok = xlenc > d
            col0_score = torch.where(
                Xc[:, d, None] == Yc[:, :1], POINT, -POINT
            ).to(i32)
            upd_col = (i_idx == d) & col0_ok
            mf_s = torch.where(upd_col, col0_score, mf_s)
            mf_x = torch.where(upd_col, d, mf_x)
            mf_y = torch.where(upd_col, 0, mf_y)
            mf_w = torch.where(upd_col, 0, mf_w)  # border cell: stats 0

        # --- advance mc to diagonal d+1: shift down, push column d ---
        row0_ok = (ylenc > d) if d < L else torch.zeros_like(ylenc, dtype=torch.bool)
        new_col_s = torch.where(row0_ok, s0[:, :1], NEG).to(i32)
        mc_s = torch.cat([new_col_s, mc_s[:, :-1]], dim=1)
        mc_x = _shift1(mc_x, 0)
        mc_w = _shift1(mc_w, 0)  # border: 0

        # --- best cell on last row/column, reference tie-break ---
        elig = inner & ((i_idx == xlenc - 1) | (j_idx == ylenc - 1))
        take, di, bs, bi, bj = _best_fold(elig, s0, i_idx, d, bs, bi, bj)
        w_at = torch.where(i_idx == di[:, None], w0, 0).sum(dim=1, dtype=i32)
        bw = torch.where(take, w_at, bw)

        s1, s2, s3 = s0, s1, s2
        w1, w2, w3 = w0, w1, w2

    return NWStatsResult(
        best_score=bs, best_i=bi, best_j=bj,
        length=bw & 0xFFFF, identities=bw >> 16,
    )
