"""Gapped-alignment resolve steps: row gather -> NW (-> traceback).

The host ships only the pair index vectors (query read, db read); the
device gathers the 2-bit-packed read rows already resident on it, unpacks
them to code matrices and runs the kernels of ops/nw_cuda.py (the plain
torch versions of ops/nw.py and ops/traceback.py on a CPU device).  Per
alignment the host-to-device traffic is 8 bytes instead of 2*L.

Where the JAX engine (imsame_tpu/ops/resolve.py) picks one of several
Pallas layouts by batch divisibility and length bucket, each call here
runs one kernel on any batch padded to the kernels' 4-pair tile, at every
bucket of Config.length_buckets (128 .. 3072).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .extend_packed import BASES_PER_WORD
from .nw_cuda import TILE, nw_forward, nw_stats, traceback


def unpack_rows(packed: torch.Tensor, idx: torch.Tensor, L: int) -> torch.Tensor:
    """Gather int32 packed rows by index and unpack to [B, L] uint8 codes."""
    wp = L // BASES_PER_WORD
    rows = packed[idx][:, :wp]  # [B, wp]
    shifts = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int32, device=packed.device)
    # arithmetic >> on int32, then & 3 keeps exactly the base's 2 bits
    codes = (rows[:, :, None] >> shifts) & 3
    return codes.reshape(idx.shape[0], L).to(torch.uint8)


def _pad_to_tile(v: torch.Tensor) -> torch.Tensor:
    """Pad a pair index vector with read 0 up to the kernels' batch tile
    (the padded pairs' results are sliced off)."""
    return F.pad(v, (0, -v.shape[0] % TILE))


class ResolveNWResult(NamedTuple):
    length: torch.Tensor  # [B] int32
    identities: torch.Tensor  # [B] int32
    ylen: torch.Tensor  # [B] int32
    n_steps: torch.Tensor  # [B] int32
    chain: torch.Tensor  # [B, 2L] int32


def _gather(qp, dp, r, s, qlen, dlen, L):
    return (
        unpack_rows(dp, s, L), unpack_rows(qp, r, L),
        dlen[s].contiguous(), qlen[r].contiguous(),
    )


def nw_traceback_rows(
    qp: torch.Tensor,  # [n_q, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    r: torch.Tensor,  # [B] query read ids
    s: torch.Tensor,  # [B] db read ids
    qlen: torch.Tensor,  # [n_q] int32
    dlen: torch.Tensor,  # [n_db] int32
    igap: int,
    egap: int,
    *,
    max_len: int,
) -> ResolveNWResult:
    """Render resolve: the backpointer kernel (function F) and the
    traceback kernel on the per-pair bp layout; returns per-pair path
    stats plus the traceback chain.  On the card that is two launches and
    the row gather, with nothing read back to the host.  The traceback
    kernel replaces the jitted traceback_batch of
    imsame_tpu/ops/traceback.py; the nw_forward kernel replaces
    nw_forward_batch_pallas_pipe5 (batches that are multiples of 256:
    the 128-512 buckets' ladders, 1024's 256) and
    nw_forward_batch_pallas (the other batches: 64/8 pairs at 2048, 24/8
    at 3072 under the default render budget)."""
    B = r.shape[0]
    X, Y, xl, yl = _gather(qp, dp, _pad_to_tile(r), _pad_to_tile(s), qlen, dlen, max_len)
    res = nw_forward(X, Y, xl, yl, igap, egap, max_len=max_len)
    tb = traceback(res.bp, res.best_i, res.best_j, max_len=max_len)
    return ResolveNWResult(
        length=tb.length[:B],
        identities=tb.identities[:B],
        ylen=yl[:B],
        n_steps=tb.n_steps[:B],
        chain=tb.chain[:B],
    )


def nw_stats_rows(
    qp: torch.Tensor,  # [n_q, WP] int32 packed query rows
    dp: torch.Tensor,  # [n_db, WP] int32 packed db rows
    rs: torch.Tensor,  # [2, B]: row 0 query read ids, row 1 db read ids
    qlen: torch.Tensor,  # [n_q] int32
    dlen: torch.Tensor,  # [n_db] int32
    igap: int,
    egap: int,
    *,
    max_len: int,
) -> torch.Tensor:
    """Accept-gate resolve: gather packed rows, run the stats-only aligner
    (function S: no backpointer tensor), and return exactly what the
    accept gate needs (reference accept: src/alignmentFunctions.c:163) as
    one stacked [3, B] int32 array (length, identities, ylen).  The
    traceback chain for *accepted* pairs is produced later by
    nw_traceback_rows at render time.  The nw_stats kernel replaces
    nw_stats_batch_pallas_pipe4 (batches that are multiples of 2048 at
    256 and 512, of 1024 at 1024) and nw_stats_batch_pallas_pipe3 (the other
    multiples of 256, every bucket), and the fallbacks for smaller
    batches, nw_stats_batch_pallas_pipe and nw_stats_batch_pallas."""
    B = rs.shape[1]
    X, Y, xl, yl = _gather(
        qp, dp, _pad_to_tile(rs[0]), _pad_to_tile(rs[1]), qlen, dlen, max_len
    )
    res = nw_stats(X, Y, xl, yl, igap, egap, max_len=max_len)
    return torch.stack([res.length, res.identities, yl])[:, :B]
