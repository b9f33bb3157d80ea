"""Batched traceback over the wavefront backpointers, in plain torch.

Follows the reference backtracker's control flow
(src/alignmentFunctions.c:493-560) vectorized across pairs with a masked
loop: from the best cell, repeatedly read the stored (xfrom, yfrom),
classify the move (diagonal / gap-in-X / gap-in-Y by the reference's
``(dx > dy)`` rule), and accumulate:

  length      diag: +1, gap run: +run length
  identities  diag moves whose characters match -- provably equal to the
              reference's render-time '*' count (gap-run positions always
              pair a base with '-', head padding pairs '-' with spaces)
  igaps/egaps gap-open / gap-extend counts as the reference tallies them

The chain of visited cells is also recorded so the host can reconstruct the
two right-aligned report buffers for accepted pairs without re-running the
DP (io/reconstruct.py).  Diagonal runs are jumped whole, so a chain has
tens to hundreds of steps.  Each loop step tests on the host whether any
pair is still walking (one device sync per step), so this is the CPU path
and the test oracle: on the card, ops/nw_cuda.py traceback runs the
csrc/traceback.cu kernel, one launch a batch with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .nw import BP_MASK, PACK

# Chain entries for diagonal-run jumps carry this flag bit (coords use
# 24 bits; bit 26 is free); io/reconstruct.py expands them char-by-char.
RUN_FLAG = 1 << 26


class TracebackResult(NamedTuple):
    length: torch.Tensor  # [B] int32
    identities: torch.Tensor  # [B] int32
    igaps: torch.Tensor  # [B] int32
    egaps: torch.Tensor  # [B] int32
    chain: torch.Tensor  # [B, 2L] int32 packed px*4096+py, chain[0]=best cell
    n_steps: torch.Tensor  # [B] int32 number of valid entries in chain


def traceback_batch(
    bp: torch.Tensor,  # [B, 2L-1, L] int32 from nw_forward_batch / nw_forward
    best_i: torch.Tensor,  # [B] int32
    best_j: torch.Tensor,  # [B] int32
    *,
    max_len: int,
) -> TracebackResult:
    B, ND, L = bp.shape
    assert L == max_len
    CH = 2 * L
    i32 = torch.int32
    bp_flat = bp.reshape(B, ND * L)

    px = best_i.to(i32)
    py = best_j.to(i32)
    chain = torch.full((B, CH), -1, dtype=i32, device=bp.device)
    chain[:, 0] = px * PACK + py
    length = torch.zeros(B, dtype=i32, device=bp.device)
    ident = torch.zeros_like(length)
    igaps = torch.zeros_like(length)
    egaps = torch.zeros_like(length)

    t = 0
    while t < CH - 1:
        active = (px > 0) & (py > 0)
        if not bool(active.any()):
            break
        flat_idx = ((px + py) * L + px).clamp(0, ND * L - 1)
        word = torch.gather(bp_flat, 1, flat_idx[:, None].to(torch.int64))[:, 0]
        # decode the packed bp word (ops/nw.py layout): low 24 bits are
        # the from-cell, bits 24-27 the diagonal-run length ending here,
        # bits 28-31 the matches within that run.
        frm = word & BP_MASK
        run = (word >> 24) & 15
        mrun = (word >> 28) & 15
        gx = frm // PACK
        gy = frm - gx * PACK
        is_run = run > 0  # every chosen diagonal move carries run >= 1
        fx = torch.where(is_run, px - run, gx)
        fy = torch.where(is_run, py - run, gy)

        dx = px - fx
        dy = py - fy
        is_gapx = (~is_run) & (dx > dy)

        add_len = torch.where(is_run, run, torch.where(is_gapx, dx, dy))
        add_id = torch.where(is_run, mrun, 0)
        add_ig = torch.where(is_run, 0, 1).to(i32)
        add_eg = torch.where(is_run, 0, torch.where(is_gapx, dx - 1, dy - 1))

        length = torch.where(active, length + add_len, length)
        ident = torch.where(active, ident + add_id, ident)
        igaps = torch.where(active, igaps + add_ig, igaps)
        egaps = torch.where(active, egaps + add_eg, egaps)

        entry = torch.where(
            is_run, (fx * PACK + fy) | RUN_FLAG, fx * PACK + fy
        )
        chain[:, t + 1] = torch.where(active, entry, chain[:, t + 1])
        px = torch.where(active, fx, px)
        py = torch.where(active, fy, py)
        t += 1

    # n_steps = number of moves actually recorded per pair
    n_steps = (chain != -1).sum(dim=1, dtype=i32) - 1
    return TracebackResult(length, ident, igaps, egaps, chain, n_steps)
