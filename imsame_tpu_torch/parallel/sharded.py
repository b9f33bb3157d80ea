"""Sharded engine steps over the ("data", "dict") mesh (parallel/mesh.py).

The five steps of the JAX package's parallel/sharded.py, as plain
functions over per-position tensor lists: ``mesh.put`` gives a replicated
table (every position holds it), ``mesh.put_rows`` the index payload split
by row range over "dict", ``mesh.put_cols`` a candidate chunk or pair batch
split over "data" or over both axes flattened.  Each step runs the port's
single-device op on every position's shard (the CUDA kernels on a card,
their plain versions on the CPU) and merges the outputs on the mesh's lead
device -- every output is moved there with ``.to(lead)`` before it is
summed or concatenated -- so a mesh run gives the single device's bits by
construction.

  * "data": candidate chunks and NW pair batches are sharded; packed rows,
    lengths and thresholds are replicated.
  * "dict": the index payload, the large per-base array, is sharded by
    contiguous row range (``shard_rows`` rows a shard).  The broadcast
    gate steps (gate_step, gate_step_wide) send every candidate of a data
    block to each dict shard, mask the hits a shard does not own and
    merge the disjoint bits with a sum; the routed step
    (gate_step_routed, the engine's step when n_dict > 1) takes chunks the
    host laid out so that position p = d * n_dict + k holds only
    candidates of shard k, so no mask and no merge is needed and the
    extension work scales with n_dict.

Bits pack 32 to a word per shard: a chunk's per-shard width must be a
multiple of 32, or the words differ from the single device's.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.candidates import flat_gate, flat_gate_packed, pack_bits
from ..ops.resolve import ResolveNWResult, nw_stats_rows, nw_traceback_rows

Shards = List[torch.Tensor]  # one tensor (or index triple) per position


def _check_width(n: int) -> None:
    if n % 32:
        raise ValueError(f"a shard's {n} candidates are not a multiple of 32")


def _dict_union(mesh, cand: Shards, shard_rows: int, gate) -> torch.Tensor:
    """The broadcast steps' merge: every dict shard k of data block d
    gates the block's candidates with their index rows rebased to the
    shard (``gate(p, local_rows, cand[p], owned)`` -> words of the owned
    candidates' bits); the shards' words are disjoint, so their sum on the
    lead device is the union, and the blocks concatenate in order."""
    n_data, n_dict = mesh.shape["data"], mesh.shape["dict"]
    blocks = []
    for d in range(n_data):
        words = None
        for k in range(n_dict):
            p = d * n_dict + k
            c = cand[p]
            _check_width(c.shape[1])
            local = c[0] - k * shard_rows  # the op clamps it into the shard
            own = (local >= 0) & (local < shard_rows)
            w = gate(p, local, c, own).to(mesh.lead)
            words = w if words is None else words + w
        blocks.append(words)
    return torch.cat(blocks, dim=1)


def gate_step(mesh, qp: Shards, dp: Shards, qlen: Shards, dlen: Shards,
              idx_tab, cand: Shards, thr_tab: Shards, *, window: int,
              shard_rows: int) -> torch.Tensor:
    """Sharded flat_gate_packed: ``cand`` [2, N] (index row; read id << 12
    | qoff) split over "data", the index payload over "dict", the rest
    replicated.  Returns the [2, N/32] pass/exact words on the lead
    device, bit-equal to the single device's."""

    def shard(p, local, c, own):
        return flat_gate_packed(
            qp[p], dp[p], qlen[p], dlen[p], idx_tab[p],
            torch.stack([local, c[1]]), thr_tab[p], window=window,
        ) & pack_bits(own, own)

    return _dict_union(mesh, cand, shard_rows, shard)


def gate_step_routed(mesh, qp: Shards, dp: Shards, qlen: Shards,
                     dlen: Shards, idx_tab, cand: Shards, thr_tab: Shards, *,
                     window: int, shard_rows: int) -> torch.Tensor:
    """Dict-routed gate: ``cand`` [2, N] split over the flattened ("data",
    "dict") axis, each position's block holding only candidates whose
    index row lives on its dict shard (the engine's planner lays chunks
    out so): no mask and no merge but the concatenation.  Returns [2,
    N/32] words on the lead device, in the chunk's order."""
    blocks = []
    for p in range(mesh.size):
        c = cand[p]
        _check_width(c.shape[1])
        local = c[0] - mesh.grid(p)[1] * shard_rows
        blocks.append(flat_gate_packed(
            qp[p], dp[p], qlen[p], dlen[p], idx_tab[p],
            torch.stack([local, c[1]]), thr_tab[p], window=window,
        ).to(mesh.lead))
    return torch.cat(blocks, dim=1)


def gate_step_wide(mesh, qp: Shards, dp: Shards, qlen: Shards, dlen: Shards,
                   idx_tab, cand: Shards, thr_tab: Shards, *, window: int,
                   shard_rows: int) -> torch.Tensor:
    """Sharded flat_gate for queries of >= 2^20 reads: ``cand`` [4, N]
    (index row, read id, qoff, valid) split over "data", the index payload
    over "dict" with a masked sum, like gate_step; padding candidates
    (valid 0) give zero bits."""

    def shard(p, local, c, own):
        own = own & (c[3] != 0)
        return flat_gate(
            qp[p], dp[p], qlen[p], dlen[p], idx_tab[p],
            torch.stack([local, c[1], c[2]]), thr_tab[p], window=window,
        ) & pack_bits(own, own)

    return _dict_union(mesh, cand, shard_rows, shard)


def nw_stats_step(mesh, qp: Shards, dp: Shards, rs: Shards, qlen: Shards,
                  dlen: Shards, igap: int, egap: int, *,
                  max_len: int) -> torch.Tensor:
    """Sharded nw_stats_rows: the [2, B] pair batch split over the
    flattened ("data", "dict") axis, rows replicated.  Returns the stacked
    [3, B] (length, identities, ylen) on the lead device."""
    return torch.cat([
        nw_stats_rows(qp[p], dp[p], rs[p], qlen[p], dlen[p], igap, egap,
                      max_len=max_len).to(mesh.lead)
        for p in range(mesh.size)
    ], dim=1)


def nw_render_step(mesh, qp: Shards, dp: Shards, rs: Shards, qlen: Shards,
                   dlen: Shards, igap: int, egap: int, *,
                   max_len: int) -> ResolveNWResult:
    """Sharded nw_traceback_rows for the render: the [2, B] pair batch
    split over the flattened axis.  Returns the ResolveNWResult of the
    whole batch on the lead device."""
    parts = [
        nw_traceback_rows(qp[p], dp[p], rs[p][0], rs[p][1], qlen[p], dlen[p],
                          igap, egap, max_len=max_len)
        for p in range(mesh.size)
    ]
    return ResolveNWResult(*(
        torch.cat([getattr(r, f).to(mesh.lead) for r in parts], dim=0)
        for f in ResolveNWResult._fields
    ))
