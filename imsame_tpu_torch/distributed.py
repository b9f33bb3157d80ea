"""Multi-process runtime for the sweep (the counterpart of the JAX
package's distributed module).

The reference scales across samples with sequential shell invocations and
within a sample with pthreads (src/IMSAME.c:430-462); here:

  * process bootstrap: ``init_distributed()`` joins this process to a
    ``torch.distributed`` process group on the gloo backend (coordinator
    address + process count + process id, from arguments or the
    IMSAME_COORDINATOR / IMSAME_NUM_PROCESSES / IMSAME_PROCESS_ID
    environment).  With one process it does nothing, so single-process
    runs take the same code path.  gloo, not NCCL: the only collective is
    a host integer tally, and NCCL refuses two ranks on one card.  The
    group's timeout bounds the rendezvous (a dead peer fails the run
    instead of hanging it) and the tally's wait for the slowest peer.
  * work split: the sweep stripes its sample pairs across processes by
    process id (orchestrator.AllVsAllRunner host_id / n_hosts).
  * query sharding: each process may instead take its own contiguous
    stripe of one sample's query reads (``shard_query_for_host``, offset
    back to global read ids by ``read_offset_for_host``); a stripe's
    boundary behaves exactly like the reference's thread boundary (its
    first read does not receive the previous read's trailing k-mer base,
    the stream quirk Config.n_threads emulates,
    src/alignmentFunctions.c:93-105).
  * stat merging: ``allreduce_sum`` adds per-process accepted counts
    across the group (identity with one process).

Launcher (N processes, one per host, or N local processes on one card):

    IMSAME_COORDINATOR=host0:8476 IMSAME_NUM_PROCESSES=N \\
    IMSAME_PROCESS_ID=$i python -m imsame_tpu_torch.orchestrator ... --distributed
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch

from .io.fasta import SeqInfo

# Default bound on the rendezvous and on the tally's wait for peers.
DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class DistContext:
    process_id: int
    num_processes: int

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> DistContext:
    """Join the gloo process group when num_processes > 1; no-op otherwise.

    Arguments default to the IMSAME_* environment variables so launchers
    need no code changes; a plain single-process run returns the
    degenerate context without touching torch.distributed.  Raises if the
    group does not assemble within ``timeout_s`` seconds."""
    coordinator = coordinator or os.environ.get("IMSAME_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("IMSAME_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("IMSAME_PROCESS_ID", "0"))
    if num_processes <= 1:
        return DistContext(0, 1)
    if not coordinator:
        raise ValueError(
            "multi-process run needs a coordinator address "
            "(IMSAME_COORDINATOR=host:port)"
        )
    torch.distributed.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        rank=process_id,
        world_size=num_processes,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return DistContext(process_id, num_processes)


def shard_query_for_host(q: SeqInfo, ctx: DistContext) -> SeqInfo:
    """Contiguous read stripe for this process: reads
    [pid * ceil(n/P), (pid+1) * ceil(n/P)), clamped to n -- the
    multi-host analog of the reference's per-thread read ranges
    (src/IMSAME.c:414,452).  Read indices in a stripe's results are
    local; add ``read_offset_for_host`` when merging.  One process gets
    ``q`` itself."""
    if not ctx.is_distributed:
        return q
    lo = read_offset_for_host(q.n_seqs, ctx)
    return q.slice_reads(lo, lo + -(-q.n_seqs // ctx.num_processes))


def read_offset_for_host(n_reads: int, ctx: DistContext) -> int:
    """Global read id of this process's first stripe read."""
    per = -(-n_reads // ctx.num_processes)
    return min(ctx.process_id * per, n_reads)


def allreduce_sum(value: int, ctx: DistContext) -> int:
    """Sum an int across processes (identity when single-process)."""
    if not ctx.is_distributed:
        return int(value)
    t = torch.tensor([value], dtype=torch.int64)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.SUM)
    return int(t.item())
