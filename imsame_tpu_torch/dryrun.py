"""Multi-position dry run of the port's whole engine (the counterpart of
the JAX package's ``dryrun_multichip``, ``__graft_entry__.py:54``).

``dryrun_multichip(n)`` takes synthetic reads through index build, the
extension gate, the stats-NW accept wave and the render, on one engine
over an n-position ("data", "dict") mesh (Config.mesh_shape,
parallel/mesh.py), and asserts the expected accepts and that the pairs
and report equal a one-device engine's (the mesh gives the one device's
bits by construction, parallel/sharded.py).  The positions are the
visible cards of ``device`` taken round-robin: on one card all n sit on
it, so the run checks the sharded program, not a multi-card speedup.

    python -m imsame_tpu_torch.dryrun [n]    # n positions (default 8)
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .config import Config
from .io.fasta import SeqInfo
from .parallel.mesh import visible_devices
from .pipeline import TorchEngine

N_READS, READ_LEN = 64, 150


def seqinfo(mat: np.ndarray) -> SeqInfo:
    """SeqInfo of an [n, L] code matrix, one read a row."""
    n, L = mat.shape
    start = np.arange(n, dtype=np.int64) * L
    fresh = np.zeros(n * L, bool)
    fresh[start] = True
    return SeqInfo(codes=mat.reshape(-1).copy(), start=start, fresh=fresh,
                   headers=[b""] * n)


def dryrun_inputs():
    """(query, db) code matrices: N_READS random reads of READ_LEN bp; the
    db's first half the query's reads with 4 % substitutions, its second
    half random."""
    rng = np.random.default_rng(1)
    qm = rng.integers(0, 4, (N_READS, READ_LEN), dtype=np.uint8)
    dbm = qm.copy()
    mut = rng.random(dbm.shape) < 0.04
    dbm[mut] = (dbm[mut] + rng.integers(1, 4, int(mut.sum()), np.uint8)) % 4
    dbm[N_READS // 2:] = rng.integers(
        0, 4, (N_READS - N_READS // 2, READ_LEN), dtype=np.uint8)
    return qm, dbm


def dryrun_multichip(n_devices: int, device="cuda"):
    """Run the engine on an n_devices-position mesh, grid (n/2, 2) when n
    is even, else (n, 1), over the visible devices of ``device`` taken
    round-robin; assert 32 of 64 accepts, a report, and the pairs and
    report of a one-device engine on the same device.  Prints one
    ``DRYRUN_MULTICHIP OK`` line and returns (result, report).  Raises
    ValueError for n < 2 (one position is no mesh) and for a grid the
    batch shapes do not divide over (TorchEngine._make_mesh), and
    RuntimeError for a CUDA device on a machine with no card."""
    if n_devices < 2:
        raise ValueError(f"a mesh needs 2 positions or more, got {n_devices}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is visible")
    cards = visible_devices(dev)
    positions = [cards[i % len(cards)] for i in range(n_devices)]
    n_dict = 2 if n_devices % 2 == 0 else 1
    grid = (n_devices // n_dict, n_dict)
    qm, dbm = dryrun_inputs()
    q, db = seqinfo(qm), seqinfo(dbm)

    eng = TorchEngine(db, Config(mesh_shape=grid), device=dev,
                      mesh_devices=positions)
    if eng._mesh is None or eng._mesh.size != n_devices:
        raise AssertionError(f"grid {grid}: the engine has no "
                             f"{n_devices}-position mesh")
    t0 = time.perf_counter()
    res = eng.compare(q)
    report = eng.render_report(q, res)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    if res.accepted != N_READS // 2 or not report:
        raise AssertionError(f"expected {N_READS // 2} accepted reads and a "
                             f"report, got {res.accepted} and "
                             f"{len(report)} bytes")

    one = TorchEngine(db, Config(mesh_shape=None), index=eng.index,
                      device=positions[0])
    want = one.compare(q)
    if res.pairs != want.pairs or report != one.render_report(q, want):
        raise AssertionError(f"mesh {grid}: pairs or report differ from "
                             "the one-device engine's")
    print(f"DRYRUN_MULTICHIP OK: mesh=(data={grid[0]}, dict={grid[1]})"
          f" devices={n_devices} cards={len(set(positions))}"
          f" accepted={res.accepted}/{N_READS} report_bytes={len(report)}"
          f" wall={wall:.3f}s", flush=True)
    return res, report


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
