"""Sharding overhead of the port's mesh engine (the counterpart of the JAX
package's ``bench_scaling.py``).

    python -m imsame_tpu_torch.bench_scaling [--reads N] [--device D]

One workload, ``synth_pair(N, 250, 0.5, seed=999)`` (default N = 20,000),
through ``TorchEngine.compare`` on one device and on the grids (2, 1),
(4, 1), (8, 1), (4, 2), (2, 4) and (1, 8) of Config.mesh_shape, whose
positions are the visible cards of D (default "cuda") taken round-robin.
Each grid builds its engine (on the one-device engine's index), runs one
warm compare, then three timed compares, each ended by a synchronise, and
keeps the best; its pairs must equal the one-device engine's.  Prints one
JSON line a grid (mesh, seconds, reads/s, accepted, the engine's phase
seconds and each kernel's launches in the best compare) and a summary
line with ``overhead_by_mesh`` = T_mesh / T_single.  On one card every
position shares it, so the overhead reads what sharding costs (a launch
sequence a position, the merges onto the first position), not a speedup.
Writes no file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .config import Config
from .dryrun import seqinfo
from .ops import gate_cuda, nw_cuda
from .parallel.mesh import visible_devices
from .pipeline import TorchEngine

GRIDS = (None, (2, 1), (4, 1), (8, 1), (4, 2), (2, 4), (1, 8))
TIMED_RUNS = 3
# every kernel's wrapper, whose launches a compare counts
COUNTED = {"nw_stats": nw_cuda.nw_stats, "nw_forward": nw_cuda.nw_forward,
           "traceback": nw_cuda.traceback, "gate": gate_cuda.gate}


def synth_pair(n: int, read_len: int, match_frac: float, seed: int):
    """bench.py's workload: n random query reads; match_frac of the db
    reads are ~4%-mutated copies of query reads, the rest random."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < 0.04
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)]
    )
    perm = rng.permutation(n)
    return q, db[perm]


def card_info(dev: torch.device):
    """(device name, nvidia-smi's "name, power.limit" line or None)."""
    if dev.type != "cuda":
        return str(dev), None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev), smi


def timed_compare(eng: TorchEngine, q, devices):
    """(result, wall seconds, phase seconds, launches) of one compare, the
    clock read after every device in ``devices`` has finished.  The
    engine's phase timer sums over its compares: the phases are this
    compare's share."""
    for fn in COUNTED.values():
        fn.launches = 0
    before = dict(eng.timer.items())
    t0 = time.perf_counter()
    res = eng.compare(q)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    dt = time.perf_counter() - t0
    phases = {k: v - before.get(k, 0.0) for k, v in sorted(eng.timer.items())
              if v != before.get(k, 0.0)}
    return res, dt, phases, {k: fn.launches for k, fn in COUNTED.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=20_000,
                    help="reads a side (default 20,000)")
    ap.add_argument("--device", default="cuda",
                    help='torch device whose visible cards hold the mesh '
                         'positions (default "cuda")')
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r}: no CUDA device is visible")
    cards = visible_devices(dev)
    positions = [cards[i % len(cards)] for i in range(8)]
    n = args.reads
    qc, dbc = synth_pair(n, 250, 0.5, seed=999)
    q, db = seqinfo(qc), seqinfo(dbc)

    results, index, want = {}, None, None
    for grid in GRIDS:
        key = "single" if grid is None else f"{grid[0]}x{grid[1]}"
        eng = TorchEngine(db, Config(mesh_shape=grid), index=index,
                          device=cards[0], mesh_devices=positions)
        index = eng.index
        used = set(eng._mesh.devices if eng._mesh else [eng.device])
        eng.compare(q)  # warm: the kernels' build, allocator, caches
        runs = [timed_compare(eng, q, used) for _ in range(TIMED_RUNS)]
        res, best, phases, launches = min(runs, key=lambda r: r[1])
        if want is None:
            want = res.pairs
        elif res.pairs != want:
            raise AssertionError(f"mesh {key}: pairs differ from the "
                                 "one-device engine's")
        results[key] = best
        print(json.dumps({
            "mesh": key, "seconds": best,
            "seconds_runs": [r[1] for r in runs],
            "reads_per_s": n / best, "accepted": res.accepted,
            "phases": phases,
            "launches": launches,
        }), flush=True)
        del eng, res, runs

    name, smi = card_info(cards[0])
    print(json.dumps({
        "metric": "sharding overhead (T_mesh / T_single, best of "
                  f"{TIMED_RUNS} warm compares)",
        "overhead_by_mesh": {k: v / results["single"]
                             for k, v in results.items() if k != "single"},
        "reads_per_s_by_mesh": {k: n / v for k, v in results.items()},
        "n_reads": n, "device": name, "cards": len(set(positions)),
        "name_power_limit": smi,
        "note": "positions sharing a card measure sharding overhead (a "
                "launch sequence a position, merges onto the first "
                "position), not speedup",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
