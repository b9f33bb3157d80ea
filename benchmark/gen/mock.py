"""Mock-community read pairs of one length: a frozen copy of the
repository's `bench.py synth_pair` (BASELINE config 2's workload).

The db holds, for the first `match_frac` of the query reads, a copy with
4 % substitutions, and uniform random reads for the rest; the db's order
is shuffled.  Every seed gives the same read count and length."""

from __future__ import annotations

import numpy as np


def synth_pair(n: int, read_len: int, match_frac: float, rng):
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < 0.04
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()),
                                        dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)])
    perm = rng.permutation(n)
    return q, db[perm]


def generate(config: dict, traffic: dict, rng) -> dict:
    n, L = config["reads"], config["read_len"]
    q, db = synth_pair(n, L, traffic["match_frac"], rng)
    starts = np.arange(n, dtype=np.int64) * L
    return dict(q_codes=q.reshape(-1), q_starts=starts,
                db_codes=db.reshape(-1), db_starts=starts.copy())
