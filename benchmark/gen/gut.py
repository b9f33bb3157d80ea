"""A gut metagenome pair of one read length: a frozen copy of the
repository's `bench_config3.py synth` (BASELINE config 3's workload),
with one query slice kept.

The db holds, for the first `match_frac` of the query sample's reads, a
copy with `sub` substitutions, and uniform random reads for the rest;
the db's order is shuffled.  The query side of a job is `query_reads`
reads drawn from the seed out of the whole query sample, in sample
order, so about 1 - match_frac of them have no copy in the db, as in
any slice of a real sample.  Every seed gives the same read counts and
length."""

from __future__ import annotations

import numpy as np


def synth(n: int, read_len: int, match_frac: float, sub_rate: float, rng):
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < sub_rate
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()),
                                        dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)])
    return q, db[rng.permutation(n)]


def generate(config: dict, traffic: dict, rng) -> dict:
    n, L = config["reads"], config["read_len"]
    q, db = synth(n, L, traffic["match_frac"], config["sub"], rng)
    q = q[np.sort(rng.choice(n, size=config["query_reads"], replace=False))]
    return dict(q_codes=q.reshape(-1),
                q_starts=np.arange(len(q), dtype=np.int64) * L,
                db_codes=db.reshape(-1),
                db_starts=np.arange(n, dtype=np.int64) * L)
