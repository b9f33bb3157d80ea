"""Related samples of one read length, each holding reads of both
strands, for an all-vs-all sweep.

A pool of `pool_reads` random fragments stands for the community.  Each
of the `samples` samples takes `shared_frac` of its `reads` as copies of
distinct pool fragments chosen from the seed, each copy with `sub`
substitutions of its own and reverse-complemented with probability
`rc_frac`; its other reads are random and its own; its order is
shuffled.  Two samples of 20,000 reads drawn from a pool of 20,000 share
~5,000 fragments, about half on the same strand (the forward compare
accepts them) and half on opposite strands (the `.r` compare does).

One reverse compare X-Y.r (X < Y) of the sweep is drawn from the seed
for the reference: the query is sample X, the db the plain reverse
complement of sample Y.  Codes are A, C, G, T = 0, 1, 2, 3.  Nothing here
imports the program."""

from __future__ import annotations

import numpy as np


def revcomp(codes: np.ndarray, starts: np.ndarray) -> tuple:
    """(codes, starts) of the reads' reverse complements in reverse read
    order, as the reference's revComp tool writes a FASTA file: the whole
    stream reversed, each code c as 3 - c."""
    lens = np.diff(np.append(starts, len(codes)))[::-1]
    return (3 - codes[::-1]).astype(np.uint8), \
        np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)


def make_samples(n_samples: int, n: int, read_len: int, sub: float,
                 traffic: dict, rng) -> list:
    """Each sample's codes and starts, and each read's pool fragment (-1
    for a sample's own reads) and strand (True: reverse-complemented)."""
    pool = rng.integers(0, 4, (traffic["pool_reads"], read_len),
                        dtype=np.uint8)
    n_shared = int(n * traffic["shared_frac"])
    out = []
    for _ in range(n_samples):
        pick = rng.choice(len(pool), n_shared, replace=False)
        copies = pool[pick]
        mask = rng.random(copies.shape) < sub
        copies[mask] = (copies[mask] + rng.integers(
            1, 4, int(mask.sum()), dtype=np.uint8)) % 4
        rc = rng.random(n_shared) < traffic["rc_frac"]
        copies[rc] = 3 - copies[rc, ::-1]
        reads = np.concatenate([copies, rng.integers(
            0, 4, (n - n_shared, read_len), dtype=np.uint8)])
        origin = np.concatenate([pick, np.full(n - n_shared, -1)])
        strand = np.concatenate([rc, np.zeros(n - n_shared, bool)])
        perm = rng.permutation(n)
        out.append(dict(codes=reads[perm].reshape(-1),
                        starts=np.arange(n, dtype=np.int64) * read_len,
                        pool_index=origin[perm], rc=strand[perm]))
    return out


def generate(config: dict, traffic: dict, rng) -> dict:
    k = config["samples"]
    samples = make_samples(k, config["reads"], config["read_len"],
                           config["sub"], traffic, rng)
    pairs = [(x, y) for x in range(k) for y in range(x + 1, k)]
    x, y = pairs[int(rng.integers(len(pairs)))]
    db_codes, db_starts = revcomp(samples[y]["codes"], samples[y]["starts"])
    return dict(q_codes=samples[x]["codes"], q_starts=samples[x]["starts"],
                db_codes=db_codes, db_starts=db_starts, samples=samples,
                designated=(x, y))
