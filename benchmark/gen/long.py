"""Long-read pairs: a copy of the repository's `chip_smoke.long_pair_np`
and `mutate_np`, in bulk numpy and with the match fraction as a parameter.

Read lengths are one fixed set spread evenly over [min_len, max_len]
(every seed has the same lengths, in its own order).  The first
`match_frac` of the query reads get a copy in the db with `sub`
substitutions and `indel` indels a base (a deletion, or a random base
inserted before it, half each), cut to `max_len`; the other db reads are
random, with the lengths of the query reads that were not copied.  The
db's order is shuffled."""

from __future__ import annotations

import numpy as np


def _starts(lens: np.ndarray) -> np.ndarray:
    return (np.cumsum(lens) - lens).astype(np.int64)


def mutate(rng, codes, lens, sub: float, indel: float, cap: int):
    """Mutate the reads lying back to back in `codes` (lengths `lens`);
    returns (codes, lengths)."""
    n = len(codes)
    r = rng.random(n)
    dele = r < indel / 2
    ins = (r >= indel / 2) & (r < indel)
    subd = rng.random(n) < sub
    base = np.where(subd, (codes + rng.integers(1, 4, n)) % 4,
                    codes).astype(np.uint8)
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(base, reps)
    first = np.cumsum(reps) - reps
    out[first[ins]] = rng.integers(0, 4, int(ins.sum()))
    new_lens = np.add.reduceat(reps, _starts(lens)) if len(lens) else lens
    # cut every read to `cap`
    offset = np.arange(len(out)) - np.repeat(_starts(new_lens), new_lens)
    keep = offset < cap
    return out[keep], np.minimum(new_lens, cap)


def generate(config: dict, traffic: dict, rng) -> dict:
    n, lo, hi = config["reads"], config["min_len"], config["max_len"]
    fixed = lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // n
    q_lens = rng.permutation(fixed)
    q_codes = rng.integers(0, 4, int(q_lens.sum()), dtype=np.uint8)
    nm = int(n * traffic["match_frac"])
    q_starts = _starts(q_lens)
    cut = int(q_starts[nm]) if nm < n else len(q_codes)
    cp_codes, cp_lens = mutate(rng, q_codes[:cut], q_lens[:nm],
                               config["sub"], config["indel"], hi)
    rnd_lens = rng.permutation(q_lens[nm:])
    rnd_codes = rng.integers(0, 4, int(rnd_lens.sum()), dtype=np.uint8)
    db_lens = np.concatenate([cp_lens, rnd_lens]).astype(np.int64)
    db_codes = np.concatenate([cp_codes, rnd_codes])
    perm = rng.permutation(n)
    src = _starts(db_lens)
    new_lens = db_lens[perm]
    order = (np.repeat(src[perm] - _starts(new_lens), new_lens)
             + np.arange(int(new_lens.sum())))
    return dict(q_codes=q_codes, q_starts=q_starts,
                db_codes=db_codes[order], db_starts=_starts(new_lens))
