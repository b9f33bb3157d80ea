"""Long-read pairs shaped as CAMI II's long-read samples trimmed to IMSAME's
3,000-bp limit.

Read lengths are drawn from the seed, log-normal with the configuration's
`len_mean` and `len_sd`; a length under `min_len` is drawn again, so a
sample holds `reads` reads, and every length is trimmed at `max_len`.
The first `match_frac` of the query reads get a copy in the db with `sub`
substitutions and `indel` indels a base (`gen/long.py`'s `mutate`), cut
to `max_len`; the other db reads are random, with the lengths of the
query reads that were not copied.  The db's order is shuffled."""

from __future__ import annotations

import numpy as np

from benchmark.gen.long import _starts, mutate


def lengths(config: dict, n: int, rng) -> np.ndarray:
    """n lengths, log-normal with mean len_mean and SD len_sd, none under
    min_len, trimmed at max_len."""
    mean, sd = config["len_mean"], config["len_sd"]
    s2 = np.log1p((sd / mean) ** 2)
    mu = np.log(mean) - s2 / 2
    out = np.empty(0, np.int64)
    while len(out) < n:
        x = rng.lognormal(mu, np.sqrt(s2), n - len(out)).astype(np.int64)
        out = np.concatenate([out, x[x >= config["min_len"]]])
    return np.minimum(out, config["max_len"])


def generate(config: dict, traffic: dict, rng) -> dict:
    n, hi = config["reads"], config["max_len"]
    q_lens = lengths(config, n, rng)
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
