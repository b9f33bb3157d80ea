"""The generators repeat by seed, and every seed makes the same sizes."""

import numpy as np

from benchmark import run

MOCK = dict(reads=500, read_len=250)
LONG = dict(reads=200, min_len=300, max_len=3000, sub=0.04, indel=0.01)


def _gen(name):
    return run.load_module(f"{run.BENCH}/gen/{name}.py")


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_mock_repeats_by_seed():
    g = _gen("mock")
    for frac in (0.0, 0.5, 0.95):
        a = g.generate(MOCK, {"match_frac": frac}, np.random.default_rng(7))
        b = g.generate(MOCK, {"match_frac": frac}, np.random.default_rng(7))
        c = g.generate(MOCK, {"match_frac": frac}, np.random.default_rng(8))
        assert _same(a, b) and not _same(a, c)
        assert len(a["q_codes"]) == len(c["q_codes"]) == 500 * 250


def test_mock_shares_the_match_fraction():
    g = _gen("mock")
    d = g.generate(MOCK, {"match_frac": 0.5}, np.random.default_rng(3))
    q = d["q_codes"].reshape(500, 250)
    db = d["db_codes"].reshape(500, 250)
    same = (q[:250, None, :] == db[None, :, :]).mean(2).max(1)
    assert (same > 0.9).all()  # every shared read has its 4 % copy


def test_long_repeats_by_seed_with_one_set_of_lengths():
    g = _gen("long")
    for frac in (0.0, 0.5):
        a = g.generate(LONG, {"match_frac": frac}, np.random.default_rng(7))
        b = g.generate(LONG, {"match_frac": frac}, np.random.default_rng(7))
        c = g.generate(LONG, {"match_frac": frac}, np.random.default_rng(9))
        assert _same(a, b) and not _same(a, c)
        la = np.diff(np.append(a["q_starts"], len(a["q_codes"])))
        lc = np.diff(np.append(c["q_starts"], len(c["q_codes"])))
        assert np.array_equal(np.sort(la), np.sort(lc))
        assert la.min() >= 300 and la.max() <= 3000
        ld = np.diff(np.append(a["db_starts"], len(a["db_codes"])))
        assert ld.max() <= 3000 and len(ld) == 200


def test_long_copies_carry_their_mutations():
    g = _gen("long")
    codes = np.random.default_rng(1).integers(0, 4, 30000, dtype=np.uint8)
    lens = np.full(10, 3000)
    out, new = g.mutate(np.random.default_rng(2), codes, lens, 0.04, 0.01,
                        3000)
    assert len(out) == new.sum() and new.max() <= 3000
    assert (new > 2900).all()
