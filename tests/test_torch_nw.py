"""The port's plain NW aligners, traceback and resolve steps
(imsame_tpu_torch.ops) against the JAX package's, on the same seeded
numpy inputs.  Everything is integer DP, so the tolerance is exact
equality.  The CUDA kernels are held against these plain versions on the
card by chip_smoke.py; here their wrappers must take the plain path for
CPU tensors and refuse other devices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsame_tpu.ops import nw as jnw
from imsame_tpu.ops import resolve as jresolve
from imsame_tpu.ops import traceback as jtb
from imsame_tpu_torch.ops import nw as tnw
from imsame_tpu_torch.ops import nw_cuda
from imsame_tpu_torch.ops import resolve as tresolve
from imsame_tpu_torch.ops import traceback as ttb

from chip_smoke import TIE_KINDS, tie_pairs

IGAP, EGAP = -5, -2


def _mixed_pairs(rng, B, L):
    """Half mutated copies (substitutions, some with a shifted suffix that
    forces gap moves), half random; lengths 2..L with both ends present."""
    xlen = rng.integers(2, L + 1, B).astype(np.int32)
    ylen = rng.integers(2, L + 1, B).astype(np.int32)
    xlen[:4] = (2, L, 2, L)
    ylen[:4] = (2, L, L, 2)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(4, B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b]
        mut = rng.random(L) < 0.08
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 3 == 0 and xlen[b] > 8:
            cut = int(rng.integers(4, xlen[b] - 4))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 4)))
    return X, Y, xlen, ylen


def _long_pairs(rng, B, L, lo_frac=0.6):
    """Mutated-copy and random pairs with lengths in [lo_frac*L, L], as in
    tests/test_longreads.py: half copies with 6% substitutions, every
    other one with a shifted suffix that forces gap moves."""
    lo = max(16, int(L * lo_frac))
    xlen = rng.integers(lo, L + 1, B).astype(np.int32)
    ylen = rng.integers(lo, L + 1, B).astype(np.int32)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b].copy()
        mut = rng.random(L) < 0.06
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 2 == 0:
            cut = int(rng.integers(8, max(9, xlen[b] - 8)))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 5)))
    return X, Y, xlen, ylen


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.as_tensor(a) for a in arrs]


def _eq(got, want, what=""):
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(want), err_msg=what
    )


@pytest.mark.parametrize("seed,L", [(0, 128), (1, 256)])
def test_nw_stats_matches_jax(seed, L):
    j, t = _both(_mixed_pairs(np.random.default_rng(seed), 24, L))
    want = jnw.nw_stats_batch(*j, IGAP, EGAP, max_len=L)
    got = tnw.nw_stats_batch(*t, IGAP, EGAP, max_len=L)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("seed,L", [(2, 128), (3, 256)])
def test_nw_forward_and_traceback_match_jax(seed, L):
    j, t = _both(_mixed_pairs(np.random.default_rng(seed), 16, L))
    want = jnw.nw_forward_batch(*j, IGAP, EGAP, max_len=L)
    got = tnw.nw_forward_batch(*t, IGAP, EGAP, max_len=L)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    # the words with >= 8 run matches are negative, as in JAX
    assert (np.asarray(got.bp) < -1).any()

    tb_want = jtb.traceback_batch(
        want.bp, want.best_i, want.best_j, j[0], j[1], max_len=L
    )
    tb_got = ttb.traceback_batch(got.bp, got.best_i, got.best_j, max_len=L)
    for f in tb_want._fields:
        _eq(getattr(tb_got, f), getattr(tb_want, f), f)


@pytest.mark.parametrize("L", [512, 1024, 2048, 3072])
def test_nw_stats_long_matches_jax(L):
    """The long-read buckets, where the kernel walks its rows in strips."""
    j, t = _both(_long_pairs(np.random.default_rng(300 + L), 4, L))
    want = jnw.nw_stats_batch(*j, IGAP, EGAP, max_len=L)
    got = tnw.nw_stats_batch(*t, IGAP, EGAP, max_len=L)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("L", [256, 512])
@pytest.mark.parametrize("kind", TIE_KINDS)
def test_nw_stats_ties_match_jax(kind, L):
    """Tie-heavy pairs, in one strip (256) and across two (512): the pairs
    that chip_smoke.py holds the kernel to on the card."""
    j, t = _both(tie_pairs(kind, L))
    want = jnw.nw_stats_batch(*j, IGAP, EGAP, max_len=L)
    got = tnw.nw_stats_batch(*t, IGAP, EGAP, max_len=L)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("L", [256, 512])
@pytest.mark.parametrize("kind", TIE_KINDS)
def test_nw_forward_ties_match_jax(kind, L):
    """Function F and the traceback on the tie-heavy pairs, in one strip
    (256) and across two (512), where the best cell's tie-break and the
    from-words of tied moves decide: chip_smoke.py holds the kernel to
    them on the card (and at 1024 and 3072)."""
    j, t = _both(tie_pairs(kind, L))
    want = jnw.nw_forward_batch(*j, IGAP, EGAP, max_len=L)
    got = tnw.nw_forward_batch(*t, IGAP, EGAP, max_len=L)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    tb_want = jtb.traceback_batch(
        want.bp, want.best_i, want.best_j, j[0], j[1], max_len=L
    )
    tb_got = ttb.traceback_batch(got.bp, got.best_i, got.best_j, max_len=L)
    for f in tb_want._fields:
        _eq(getattr(tb_got, f), getattr(tb_want, f), f)


@pytest.mark.parametrize("L", [512, 3072])
def test_nw_forward_and_traceback_long_match_jax(L):
    j, t = _both(_long_pairs(np.random.default_rng(400 + L), 4, L))
    want = jnw.nw_forward_batch(*j, IGAP, EGAP, max_len=L)
    got = tnw.nw_forward_batch(*t, IGAP, EGAP, max_len=L)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    tb_want = jtb.traceback_batch(
        want.bp, want.best_i, want.best_j, j[0], j[1], max_len=L
    )
    del want
    tb_got = ttb.traceback_batch(got.bp, got.best_i, got.best_j, max_len=L)
    for f in tb_want._fields:
        _eq(getattr(tb_got, f), getattr(tb_want, f), f)


@pytest.mark.parametrize("L", [128, 512])
def test_nw_empty_and_over_long_lengths_match_jax(L):
    """Lengths 0, 1 and past L: a batch's padding pairs repeat read 0,
    which may be empty or longer than the chunk's bucket.  The kernels
    must equal these results too (chip_smoke.py holds them to it)."""
    X, Y, _, _ = _mixed_pairs(np.random.default_rng(500 + L), 8, L)
    xlen = np.array([0, 0, 1, 1, L, 2 * L + 5, 3 * L, 300], np.int32)
    ylen = np.array([0, 7, 1, L, 0, 2 * L - 3, 7, 3 * L], np.int32)
    j, t = _both((X, Y, xlen, ylen))
    for jf, tf in ((jnw.nw_stats_batch, tnw.nw_stats_batch),
                   (jnw.nw_forward_batch, tnw.nw_forward_batch)):
        want = jf(*j, IGAP, EGAP, max_len=L)
        got = tf(*t, IGAP, EGAP, max_len=L)
        for f in want._fields:
            _eq(getattr(got, f), getattr(want, f), f)


def test_kernel_wrappers_take_plain_path_on_cpu():
    L = 128
    t = [torch.as_tensor(a) for a in _mixed_pairs(np.random.default_rng(4), 8, L)]
    n_s, n_f = nw_cuda.nw_stats.launches, nw_cuda.nw_forward.launches
    for wrapped, plain in (
        (nw_cuda.nw_stats, tnw.nw_stats_batch),
        (nw_cuda.nw_forward, tnw.nw_forward_batch),
    ):
        got = wrapped(*t, IGAP, EGAP, max_len=L)
        want = plain(*t, IGAP, EGAP, max_len=L)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # no kernel launched
    assert (nw_cuda.nw_stats.launches, nw_cuda.nw_forward.launches) == (n_s, n_f)


def test_kernel_wrappers_refuse_other_devices():
    t = [torch.as_tensor(a, device="meta")
         for a in _mixed_pairs(np.random.default_rng(5), 8, 128)]
    for wrapped in (nw_cuda.nw_stats, nw_cuda.nw_forward):
        with pytest.raises(ValueError):
            wrapped(*t, IGAP, EGAP, max_len=128)


def _packed_rows(rng, n, L):
    words = rng.integers(0, 2**32, (n, L // 16), dtype=np.uint32)
    lens = rng.integers(2, L + 1, n).astype(np.int32)
    return words, lens


@pytest.mark.parametrize("L,B", [(128, 6), (256, 8), (512, 6)])
def test_resolve_rows_match_jax(L, B):
    """Row gather + unpack + stats / forward + traceback, with a batch
    that is not a multiple of the kernels' tile (padded, then sliced)."""
    rng = np.random.default_rng(L + B)
    qw, qlen = _packed_rows(rng, 12, L)
    dw, dlen = _packed_rows(rng, 10, L)
    # make some pairs near-identical so paths have long diagonal runs
    dw[:5] = qw[:5]
    dlen[:5] = qlen[:5]
    r = rng.integers(0, 12, B).astype(np.int32)
    s = rng.integers(0, 10, B).astype(np.int32)
    r[:3] = s[:3] = (0, 1, 2)
    jq, jd = jnp.asarray(qw), jnp.asarray(dw)
    tq, td = torch.as_tensor(qw.view(np.int32)), torch.as_tensor(dw.view(np.int32))

    _eq(tresolve.unpack_rows(tq, torch.as_tensor(r), L),
        jresolve.unpack_rows(jq, jnp.asarray(r), L))

    rs = np.stack([r, s])
    want = jresolve.nw_stats_rows(
        jq, jd, jnp.asarray(rs), jnp.asarray(qlen), jnp.asarray(dlen),
        IGAP, EGAP, max_len=L, use_pallas=False,
    )
    got = tresolve.nw_stats_rows(
        tq, td, torch.as_tensor(rs), torch.as_tensor(qlen),
        torch.as_tensor(dlen), IGAP, EGAP, max_len=L,
    )
    _eq(got, want)

    want = jresolve.nw_traceback_rows(
        jq, jd, jnp.asarray(r), jnp.asarray(s), jnp.asarray(qlen),
        jnp.asarray(dlen), IGAP, EGAP, max_len=L, use_pallas=False,
    )
    got = tresolve.nw_traceback_rows(
        tq, td, torch.as_tensor(r), torch.as_tensor(s), torch.as_tensor(qlen),
        torch.as_tensor(dlen), IGAP, EGAP, max_len=L,
    )
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
