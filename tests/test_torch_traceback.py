"""The traceback's kernel wrapper (ops/nw_cuda.py traceback) and its plain
torch version (ops/traceback.py traceback_batch), held against the JAX
package's traceback_batch bit for bit: at the buckets 1024 and 2048, and
on the inputs the kernel must copy exactly (best cells on row or column 0,
empty reads, padding pairs longer than the bucket, words that are not
F's).  The kernel itself runs only on the card (chip_smoke.py holds it to
the plain version there); on CPU tensors the wrapper is the plain
version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsame_tpu.ops import nw as jnw
from imsame_tpu.ops import traceback as jtb
from imsame_tpu_torch.ops import nw as tnw
from imsame_tpu_torch.ops import nw_cuda
from imsame_tpu_torch.ops import resolve as tresolve
from imsame_tpu_torch.ops import traceback as ttb

from test_torch_nw import _long_pairs, _mixed_pairs

IGAP, EGAP = -5, -2


def _forward(arrs, L):
    """Plain F of the port and of JAX on the same numpy pairs."""
    t = tnw.nw_forward_batch(*map(torch.as_tensor, arrs), IGAP, EGAP,
                             max_len=L)
    j = jnw.nw_forward_batch(*map(jnp.asarray, arrs), IGAP, EGAP, max_len=L)
    return t, j


def _jax_traceback(bp, best_i, best_j, L):
    """JAX's traceback_batch on numpy (or torch) inputs; its X and Y are
    unused by the walk."""
    B = best_i.shape[0]
    codes = jnp.zeros((B, L), jnp.uint8)
    return jtb.traceback_batch(jnp.asarray(np.asarray(bp)),
                               jnp.asarray(np.asarray(best_i)),
                               jnp.asarray(np.asarray(best_j)), codes, codes,
                               max_len=L)


def _assert_equal(got, want):
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("L", [1024, 2048])
def test_traceback_matches_jax_at_long_buckets(L):
    """F + traceback at the two buckets no other test walks: a near-copy
    pair (a long chain) and a random one."""
    arrs = _long_pairs(np.random.default_rng(600 + L), 2, L)
    t, j = _forward(arrs, L)
    want = _jax_traceback(j.bp, j.best_i, j.best_j, L)
    del j
    got = ttb.traceback_batch(t.bp, t.best_i, t.best_j, max_len=L)
    _assert_equal(got, want)
    assert int(got.n_steps.max()) > 8


def _degenerate(L):
    """F of mixed pairs whose last 8 have empty, 1-base and over-long
    reads (a batch's padding pairs repeat read 0, which may be either)."""
    X, Y, xlen, ylen = _mixed_pairs(np.random.default_rng(700 + L), 12, L)
    xlen[-8:] = (0, 0, 1, 1, L, 2 * L + 5, 3 * L, 300)
    ylen[-8:] = (0, 7, 1, L, 0, 2 * L - 3, 7, 3 * L)
    return _forward((X, Y, xlen, ylen), L)


@pytest.mark.parametrize("L", [128, 512])
def test_traceback_empty_and_over_long_pairs_match_jax(L):
    t, j = _degenerate(L)
    _assert_equal(ttb.traceback_batch(t.bp, t.best_i, t.best_j, max_len=L),
                  _jax_traceback(j.bp, j.best_i, j.best_j, L))


@pytest.mark.parametrize("edge", ["row", "column", "origin"])
def test_traceback_best_cell_on_the_border_matches_jax(edge):
    """A best cell on row or column 0 makes no move: the chain is the
    best cell alone, n_steps 0, every stat 0."""
    L = 128
    t, _ = _degenerate(L)
    bi, bj = t.best_i.clone(), t.best_j.clone()
    if edge in ("row", "origin"):
        bi[::2] = 0
    if edge in ("column", "origin"):
        bj[1::2] = 0
    got = ttb.traceback_batch(t.bp, bi, bj, max_len=L)
    _assert_equal(got, _jax_traceback(t.bp, bi, bj, L))
    still = ((bi == 0) | (bj == 0)).numpy()
    assert (got.n_steps.numpy()[still] == 0).all()
    assert (got.chain.numpy()[still, 1:] == -1).all()


@pytest.mark.parametrize("L", [128, 256])
def test_traceback_of_arbitrary_words_matches_jax(L):
    """Words F never writes: random 32-bit words (runs with bit 31 set, -1
    words, from-cells far outside the pair) reach the index clamp, walk to
    the 2L - 1 move limit and write chain entries equal to -1, which
    n_steps does not count."""
    rng = np.random.default_rng(800 + L)
    B = 16
    bp = rng.integers(-2**31, 2**31, (B, 2 * L - 1, L)).astype(np.int32)
    bp[:4] = -1
    bp[4:8] %= 1 << 24  # gap moves only
    bi = rng.integers(0, L, B).astype(np.int32)
    bj = rng.integers(0, L, B).astype(np.int32)
    got = ttb.traceback_batch(*map(torch.as_tensor, (bp, bi, bj)), max_len=L)
    _assert_equal(got, _jax_traceback(bp, bi, bj, L))
    assert int(got.n_steps.max()) == 2 * L - 1


@pytest.mark.parametrize("L", [128, 512])
def test_traceback_wrapper_takes_plain_path_on_cpu(L):
    t, _ = _degenerate(L)
    n = nw_cuda.traceback.launches
    got = nw_cuda.traceback(t.bp, t.best_i, t.best_j, max_len=L)
    assert isinstance(got, ttb.TracebackResult)
    _assert_equal(got, ttb.traceback_batch(t.bp, t.best_i, t.best_j,
                                           max_len=L))
    assert nw_cuda.traceback.launches == n  # no kernel launched


def test_traceback_wrapper_refuses_other_devices():
    L = 128
    bp = torch.empty((8, 2 * L - 1, L), dtype=torch.int32, device="meta")
    best = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        nw_cuda.traceback(bp, best, best, max_len=L)


@pytest.mark.parametrize("bad", [
    "dtype", "bucket", "shape", "best_shape", "contiguous", "empty",
])
def test_launch_traceback_validates_inputs(bad):
    """The launcher's checks run before anything reaches the card."""
    L, B = 128, 8
    bp = torch.zeros((B, 2 * L - 1, L), dtype=torch.int32)
    bi = torch.zeros(B, dtype=torch.int32)
    bj = torch.zeros(B, dtype=torch.int32)
    max_len = L
    if bad == "dtype":
        bp = bp.long()
    elif bad == "bucket":
        bp, max_len = torch.zeros((B, 2 * 100 - 1, 100), dtype=torch.int32), 100
    elif bad == "shape":
        bp = bp[:, :-1]
    elif bad == "best_shape":
        bj = bj[:-1]
    elif bad == "contiguous":
        bi = torch.zeros((B, 2), dtype=torch.int32)[:, 0]
    elif bad == "empty":
        bp, bi, bj = bp[:0], bi[:0], bj[:0]
    with pytest.raises(ValueError):
        nw_cuda.launch_traceback(bp, bi, bj, max_len=max_len)


def test_render_resolve_goes_through_the_wrapper(monkeypatch):
    """nw_traceback_rows walks its chunk through ops/nw_cuda.py traceback
    (the kernel on the card), once a call."""
    calls = []
    real = tresolve.traceback

    def counting(bp, best_i, best_j, *, max_len):
        calls.append((tuple(bp.shape), max_len))
        return real(bp, best_i, best_j, max_len=max_len)

    monkeypatch.setattr(tresolve, "traceback", counting)
    L = 128
    rng = np.random.default_rng(9)
    qp = torch.as_tensor(rng.integers(0, 2**32, (6, L // 16), dtype=np.uint32)
                         .view(np.int32))
    lens = torch.as_tensor(rng.integers(2, L + 1, 6).astype(np.int32))
    r = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    res = tresolve.nw_traceback_rows(qp, qp, r, r, lens, lens, IGAP, EGAP,
                                     max_len=L)
    assert calls == [((8, 2 * L - 1, L), L)]  # padded to the 4-pair tile
    assert res.chain.shape == (5, 2 * L)
