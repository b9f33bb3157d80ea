"""The traceback kernel's banded walk (csrc/traceback.cu), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it to the
plain walk bit for bit.  Here its launch is written out in numpy, one
pair a warp (``kernel_model``): the band's geometry (the 2W antidiagonals
at and below the walk's cell, in each the cells within G of its offset
that a walk can reach, copied as aligned 16-byte segments), the rounds
(a cell outside the band anchors the next), the direct load of the
clamped address for a cell no band can hold (px >= L, px + py > 2L - 2),
the moves, the stats and the chain with its -1 tail.  Every word the
model reads from its band must be one of that round's cells.  It is
held against the port's plain traceback_batch and the JAX package's
traceback_batch on all six outputs, bit for bit, on F's outputs at 256,
1024 and 3072, on empty, over-long and border best cells and on crafted
words; its round count against chip_smoke.tile_rounds, which counts them
from the chain alone.  Integer results: the tolerance is exact
equality."""

import numpy as np
import pytest
import torch

import chip_smoke
from imsame_tpu_torch.ops import nw as tnw
from imsame_tpu_torch.ops import nw_cuda
from imsame_tpu_torch.ops import traceback as ttb
from test_torch_nw import _long_pairs
from test_torch_traceback import _assert_equal, _degenerate, _jax_traceback

IGAP, EGAP = -5, -2
PACK = 4096
RUN_FLAG = ttb.RUN_FLAG


CRAFT = (32, 2)  # the band of the crafted-word tests, at any bucket


def _band(L, band=None):
    """(W, G, rows, segments a row, words a row) of the kernel's band at
    bucket L, or of `band` (W, G)."""
    W, G = band or nw_cuda.TRACEBACK_BAND[L]
    segs = (G + 3) // 4 + 1
    return W, G, 2 * W, segs, 4 * segs


def row_range(d, c0, L, G):
    """(lo, hi): the cells i of antidiagonal d within G of offset c0 that a
    walk can reach (1 <= i <= min(L - 1, d - 1)), as the kernel computes
    them (Band.load); empty when lo > hi."""
    lo = max((d + c0 - G + 1) >> 1, 1)
    hi = min((d + c0 + G) >> 1, L - 1, d - 1)
    return lo, hi


def row_base(d, c0, G):
    """Row d's first word in the band (Band.base): ceil((d + c0 - G) / 2)
    rounded down to a multiple of 4, which may lie a few words before the
    row."""
    return ((d + c0 - G + 1) >> 1) & ~3


def kernel_model(bp_flat, best_i, best_j, L, pairs=None, band=None):
    """The kernel's launch on the pairs `pairs` (default all), one at a
    time, with the bucket's band or `band` (W, G; W = 0: no band, every
    word read directly).  bp_flat is the batch's bp words in one flat
    sequence (anything indexable by int64 offsets); each pair's words
    start at b * (2L - 1) * L.  Returns (TracebackResult of numpy arrays,
    rounds, highest offset read)."""
    W, G, R, segs, stride = _band(L, band)
    CH, words = 2 * L, (2 * L - 1) * L
    pairs = range(len(best_i)) if pairs is None else pairs
    n = len(pairs)
    stats = np.zeros((5, n), np.int32)
    chain = np.full((n, CH), 0x5EED, np.int32)  # every word is written
    rounds = np.zeros(n, np.int64)
    top = 0
    for o, b in enumerate(pairs):
        base = int(b) * words  # 64-bit, as the kernel's pair offset
        rows = np.zeros((R, stride), np.int64)
        fresh = np.zeros((R, stride), bool)  # the band's cells this round
        px, py = int(best_i[b]), int(best_j[b])
        ln = ident = ig = eg = 0
        entry = px * PACK + py
        chain[o, 0] = entry  # lane 0 writes the entries
        valid = int(entry != -1)
        s0, c0, t = -1, 0, 0
        while px > 0 and py > 0 and t < CH - 1:
            d = px + py
            off = px - py - c0
            in_band = 0 <= s0 - d < R and px < L and -G <= off <= G
            if not in_band and W and d <= 2 * L - 2 and px < L:  # a round
                s0, c0 = d, px - py
                fresh[:] = False
                for k in range(R):  # lane k % 32 copies row k
                    dk = s0 - k
                    if dk < 2:
                        break
                    lo, hi = row_range(dk, c0, L, G)
                    if lo > hi:
                        continue
                    a = row_base(dk, c0, G)
                    for s in range(segs):
                        if a + 4 * s <= hi:
                            at = base + dk * L + a + 4 * s
                            rows[k, 4 * s:4 * s + 4] = bp_flat[at:at + 4]
                            top = max(top, at + 3)
                    fresh[k, lo - a:hi - a + 1] = True
                rounds[o] += 1
                in_band = True
            if in_band:
                k, slot = s0 - d, px - row_base(d, c0, G)
                assert fresh[k, slot], (b, px, py)
                w = int(rows[k, slot]) & 0xFFFFFFFF
            else:  # the clamped address, read directly
                at = base + min(d * L + px, words - 1)
                w = int(bp_flat[at]) & 0xFFFFFFFF
                rounds[o] += 1
                top = max(top, at)
            run = (w >> 24) & 15
            if run > 0:
                fx, fy = px - run, py - run
                ln += run
                ident += w >> 28
                entry = (fx * PACK + fy) | RUN_FLAG
            else:
                frm = w & ((1 << 24) - 1)
                fx, fy = frm // PACK, frm % PACK
                dx, dy = px - fx, py - fy
                gap = dx if dx > dy else dy
                ln += gap
                eg += gap - 1
                ig += 1
                entry = fx * PACK + fy
            t += 1
            chain[o, t] = entry
            valid += entry != -1
            px, py = fx, fy
        chain[o, t + 1:] = -1  # the lanes' tail
        stats[:, o] = (ln, ident, ig, eg, valid - 1)
    res = ttb.TracebackResult(*stats[:4], chain, stats[4])
    return res, rounds, top


def _hold(bp, bi, bj, L, band=None):
    """The model (the bucket's band, or `band`) against the plain walk and
    JAX's, all six outputs, and its rounds against chip_smoke.tile_rounds;
    returns (model, rounds)."""
    bp, bi, bj = (np.ascontiguousarray(np.asarray(a, np.int32))
                  for a in (bp, bi, bj))
    got, rounds, _ = kernel_model(bp.reshape(-1), bi, bj, L, band=band)
    plain = ttb.traceback_batch(*map(torch.as_tensor, (bp, bi, bj)),
                                max_len=L)
    _assert_equal(got, plain)
    _assert_equal(got, _jax_traceback(bp, bi, bj, L))
    np.testing.assert_array_equal(
        rounds, chip_smoke.tile_rounds(got.chain, L, band))
    return got, rounds


# ---------------------------------------------------------------------
# F's outputs


def _copies(rng, X, xlen, sub, indel, L):
    """Copies of the reads X with chip_smoke.mutate_np's mutations, cut
    to L: (Y, ylen)."""
    Y = np.zeros_like(X)
    ylen = np.zeros_like(xlen)
    for b in range(len(X)):
        y = chip_smoke.mutate_np(rng, X[b, :xlen[b]], sub, indel)[:L]
        Y[b, :len(y)] = y
        ylen[b] = len(y)
    return Y, ylen


def _real_pairs(L, n):
    """n pairs of each kind at bucket L: copies with 4 % substitutions and
    1 % indels (the long 20k's), substitution-only copies (the 20k's),
    random pairs, and long_pairs' copies with a shifted suffix."""
    rng = np.random.default_rng(1300 + L)
    lo = {256: 150, 1024: 600, 3072: 2500}[L]
    hi = min(L, {256: 250, 1024: 1000, 3072: 3000}[L])

    def lengths():
        return rng.integers(lo, hi + 1, n).astype(np.int32)

    parts = []
    for sub, indel in ((0.04, 0.01), (0.04, 0.0)):
        X, xlen = rng.integers(0, 4, (n, L)).astype(np.uint8), lengths()
        Y, ylen = _copies(rng, X, xlen, sub, indel, L)
        parts.append((X, Y, xlen, ylen))
    parts.append((rng.integers(0, 4, (n, L)).astype(np.uint8),
                  rng.integers(0, 4, (n, L)).astype(np.uint8),
                  lengths(), lengths()))
    # _long_pairs' first half are copies, the even ones shifted
    shifted = [a[:2 * n:2] for a in _long_pairs(rng, 4 * n, L)]
    parts.append(tuple(shifted))
    return tuple(np.concatenate(a) for a in zip(*parts))


_F = {}


def _forward(L):
    """The port's plain F on _real_pairs(L), once per process."""
    if L not in _F:
        n = {256: 4, 1024: 2, 3072: 1}[L]
        arrs = _real_pairs(L, n)
        f = tnw.nw_forward_batch(*map(torch.as_tensor, arrs), IGAP, EGAP,
                                 max_len=L)
        _F[L] = (f.bp.numpy(), f.best_i.numpy(), f.best_j.numpy())
    return _F[L]


@pytest.mark.parametrize("L", [256, 1024, 3072])
def test_model_matches_plain_and_jax_on_forward_outputs(L):
    bp, bi, bj = _forward(L)
    got, rounds = _hold(bp, bi, bj, L)
    steps = got.n_steps
    assert steps.max() >= L // 16  # the copies walk far
    if nw_cuda.TRACEBACK_BAND[L][0]:  # a round serves several moves
        assert rounds.max() < steps.max()
    else:  # no band: one direct read a move
        np.testing.assert_array_equal(rounds, steps)


@pytest.mark.parametrize("L", [256, 1024])
def test_model_without_a_band_reads_each_word_directly(L):
    """W = 0: every move is one direct read of its word."""
    bp, bi, bj = _forward(L)
    got, rounds = _hold(bp, bi, bj, L, (0, 2))
    np.testing.assert_array_equal(rounds, got.n_steps)


@pytest.mark.parametrize("L", [128, 512])
def test_model_on_empty_and_over_long_pairs(L):
    t, _ = _degenerate(L)
    _hold(t.bp, t.best_i, t.best_j, L)


@pytest.mark.parametrize("edge", ["row", "column", "origin"])
def test_model_on_border_best_cells(edge):
    L = 128
    t, _ = _degenerate(L)
    bi, bj = t.best_i.clone(), t.best_j.clone()
    if edge in ("row", "origin"):
        bi[::2] = 0
    if edge in ("column", "origin"):
        bj[1::2] = 0
    got, rounds = _hold(t.bp, bi, bj, L)
    still = ((bi == 0) | (bj == 0)).numpy()
    assert (got.n_steps[still] == 0).all() and (rounds[still] == 0).all()


def test_model_on_arbitrary_words():
    """Random 32-bit words: from-cells anywhere below 4096 (px >= L, px +
    py > 2L - 2: direct loads), -1 words, runs with bit 31, the move cap."""
    L = 128
    rng = np.random.default_rng(1313)
    B = 12
    bp = rng.integers(-2**31, 2**31, (B, 2 * L - 1, L)).astype(np.int32)
    bp[:3] = -1
    bp[3:6] %= 1 << 24  # gap moves only
    bi = rng.integers(0, L, B).astype(np.int32)
    bj = rng.integers(0, L, B).astype(np.int32)
    got, _ = _hold(bp, bi, bj, L)
    assert int(got.n_steps.max()) == 2 * L - 1


# ---------------------------------------------------------------------
# crafted words


def _word(run=0, matches=0, frm=(0, 0)):
    """A bp word: a run of `run` with `matches` identities, or (run 0) a
    gap move to the from-cell `frm`."""
    w = (matches << 28) | (run << 24) | (frm[0] * PACK + frm[1])
    return np.int32(w - (1 << 32) if w >= 1 << 31 else w)


def _blank(L, B=1):
    """bp of B pairs whose every word is a gap move to the origin."""
    return np.zeros((B, 2 * L - 1, L), np.int32)


def _put(bp, b, i, j, w):
    bp[b, i + j, i] = w


def _greedy_rounds(ds, R):
    """Rounds of cells on one diagonal offset, at antidiagonals ds in walk
    order: a band holds R rows from its anchor down."""
    n, s0 = 0, None
    for d in ds:
        if s0 is None or not 0 <= s0 - d < R:
            n, s0 = n + 1, d
    return n


@pytest.mark.parametrize("L", [128, 3072])
def test_runs_cross_the_band_edge(L):
    """A chain of 15-runs along the main diagonal from (L - 1, L - 1):
    each move goes down 30 antidiagonals, so the walk leaves band after
    band by its lower edge."""
    W, G, R, _, _ = _band(L, CRAFT)
    L0 = 2 * R if L == 3072 else L  # a short stretch of the long bucket
    bp = _blank(L)
    p = L - 1
    ds = []
    while p > 15:
        _put(bp, 0, p, p, _word(15, 15))
        ds.append(2 * p)
        p -= 15
        if L - 1 - p > L0:
            break
    ds.append(2 * p)  # a gap to the origin from the last cell
    got, rounds = _hold(bp, [L - 1], [L - 1], L, CRAFT)
    assert rounds[0] == _greedy_rounds(ds, R) > 1
    assert got.identities[0] == 15 * (len(ds) - 1)


def test_gap_within_the_band_and_gaps_leaving_it():
    """Gaps of one base keep the walk in the band while its offset stays
    within G of the anchor's; one more leaves it; a long gap leaves it
    at once."""
    L = 256
    W, G, R, _, _ = _band(L, CRAFT)
    bp = _blank(L, 3)
    # pair 0: G gaps of one in x, each then a run: all in one band
    # pair 1: G + 1 such gaps: the last one's cell is a new round
    for b, gaps in ((0, G), (1, G + 1)):
        x, y = 200, 200
        for _ in range(gaps):
            _put(bp, b, x, y, _word(frm=(x - 1, y)))
            x -= 1
            _put(bp, b, x, y, _word(2, 1))
            x, y = x - 2, y - 2
        _put(bp, b, x, y, _word(frm=(0, 0)))
    # pair 2: a gap of 40 in y, then runs on the new offset
    _put(bp, 2, 200, 200, _word(frm=(200, 160)))
    _put(bp, 2, 200, 160, _word(5, 5))
    got, rounds = _hold(bp, [200] * 3, [200] * 3, L, CRAFT)
    assert list(rounds) == [1, 2, 2]
    assert list(got.igaps) == [G + 1, G + 2, 2]


def test_direct_loads_of_cells_no_band_holds():
    """px >= L (an address aliasing a cell of another antidiagonal) and
    px + py > 2L - 2 (past the pair's words: the clamped last word) are
    read directly; each is a round trip of its own."""
    L = 128
    W, G, R, _, _ = _band(L, CRAFT)
    bp = _blank(L, 3)
    # pair 0: best cell (L + 5, 3), whose address is cell (5, L + 4)'s;
    # then a band round at (40, 30) serves the run's cell (37, 27)
    _put(bp, 0, 5, L + 4, _word(frm=(40, 30)))
    _put(bp, 0, 40, 30, _word(3, 2))
    # pair 1: best cell (L - 1, L), past 2L - 2: the pair's last word;
    # then a round at (L - 1, 50) and a from-cell with px >= L
    bp[1, -1, -1] = _word(frm=(L - 1, 50))
    _put(bp, 1, L - 1, 50, _word(frm=(L + 5, 3)))
    # pair 2: from a round at (60, 60) to (L + 10, 20), whose address is
    # cell (10, L + 21)'s, back into the band at (30, 30), then a run
    _put(bp, 2, 60, 60, _word(frm=(L + 10, 20)))
    _put(bp, 2, 10, L + 21, _word(frm=(30, 30)))
    _put(bp, 2, 30, 30, _word(4, 4))
    got, rounds = _hold(bp, [L + 5, L - 1, 60], [3, L, 60], L, CRAFT)
    assert list(rounds) == [2, 3, 2 + (120 - 52 >= R)]
    assert list(got.n_steps) == [3, 3, 4]


def test_run_onto_minus_one_entry():
    """A run of r at (r, r - 1) lands on (0, -1): its chain entry is -1,
    which n_steps does not count."""
    L = 128
    bp = _blank(L)
    _put(bp, 0, 20, 19, _word(15, 9))
    _put(bp, 0, 5, 4, _word(5, 5))
    got, rounds = _hold(bp, [20], [19], L, CRAFT)
    assert got.chain[0, 2] == -1 and got.n_steps[0] == 1
    assert got.length[0] == 20 and rounds[0] == 1


def test_move_cap_mid_round():
    """A word that points to its own cell (a gap of 0), and two cells
    that point to each other: the walk stays in one band until the 2L - 1
    move cap stops it."""
    L = 256
    bp = _blank(L, 2)
    _put(bp, 0, 90, 70, _word(frm=(90, 70)))
    _put(bp, 1, 90, 70, _word(frm=(89, 70)))
    _put(bp, 1, 89, 70, _word(frm=(90, 70)))
    got, rounds = _hold(bp, [90, 90], [70, 70], L, CRAFT)
    assert list(got.n_steps) == [2 * L - 1] * 2
    assert list(rounds) == [1, 1]


class _SparseBatch:
    """The flat bp words of a batch of B pairs of which only some are
    held: reading any other pair's word raises."""

    def __init__(self, pairs: dict, L: int):
        self.pairs, self.words = pairs, (2 * L - 1) * L

    def __getitem__(self, at):
        if isinstance(at, slice):
            b, o = divmod(at.start, self.words)
            assert (at.stop - 1) // self.words == b
            return self.pairs[b][o:o + at.stop - at.start]
        b, o = divmod(int(at), self.words)
        return self.pairs[b][o]


def test_offsets_past_2_31_words():
    """3072 / 272: the last pairs' words lie past 2^31 of the batch; the
    model's 64-bit offsets (the kernel's) read each pair's own words."""
    L, B = 3072, 272
    bp, bi, bj = _forward(L)
    words = (2 * L - 1) * L
    assert (B - 1) * words > 2**32
    held = {b: bp[k % len(bp)].reshape(-1) for k, b in
            enumerate((0, 100, B - 1))}
    big_i = np.resize(bi, B)
    big_j = np.resize(bj, B)
    for k, b in enumerate((0, 100, B - 1)):
        big_i[b], big_j[b] = bi[k % len(bp)], bj[k % len(bp)]
    got, rounds, top = kernel_model(_SparseBatch(held, L), big_i, big_j, L,
                                    pairs=(0, 100, B - 1))
    assert top > 2**32
    want = [k % len(bp) for k in range(3)]
    plain = ttb.traceback_batch(torch.as_tensor(bp[want]),
                                torch.as_tensor(bi[want]),
                                torch.as_tensor(bj[want]), max_len=L)
    _assert_equal(got, plain)
    np.testing.assert_array_equal(rounds,
                                  chip_smoke.tile_rounds(got.chain, L))


# ---------------------------------------------------------------------
# the band's geometry and the launcher


@pytest.mark.parametrize("L", nw_cuda.LENGTHS)
def test_band_rows_hold_the_reachable_cells_near_the_offset(L):
    """Each row's [lo, hi] is exactly the cells 1 <= i <= min(L - 1, d - 1)
    within G of the offset c0, and its aligned segments fit the row's
    words in shared memory."""
    W, G, R, segs, stride = _band(L)
    rng = np.random.default_rng(L)
    for _ in range(200):
        d = int(rng.integers(2, 2 * L - 1))
        c0 = int(rng.integers(-L, L))
        lo, hi = row_range(d, c0, L, G)
        want = [i for i in range(1, min(L - 1, d - 1) + 1)
                if abs(2 * i - d - c0) <= G]
        assert list(range(lo, hi + 1)) == want
        if want:  # the row's segments: from base, in the pair's words
            a = row_base(d, c0, G)
            assert a % 4 == 0 and a <= lo and hi - a < stride
            assert d * L + a >= L and hi <= L - 1


def test_band_constants_reach_nvcc():
    """Every bucket has a band, passed to nvcc, that fits a one-warp
    block's 48 KB of shared memory."""
    assert sorted(nw_cuda.TRACEBACK_BAND) == sorted(nw_cuda.LENGTHS)
    for L in nw_cuda.LENGTHS:
        W, G, R, segs, stride = _band(L)
        assert f"-DTB_W{L}={W}" in nw_cuda.NVCC_FLAGS
        assert f"-DTB_G{L}={G}" in nw_cuda.NVCC_FLAGS
        assert W == 0 or W >= 16 and W & (W - 1) == 0
        assert 1 <= G <= 4 and stride == 8
        assert R * stride * 4 <= 48 * 1024


def test_launch_traceback_refuses_misaligned_bp():
    """The band's rows copy as 16-byte segments: bp must be 16-byte
    aligned, checked before anything reaches the card."""
    L, B = 128, 4
    flat = torch.zeros(B * (2 * L - 1) * L + 1, dtype=torch.int32)
    bp = flat[1:].view(B, 2 * L - 1, L)
    best = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="aligned"):
        nw_cuda.launch_traceback(bp, best, best, max_len=L)


def test_tile_rounds_of_chains_without_moves():
    L = 128
    chain = np.full((3, 2 * L), -1, np.int32)
    chain[:, 0] = (0, 5 * PACK, 7)
    assert list(chip_smoke.tile_rounds(chain, L)) == [0, 0, 0]
