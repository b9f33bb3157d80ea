"""The extension gate's CUDA kernel (csrc/gate.cu) and its wrapper
(ops/gate_cuda.py), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it to the
plain version bit for bit.  Here its algorithm is written out in numpy,
one candidate at a time (``scalar_extend``: 16 bases a load pair, one
match bit a base, 8 bases a step of the step table, the per-base loop in
the group where the score can die or the walk's limit falls, early exit,
the watermark kept with >=), and held bit for bit against the JAX
package's extend_packed at the windows 64, 128, 256 and 3072, on real
k-mer hits, random candidates and the edge cases of the walks; the step
table against a brute-force prefix walk, and the group walk against the
per-base walk on random walks and at the groups' edges; the whole
launch is modelled (``model_gate``: the seg words' two prefix sums as
256-candidate block scans plus a carry, the index lookup, the walks and
the two ballots) and held against JAX's flat_gate_seg, flat_gate_packed
and flat_gate in every format and both index payloads.  The dispatchers
of ops/candidates.py take the plain version on CPU tensors (no launch
counted); the wrapper refuses other devices, and its launcher checks
every input before anything reaches the card.  Integer results: the
tolerance is exact equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsame_tpu.ops import candidates as jcand
from imsame_tpu.ops import extend_packed as jext
from imsame_tpu_torch.config import Config as TConfig
from imsame_tpu_torch.io.fasta import read_fasta as tread_fasta
from imsame_tpu_torch.ops import candidates as tcand
from imsame_tpu_torch.ops import gate_cuda, nw_cuda
from imsame_tpu_torch.pipeline import TorchEngine
from test_torch_gate import _real_candidates
from util_synth import make_pair

K, POINT = 12, 4
SEED = K * POINT
NEGI = -(1 << 30)
GROUP = 8  # bases a step of the kernel's step table
BLOCK = 256  # csrc/gate.cu kBlock: candidates a block of the seg scan


def _i32(x: int) -> int:
    """A Python int wrapped to int32, as torch's int32 arithmetic wraps."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


# ---------------------------------------------------------------------
# the kernel's algorithm, one candidate at a time


def _bases16(row, p: int) -> int:
    """Bases p .. p+15 of a packed row (uint32 words), base p + t at bits
    2t; each word index clamped into the row (bases16)."""
    wp = len(row)
    wi = p >> 4  # floor, as the kernel's arithmetic shift
    lo = int(row[min(max(wi, 0), wp - 1)])
    hi = int(row[min(max(wi + 1, 0), wp - 1)])
    return ((hi << 32 | lo) >> (2 * (p & 15))) & 0xFFFFFFFF


def _match_bits(q: int, d: int) -> int:
    """Bit t set where base t of two 16-base groups is equal: the equal
    2-bit codes' bits 2t, compacted as the kernel compacts them."""
    m = ~(q ^ d) & 0xFFFFFFFF
    m &= (m >> 1) & 0x55555555
    m = (m | (m >> 1)) & 0x33333333
    m = (m | (m >> 2)) & 0x0F0F0F0F
    m = (m | (m >> 4)) & 0x00FF00FF
    return (m | (m >> 8)) & 0xFFFF


def _brev(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def _step_table() -> np.ndarray:
    """The kernel's 256-entry step table (step_entry) as uint32 words.  In
    entry g, base t of a group of 8 steps +1 where bit t of g is set, -1
    otherwise; P_t is the prefix after base t.  Bytes 0-2 are 4 * P_7,
    4 * max P_t and 4 * min P_t as int8; byte 3 is the last t with P_t at
    the maximum."""
    g = np.arange(256)[:, None]
    P = np.cumsum(np.where((g >> np.arange(GROUP)) & 1, 1, -1), axis=1)
    hi, lo = P.max(axis=1), P.min(axis=1)
    last = GROUP - 1 - np.argmax(P[:, ::-1] == hi[:, None], axis=1)
    byte = lambda x: (POINT * x) & 0xFF  # noqa: E731
    return (byte(P[:, -1]) | byte(hi) << 8 | byte(lo) << 16
            | last << 24).astype(np.uint32)


STEPS = _step_table()


def _entry(g: int):
    """(4 * P_7, 4 * max P_t, 4 * min P_t, last t at the maximum) of step
    table entry g, unpacked as the kernel unpacks it."""
    e = int(STEPS[g])
    i8 = lambda b: b - 256 if b & 0x80 else b  # noqa: E731
    return i8(e & 0xFF), i8(e >> 8 & 0xFF), i8(e >> 16 & 0xFF), e >> 24


def _masks(qrow, drow, q, d, lim, backward):
    """The 16-bit match masks of a walk over o = 0 .. lim, one a load pair:
    o = o0 + k at bit k of mask o0 / 16.  The forward walk compares (q + o,
    d + o), the backward one (q - o, d - o), reversed by __brev."""
    out = []
    for o0 in range(0, lim + 1, 16):
        if backward:
            m = _brev(_match_bits(_bases16(qrow, q - o0 - 15),
                                  _bases16(drow, d - o0 - 15))) >> 16
        else:
            m = _match_bits(_bases16(qrow, q + o0), _bases16(drow, d + o0))
        out.append(m)
    return out


def _walk_per_base(masks, lim, S):
    """(M, best, idents, died) of a walk over o = 0 .. lim from score S,
    one base at a time: the plain walk's semantics."""
    M, best, idents = NEGI, -1, 0
    for o in range(lim + 1):
        hit = (masks[o >> 4] >> (o & 15)) & 1
        S += POINT if hit else -POINT
        idents += hit
        if S >= M:  # >=: the last o that reaches the watermark
            M, best = S, o
        if S <= 0:
            return M, best, idents, True
    return M, best, idents, False


def _walk_groups(masks, lim, S):
    """The same walk as the kernel takes it, 8 bases a step: a group
    within lim whose lowest prefix leaves the score above 0 is one step
    of the table; the group where the score can die, or where lim falls,
    goes base by base."""
    M, best, idents = NEGI, -1, 0
    for g0 in range(0, lim + 1, GROUP):
        g = (masks[g0 >> 4] >> (g0 & 15)) & 0xFF
        p7, hi, lo, last = _entry(g)
        if g0 + GROUP - 1 <= lim and S + lo > 0:
            idents += bin(g).count("1")
            if S + hi >= M:
                M, best = S + hi, g0 + last
            S += p7
            continue
        for t in range(min(GROUP, lim - g0 + 1)):
            hit = (g >> t) & 1
            S += POINT if hit else -POINT
            idents += hit
            if S >= M:
                M, best = S, g0 + t
            if S <= 0:
                return M, best, idents, True
    return M, best, idents, False


def _walk(qrow, drow, q, d, lim, S, backward):
    """(M, best, idents, died) of one walk over o = 0 .. lim, as the
    kernel walks it."""
    return _walk_groups(_masks(qrow, drow, q, d, lim, backward), lim, S)


def scalar_extend(qrow, drow, qoff, doff, qlen, dlen, thr, W):
    """(raw, pass, t_len, idents, exact) of one candidate, as one thread
    of the kernel computes them."""
    flim = _i32(min(dlen - 1 - doff, qlen - 1 - qoff))
    fM, fbest, fid, fdied = _walk(qrow, drow, qoff, doff, min(flim, W - 1),
                                  SEED, False)
    end_row = doff + fbest if fM >= SEED else doff - 1
    blim = _i32(min(doff, qoff) - (K + 1))
    bM, bbest, bid, bdied = _walk(qrow, drow, qoff - K - 1, doff - K - 1,
                                  min(blim, W - 1), max(fM, SEED), True)
    start_row = (doff - K - 1) - bbest if bM >= SEED else doff - K
    idents = K + fid + bid
    t_len = _i32(end_row - start_row)
    raw = _i32((2 * idents - t_len) * POINT)
    exact = (flim < W or fdied) and (blim < W or bdied)
    return raw, raw >= thr, t_len, idents, exact


def model_gate(qp, dp, qlen, dlen, idx_tab, cand, thr, rtab=None,
               rbase=None, *, window):
    """One launch of the kernel over a chunk (numpy arrays; uint32 rows):
    the [2, N/32] int32 words."""
    cand = np.asarray(cand)
    if cand.ndim == 1:  # seg words: block scans plus the blocks' carry
        w = cand.view(np.uint32).astype(np.int64)
        fields = np.stack([w >> 31, (w >> 25) & 63], axis=1)
        N = len(w)
        nb = -(-N // BLOCK)
        pad = np.zeros((nb * BLOCK, 2), np.int64)
        pad[:N] = fields
        tiles = pad.reshape(nb, BLOCK, 2)
        tot = tiles.sum(axis=1)
        carry = np.cumsum(tot, axis=0) - tot  # exclusive
        incl = (np.cumsum(tiles, axis=1) + carry[:, None, :]).reshape(-1, 2)
        rix = np.clip(incl[:N, 0] - 1, 0, len(rtab) - 1)
        r = np.asarray(rtab)[rix]
        qoff = [_i32(int(b) + int(q % (1 << 32)))
                for b, q in zip(np.asarray(rbase)[rix], incl[:N, 1])]
        hit = w & 0x1FFFFFF
    elif cand.shape[0] == 2:
        N = cand.shape[1]
        hit = cand[0]
        rq = cand[1].view(np.uint32)
        r, qoff = rq >> 12, rq & 0xFFF
    else:
        N = cand.shape[1]
        hit, r, qoff = cand
    out = np.zeros((2, N // 32), np.int64)
    for i in range(N):
        ri = min(max(int(r[i]), 0), len(qp) - 1)
        if isinstance(idx_tab, tuple):
            pos, sid, db_start = idx_tab
            h = min(max(int(hit[i]), 0), len(pos) - 1)
            s = min(max(int(sid[h]), 0), len(dp) - 1)
            doff = _i32(int(pos[h]) - int(db_start[s]))
        else:
            h = min(max(int(hit[i]), 0), len(idx_tab) - 1)
            word = int(np.asarray(idx_tab)[h]) & 0xFFFFFFFF
            s, doff = min(word >> 12, len(dp) - 1), word & 0xFFF
        _, ok, _, _, exact = scalar_extend(
            qp[ri], dp[s], int(qoff[i]), doff, int(qlen[ri]), int(dlen[s]),
            int(thr[ri]), window)
        out[0, i // 32] |= int(ok) << (i % 32)
        out[1, i // 32] |= int(exact) << (i % 32)
    return out.astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------
# inputs


def _pack(reads, row_len):
    """Code arrays -> (uint32 rows [n, row_len/16], lengths int32)."""
    lens = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads).astype(np.uint8)
    start = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return jext.pack_read_rows(codes, start, lens, row_len), \
        lens.astype(np.int32)


def _edge_cases(W):
    """Reads and candidates (r = s = case) whose walks reach the edges:
    (q codes, db codes, qoff, doff).  Rows are W + 256 bases long, so a
    walk can outlive the window."""
    rng = np.random.default_rng(W)
    R = W + 256

    def pair(pattern, n=R):
        """A db read equal to the query where pattern[o] (from base 0)."""
        q = rng.integers(0, 4, n, dtype=np.uint8)
        d = np.where(pattern[:n], q, (q + 1) % 4).astype(np.uint8)
        return q, d

    cases = []
    # the forward walk dies exactly at o = W - 1: 11 mismatches (S = 4),
    # then match / mismatch in turn, and a mismatch at W - 1
    pat = np.ones(R, bool)
    pat[:11] = False
    pat[11:W - 1] = np.arange(11, W - 1) % 2 == 1
    pat[W - 1] = False
    cases.append((*pair(pat), 0, 0))
    # ... and once more one base later: alive at W (inexact)
    pat2 = pat.copy()
    pat2[W - 1] = True
    cases.append((*pair(pat2), 0, 0))
    # identical reads: both walks alive at W, or bounded by the reads
    same = pair(np.ones(R, bool))
    cases += [(*same, 13, 13), (*same, W // 2, W // 2), (*same, R - 40, R - 40)]
    # ties for the watermark: match, mismatch in turn, then mismatches
    tie = np.zeros(R, bool)
    tie[20:60:2] = True
    tie[200:240:2] = True
    t = pair(tie)
    cases += [(*t, 20, 20), (*t, 200, 200), (*t, 261, 261), (*t, 60, 60)]
    # qoff at 13 (the backward walk takes one base), at the read's end
    # (flim = -1) and at the row's end; doff past its read (flim < 0);
    # qoff < 13 (blim < 0); offsets on other diagonals
    q, d = pair(np.ones(R, bool))
    cases += [(q, d, 13, 40), (q, d, R, 30), (q[:R - 7], d, R - 7, 50),
              (q, d[:100], 20, 100), (q, d[:100], 20, 120), (q, d, 5, 5),
              (q, d, 30, 12), (q, d, 0, 0)]
    return cases


def _extend_inputs(W):
    """(qp, dp, r, s, qoff, doff, qlen[r], dlen[s], thr) for the scalar
    walk and JAX's extend_packed: real k-mer hits between util_synth reads
    (mutated copies and random reads), random candidates on the same rows
    and the edge cases, on rows of max(W, 256) bases (W + 256 for the edge
    cases, in a table of their own)."""
    rl = max(W, 256)
    args = _real_candidates(W + 1, rl)
    rng = np.random.default_rng(W)
    n = len(args[2])
    keep = np.sort(rng.choice(n, min(n, 400), replace=False))
    real = [a if a.ndim == 2 else a[keep] for a in args]
    qp, dp = real[0], real[1]
    qlens, dlens = _lens_of(args)
    # random candidates on the same rows: any read pair, offsets from 0 to
    # one past the read (every bound, and no seed)
    m = 200
    r = rng.integers(0, len(qp), m)
    s = rng.integers(0, len(dp), m)
    qoff = rng.integers(0, qlens[r] + 2)
    doff = rng.integers(0, dlens[s] + 2)
    thr = rng.integers(-50, 120, m)
    rand = [qp, dp, r, s, qoff, doff, qlens[r], dlens[s], thr]
    cases = _edge_cases(W)
    eq, qlen_e = _pack([c[0] for c in cases], W + 256)
    ed, dlen_e = _pack([c[1] for c in cases], W + 256)
    ids = np.arange(len(cases))
    edge = [eq, ed, ids, ids, np.array([c[2] for c in cases]),
            np.array([c[3] for c in cases]), qlen_e, dlen_e,
            np.full(len(cases), 60)]
    return [[a if a.dtype == np.uint32 else np.asarray(a, np.int32)
             for a in part] for part in (real, rand, edge)]


def _lens_of(args):
    """Per-row read lengths of _real_candidates' tables, from its
    candidate columns (every read of either side has a candidate)."""
    qp, dp, r, s = args[0], args[1], args[2], args[3]
    qlens = np.zeros(len(qp), np.int64)
    dlens = np.zeros(len(dp), np.int64)
    qlens[r] = args[6]
    dlens[s] = args[7]
    return qlens, dlens


@pytest.mark.parametrize("W", [64, 128, 256, 3072])
def test_scalar_walk_matches_jax_extend_packed(W):
    for part, what in zip(_extend_inputs(W), ("real", "random", "edge")):
        qp, dp, r, s, qoff, doff, qlen, dlen, thr = part
        want = jext.extend_packed(*[jnp.asarray(a) for a in part], W=W)
        got = np.array([
            scalar_extend(qp[r[i]], dp[s[i]], int(qoff[i]), int(doff[i]),
                          int(qlen[i]), int(dlen[i]), int(thr[i]), W)
            for i in range(len(r))
        ], np.int64)
        for k, f in enumerate(("raw", "passes", "t_len", "idents", "exact")):
            np.testing.assert_array_equal(
                got[:, k], np.asarray(getattr(want, f)).astype(np.int64),
                err_msg=f"{what} {f}")
        passes = np.asarray(want.passes)
        exact = np.asarray(want.exact)
        if what != "random":  # both verdicts, both exactness values
            assert passes.any() and not passes.all(), what
        if what == "edge":
            assert exact.any() and not exact.all()


def test_edge_cases_reach_their_edges():
    """The edge cases walk where their comments say, at W = 64."""
    W = 64
    qp, dp, r, s, qoff, doff, qlen, dlen, thr = _extend_inputs(W)[2]
    res = jext.extend_packed(*map(jnp.asarray, (qp, dp, r, s, qoff, doff,
                                                 qlen, dlen, thr)), W=W)
    exact = np.asarray(res.exact)
    assert exact[0] and not exact[1]  # dies at W - 1; alive at W
    M, best, _, died = _walk(qp[0], dp[0], 0, 0, W - 1, SEED, False)
    assert died and best < W - 1
    _, _, _, died = _walk(qp[1], dp[1], 0, 0, W - 1, SEED, False)
    assert not died
    # a tie walk: the watermark's last o, not its first
    M, best, _, _ = _walk(qp[5], dp[5], 20, 20, W - 1, SEED, False)
    assert (M, best) == (SEED + POINT, 38)


def test_step_table_matches_prefix_walk():
    """Every entry of the step table against a brute-force prefix walk of
    its 8 bases."""
    for g in range(256):
        P, hi, lo, last = 0, None, None, None
        for t in range(GROUP):
            P += 1 if g >> t & 1 else -1
            if hi is None or P >= hi:
                hi, last = P, t
            lo = P if lo is None else min(lo, P)
        assert _entry(g) == (POINT * P, POINT * hi, POINT * lo, last), g


def test_group_walk_matches_per_base_walk():
    """The group walk gives the per-base walk's (M, best, idents, died) on
    random walks: 1-300 bases at match rates 0.3-0.95, limits -1 .. n-1,
    start scores 4-160 (multiples of 4, as every walk's)."""
    rng = np.random.default_rng(8)
    for _ in range(20000):
        n = int(rng.integers(1, 301))
        bits = rng.random(n) < rng.uniform(0.3, 0.95)
        masks = [int(np.dot(b, 1 << np.arange(len(b))))
                 for b in np.split(bits, range(16, n, 16))]
        lim = int(rng.integers(-1, n))
        S = POINT * int(rng.integers(1, 41))
        assert _walk_groups(masks, lim, S) == _walk_per_base(masks, lim, S), \
            (bits.astype(int).tolist(), lim, S)


def _runs(*parts):
    """A match pattern from (value, count) runs."""
    return np.concatenate([np.full(n, bool(v)) for v, n in parts])


# Candidates whose walks reach a group's edges: (qoff, doff, qlen, dlen,
# forward pattern, backward pattern, claims).  Pattern o is the match of
# the walk's base o (forward: qoff + o, doff + o; backward: qoff - 13 - o,
# doff - 13 - o); past a pattern every base mismatches.  A claim is
# (walk, "dies", o): the walk dies at o; (walk, "best", o): its watermark's
# last o; (walk, "alive", lim): it outlives its limit.  The forward walk's
# score at a group start is 48 + 4 * (an even count), so it cannot die on
# a group's first base; the backward walk, seeded with the forward
# watermark, can.
GROUP_EDGES = {
    # backward seed 52 (s = 13); 2 matches, 14 mismatches: s = 1 at o = 16
    "death_first_base": (40, 40, 200, 200, _runs((1, 1)),
                         _runs((1, 2), (0, 14)), [("b", "dies", 16)]),
    # s = 2 at o = 16, then a prefix reaching -2 on the group's last base
    "death_last_base": (30, 30, 200, 200,
                        np.concatenate([_runs((1, 3), (0, 13)),
                                        np.array([1, 0, 1, 0, 1, 0, 0, 0],
                                                 bool)]),
                        _runs((1, 30)), [("f", "dies", 23)]),
    # both limits inside a group: flim = blim = 21, every base a match
    "lim_in_group": (34, 34, 56, 56, _runs((1, 60)), _runs((1, 60)),
                     [("f", "alive", 21), ("b", "alive", 21)]),
    # death in the group where the forward limit (37) falls, before it
    "lim_and_death_in_group": (30, 30, 68, 68,
                               _runs((1, 11), (0, 21)),
                               _runs((1, 5)), [("f", "dies", 33)]),
    # match / mismatch in turn: the watermark's ties inside one group
    "ties_in_group": (30, 30, 200, 200, np.tile([True, False], 4),
                      np.tile([True, False], 6), [("f", "best", 6),
                                                  ("b", "best", 10)]),
    # the watermark reached in group 0 and reached again in group 1
    "ties_across_groups": (30, 30, 200, 200,
                           _runs((1, 3), (0, 5), (1, 5)),
                           _runs((1, 2), (0, 6), (1, 6)),
                           [("f", "best", 12), ("b", "best", 13)]),
    # s = 8 at o = 16; the group's lowest prefix is -7: no death, one step
    "s8_no_death": (30, 30, 200, 200,
                    _runs((1, 6), (0, 10), (0, 7), (1, 1)), _runs((1, 20)),
                    [("f", "dies", 25)]),
    # s = 8 at o = 16 and 8 mismatches: death on the group's last base
    "s8_death": (30, 30, 200, 200, _runs((1, 6), (0, 10), (0, 8)),
                 _runs((1, 20)), [("f", "dies", 23)]),
    # backward walks over word boundaries (bases 31/32, 15/16) to the
    # read's first base, on two diagonals; blim = 37 inside a group
    "backward_across_words": (50, 50, 200, 200, _runs((1, 1)),
                              _runs((1, 10), (0, 3), (1, 30)),
                              [("b", "alive", 37)]),
    "backward_other_diagonal": (50, 61, 200, 200, _runs((1, 1)),
                                _runs((1, 7), (0, 2), (1, 40)),
                                [("b", "alive", 37)]),
}


def _edge_candidate(case, row_len=256):
    """(qp, dp, qoff, doff, qlen, dlen) of one GROUP_EDGES case: the
    patterns laid on random reads (the seed's 12 bases match)."""
    qoff, doff, qlen, dlen, fwd, bwd, _ = GROUP_EDGES[case]
    rng = np.random.default_rng(len(case))
    q = rng.integers(0, 4, qlen, dtype=np.uint8)
    d = rng.integers(0, 4, dlen, dtype=np.uint8)
    for o in range(-12, 0):
        d[doff + o] = q[qoff + o]
    for pat, sign, q0, d0 in ((fwd, 1, qoff, doff),
                              (bwd, -1, qoff - K - 1, doff - K - 1)):
        o = 0
        while 0 <= q0 + sign * o < qlen and 0 <= d0 + sign * o < dlen:
            qi, di = q0 + sign * o, d0 + sign * o
            hit = o < len(pat) and pat[o]
            d[di] = q[qi] if hit else (q[qi] + 1) % 4
            o += 1
    qp, ql = _pack([q], row_len)
    dp, dl = _pack([d], row_len)
    return qp, dp, qoff, doff, int(ql[0]), int(dl[0])


@pytest.mark.parametrize("W", [64, 256])
@pytest.mark.parametrize("case", sorted(GROUP_EDGES))
def test_group_edges_match_per_base_and_jax(case, W):
    """Walks that die on a group's first or last base, limits inside a
    group, watermark ties inside and across groups, groups started at
    s <= 8 with and without death, backward walks across row words: the
    group walk equals the per-base walk, the candidate equals JAX's
    extend_packed, and each case reaches the edge it names."""
    qp, dp, qoff, doff, qlen, dlen = _edge_candidate(case)
    flim = min(dlen - 1 - doff, qlen - 1 - qoff, W - 1)
    blim = min(min(doff, qoff) - K - 1, W - 1)
    fw = (qoff, doff, flim, False)
    fM = _walk_per_base(_masks(qp[0], dp[0], *fw), flim, SEED)[0]
    walks = {"f": fw + (SEED,),
             "b": (qoff - K - 1, doff - K - 1, blim, True, max(fM, SEED))}
    for q, d, lim, back, S in walks.values():
        masks = _masks(qp[0], dp[0], q, d, lim, back)
        assert _walk_groups(masks, lim, S) == _walk_per_base(masks, lim, S)
    for which, what, o in GROUP_EDGES[case][6]:
        q, d, lim, back, S = walks[which]
        run = lambda n: _walk(qp[0], dp[0], q, d, n, S, back)  # noqa: E731
        if what == "dies":
            assert run(o)[3] and not run(o - 1)[3], (which, what)
        elif what == "best":
            assert run(lim)[1] == o, (which, what)
        else:
            assert lim == o and not run(lim)[3], (which, what)
    thr = 60
    got = scalar_extend(qp[0], dp[0], qoff, doff, qlen, dlen, thr, W)
    one = lambda x: jnp.asarray(np.array([x], np.int32))  # noqa: E731
    want = jext.extend_packed(jnp.asarray(qp), jnp.asarray(dp), one(0),
                              one(0), one(qoff), one(doff), one(qlen),
                              one(dlen), one(thr), W=W)
    assert got == tuple(int(np.asarray(getattr(want, f))[0]) for f in (
        "raw", "passes", "t_len", "idents", "exact")), case


# ---------------------------------------------------------------------
# a chunk in every format


def _chunk(seed, W):
    """Rows of max(W, 256) bases, packed index words with their wide
    triple, per-read thresholds and a stream-ordered candidate list of
    N = 300 (padded to 320): diagonal hits on identical row pairs (walks
    that pass, and past a small window escape it), random hits, hits past
    the table's end, and qoff deltas that overflow the seg words' 6 bits."""
    rng = np.random.default_rng(seed)
    L = max(W, 256)
    n_q, n_db, n_idx = 40, 40, 300
    qp = rng.integers(0, 2**32, (n_q, L // 16), dtype=np.uint32)
    dp = rng.integers(0, 2**32, (n_db, L // 16), dtype=np.uint32)
    dp[:12] = qp[:12]
    qlen = rng.integers(L * 2 // 5, L - 5, n_q).astype(np.int32)
    dlen = rng.integers(L * 2 // 5, L - 5, n_db).astype(np.int32)
    dlen[:12] = qlen[:12]
    sid = rng.integers(0, n_db, n_idx).astype(np.uint32)
    doff = rng.integers(12, L * 2 // 5, n_idx).astype(np.uint32)
    N, size = 300, 320
    rids = np.sort(rng.integers(0, n_q, N)).astype(np.int32)
    qoffs = np.empty(N, np.int32)
    for r in np.unique(rids):
        m = rids == r
        qoffs[m] = np.sort(rng.integers(12, int(qlen[r]), int(m.sum())))
    hits = rng.integers(0, n_idx, N).astype(np.int32)
    diag = np.flatnonzero(rids < 12)[::2]
    hits[diag] = np.arange(len(diag))
    sid[:len(diag)] = rids[diag]
    doff[:len(diag)] = qoffs[diag]
    hits[-5:] = n_idx + np.arange(5) * 1000  # past the table's end
    words = ((sid << np.uint32(12)) | doff).view(np.int32)
    db_start = np.zeros(n_db, np.int32)
    np.cumsum(dlen[:-1], out=db_start[1:])
    triple = (db_start[sid] + doff.astype(np.int32), sid.view(np.int32),
              db_start)
    thr = rng.integers(-50, 200, n_q).astype(np.int32)
    thr[:12] = 60
    return (qp, dp, qlen, dlen), words, triple, thr, (rids, qoffs, hits), N, size


def _formats(rids, qoffs, hits, N, size):
    """The chunk in each format: {"seg": (cand, rtab, rbase), "two_words":
    (cand,), "three_words": (cand,)}; padding entries are zero."""
    seg = tcand.encode_seg_chunk(rids, qoffs, hits, size)
    two = np.zeros((2, size), np.int32)
    two[0, :N] = hits
    two[1, :N] = ((rids.astype(np.uint32) << np.uint32(12))
                  | qoffs.astype(np.uint32)).view(np.int32)
    three = np.zeros((3, size), np.int32)
    three[0, :N], three[1, :N], three[2, :N] = hits, rids, qoffs
    return {"seg": seg, "two_words": (two,), "three_words": (three,)}


def _jax_gate(fmt, rows, idx, cand, thr, N, window):
    """JAX's flat_gate_* of the chunk (its flat_gate takes the columns
    and masks the pass bits of padding)."""
    j_rows = [jnp.asarray(a) for a in rows]
    j_idx = (jnp.asarray(idx) if not isinstance(idx, tuple)
             else tuple(jnp.asarray(a) for a in idx))
    packed = not isinstance(idx, tuple)
    if fmt == "seg":
        c, rt, rb = cand
        return jcand.flat_gate_seg(
            *j_rows, j_idx, jnp.asarray(c), jnp.asarray(rt),
            jnp.asarray(rb), jnp.asarray(thr), window=window,
            packed_idx=packed)
    if fmt == "two_words":
        return jcand.flat_gate_packed(
            *j_rows, j_idx, jnp.asarray(cand[0]), jnp.asarray(thr),
            window=window, packed_idx=packed)
    hit, r, qoff = cand[0]
    return jcand.flat_gate(
        *j_rows, j_idx, jnp.asarray(r), jnp.asarray(hit), jnp.asarray(qoff),
        jnp.asarray(thr[r]), jnp.asarray(np.int32(N)), window=window,
        packed_idx=packed)


def _assert_words(got, want, N, fmt):
    """Equal words; JAX's three-word flat_gate zeroes the pass bits of
    padding, so there the first N bits of each row are compared."""
    got, want = np.asarray(got), np.asarray(want)
    if fmt != "three_words":
        np.testing.assert_array_equal(got, want)
        return
    bits = lambda w: np.unpackbits(  # noqa: E731
        np.ascontiguousarray(w, "<i4").view(np.uint8).reshape(2, -1),
        axis=1, bitorder="little")[:, :N]
    np.testing.assert_array_equal(bits(got), bits(want))


FORMATS = ["seg", "two_words", "three_words"]


@pytest.mark.parametrize("W", [64, 256, 3072])
@pytest.mark.parametrize("index", ["packed", "wide"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_model_matches_jax_gate(fmt, index, W):
    rows, words, triple, thr, cols, N, size = _chunk(17 + W, W)
    idx = words if index == "packed" else triple
    cand = _formats(*cols, N, size)[fmt]
    got = model_gate(*rows, idx, *cand[:1], thr, *cand[1:], window=W)
    _assert_words(got, _jax_gate(fmt, rows, idx, cand, thr, N, W), N, fmt)
    p = np.unpackbits(got[0].view(np.uint8))
    e = np.unpackbits(got[1].view(np.uint8))
    assert p.any() and not p.all() and e.any()
    if W == 64:
        assert not e.all()


@pytest.mark.parametrize("W", [64, 256, 3072])
@pytest.mark.parametrize("index", ["packed", "wide"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_dispatchers_match_plain_and_jax(fmt, index, W):
    """flat_gate_seg, flat_gate_packed and flat_gate on CPU tensors: the
    plain version (gate_plain, every word), and JAX's gate; no kernel
    launched."""
    rows, words, triple, thr, cols, N, size = _chunk(29 + W, W)
    idx = words if index == "packed" else triple
    cand = _formats(*cols, N, size)[fmt]
    t = lambda a: torch.as_tensor(  # noqa: E731
        a.view(np.int32) if a.dtype == np.uint32 else a)
    t_rows = [t(a) for a in rows]
    t_idx = t(idx) if index == "packed" else tuple(t(a) for a in idx)
    tc = [t(a) for a in cand]
    n = gate_cuda.gate.launches
    if fmt == "seg":
        got = tcand.flat_gate_seg(*t_rows, t_idx, *tc, t(thr), window=W)
    else:
        fn = tcand.flat_gate_packed if fmt == "two_words" else tcand.flat_gate
        got = fn(*t_rows, t_idx, tc[0], t(thr), window=W)
    plain = tcand.gate_plain(*t_rows, t_idx, tc[0], t(thr), *tc[1:],
                             window=W)
    assert gate_cuda.gate.launches == n
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    _assert_words(got, _jax_gate(fmt, rows, idx, cand, thr, N, W), N, fmt)


def _bases_walked(masks, lim, S):
    """Bases a walk over o = 0 .. lim compares: through its death, or
    to its limit."""
    for o in range(lim + 1):
        S += POINT if (masks[o >> 4] >> (o & 15)) & 1 else -POINT
        if S <= 0:
            return o + 1
    return max(lim + 1, 0)


def test_walk_lengths_and_lane_efficiency():
    """chip_smoke.py's walk_lengths counts the bases each of a chunk's
    walks compares (padding slots too), as the per-base walk does, and
    lane_efficiency counts 8-base steps over 32 lanes times each warp's
    longest forward plus longest backward walk."""
    import chip_smoke

    W = 64
    rows, words, _, thr, (rids, qoffs, hits), N, size = _chunk(3, W)
    qp, dp, qlen, dlen = rows
    r = np.zeros(size, np.int64)
    qoff = np.zeros(size, np.int64)
    hit = np.zeros(size, np.int64)
    r[:N], qoff[:N], hit[:N] = rids, qoffs, hits
    word = words.view(np.uint32)[np.clip(hit, 0, len(words) - 1)]
    s = np.minimum(word >> 12, len(dp) - 1).astype(np.int64)
    doff = (word & 0xFFF).astype(np.int64)
    want = []
    for ri, si, qo, do in zip(r.tolist(), s.tolist(), qoff.tolist(),
                              doff.tolist()):
        q, d = qp[ri], dp[si]
        flim = min(int(dlen[si]) - 1 - do, int(qlen[ri]) - 1 - qo, W - 1)
        blim = min(min(do, qo) - K - 1, W - 1)
        fm = _masks(q, d, qo, do, flim, False)
        bm = _masks(q, d, qo - K - 1, do - K - 1, blim, True)
        fM = _walk_per_base(fm, flim, SEED)[0]
        want.append((_bases_walked(fm, flim, SEED),
                     _bases_walked(bm, blim, max(fM, SEED))))
    t = lambda a: torch.as_tensor(  # noqa: E731
        a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))
    nf, nb = chip_smoke.walk_lengths(
        (t(qp), t(dp), t(qlen), t(dlen), t(thr)), t(r), t(s), t(qoff),
        t(doff), W)
    np.testing.assert_array_equal(np.stack([nf, nb], 1), np.array(want))
    assert nf.max() > 8 and (nb == 0).any()
    # two warps: 32 one-step lanes; one lane of 10 steps beside 31 idle
    nf = torch.tensor([8] * 32 + [0] * 31 + [80])
    nb = torch.tensor([1] * 32 + [9] + [0] * 31)
    assert chip_smoke.lane_efficiency(nf, nb) == (64 + 2 + 10) / (
        32 * (1 + 1) + 32 * (10 + 2))


# ---------------------------------------------------------------------
# the wrapper


def _cpu_inputs(fmt="two_words", index="packed", W=64):
    rows, words, triple, thr, cols, N, size = _chunk(5, W)
    idx = words if index == "packed" else triple
    cand = _formats(*cols, N, size)[fmt]
    t = lambda a: torch.as_tensor(  # noqa: E731
        a.view(np.int32) if a.dtype == np.uint32 else a)
    t_idx = t(idx) if index == "packed" else tuple(t(a) for a in idx)
    return dict(qp=t(rows[0]), dp=t(rows[1]), qlen=t(rows[2]),
                dlen=t(rows[3]), idx_tab=t_idx, cand=t(cand[0]),
                thr_tab=t(thr),
                **({"rtab": t(cand[1]), "rbase": t(cand[2])}
                   if fmt == "seg" else {}))


def test_gate_wrapper_refuses_other_devices():
    kw = {k: (v.to("meta") if isinstance(v, torch.Tensor)
              else tuple(x.to("meta") for x in v))
          for k, v in _cpu_inputs().items()}
    n = gate_cuda.gate.launches
    with pytest.raises(ValueError):
        gate_cuda.gate(**kw, window=64)
    assert gate_cuda.gate.launches == n


@pytest.mark.parametrize("bad", [
    "dtype", "qlen_shape", "thr_shape", "cand_rows", "contiguous",
    "n_mod_32", "empty", "window", "seg_without_rtab", "rtab_with_words",
    "wide_db_start", "empty_index", "device",
])
def test_launch_gate_validates_inputs(bad, monkeypatch):
    """The launcher's checks run before anything reaches the card: the
    library is never loaded."""
    def no_lib():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(nw_cuda, "_lib", no_lib)
    fmt = "seg" if bad == "seg_without_rtab" else "two_words"
    kw = _cpu_inputs(fmt, "wide" if bad == "wide_db_start" else "packed")
    W = 64
    if bad == "dtype":
        kw["qp"] = kw["qp"].long()
    elif bad == "qlen_shape":
        kw["qlen"] = kw["qlen"][:-1]
    elif bad == "thr_shape":
        kw["thr_tab"] = kw["thr_tab"][:, None]
    elif bad == "cand_rows":
        kw["cand"] = torch.cat([kw["cand"], kw["cand"]])
    elif bad == "contiguous":
        kw["cand"] = kw["cand"].t().contiguous().t()
    elif bad == "n_mod_32":
        kw["cand"] = kw["cand"][:, :40].contiguous()
    elif bad == "empty":
        kw["cand"] = kw["cand"][:, :0].contiguous()
    elif bad == "window":
        W = 24
    elif bad == "seg_without_rtab":
        del kw["rtab"]
    elif bad == "rtab_with_words":
        kw["rtab"] = kw["rbase"] = kw["thr_tab"]
    elif bad == "wide_db_start":
        pos, sid, db_start = kw["idx_tab"]
        kw["idx_tab"] = (pos, sid, db_start[:-1])
    elif bad == "empty_index":
        kw["idx_tab"] = kw["idx_tab"][:0]
    elif bad == "device":
        kw["dlen"] = kw["dlen"].to("meta")
    with pytest.raises(ValueError):
        gate_cuda.launch_gate(**kw, window=W)


@pytest.mark.parametrize("fmt", FORMATS)
def test_gate_wrapper_takes_plain_path_on_cpu(fmt):
    kw = _cpu_inputs(fmt, "wide" if fmt == "seg" else "packed")
    n = gate_cuda.gate.launches
    got = gate_cuda.gate(**kw, window=64)
    assert gate_cuda.gate.launches == n
    np.testing.assert_array_equal(
        got.numpy(), tcand.gate_plain(**kw, window=64).numpy())
    assert got.shape == (2, kw["cand"].shape[-1] // 32)


@pytest.mark.parametrize("path", ["seg", "enum", "mesh_data", "mesh_dict"])
def test_engine_gates_through_the_wrapper(tmp_path, monkeypatch, path):
    """The engine's host-built chunks, the device enumeration's chunks
    and the mesh steps all reach ops/gate_cuda.py gate (the kernel on the
    card), in the format each path ships; the results do not change."""
    calls = []
    real = gate_cuda.gate

    def spy(qp, dp, qlen, dlen, idx_tab, cand, *a, **k):
        calls.append(("seg" if cand.dim() == 1 else cand.shape[0],
                      tuple(qp.shape)))
        return real(qp, dp, qlen, dlen, idx_tab, cand, *a, **k)

    qp, dp = make_pair(tmp_path, random.Random(31), n_query=24, n_db=24,
                       read_len=120, sub_rate=0.05)
    q, db = tread_fasta(str(qp)), tread_fasta(str(dp))
    want = TorchEngine(db, TConfig(mesh_shape=None), device="cpu").compare(q)
    monkeypatch.setattr(gate_cuda, "gate", spy)
    kw = {"seg": dict(cfg=TConfig(mesh_shape=None)),
          "enum": dict(cfg=TConfig(mesh_shape=None, gate_enum=True)),
          "mesh_data": dict(cfg=TConfig(mesh_shape=(2, 1)),
                            mesh_devices=["cpu"] * 2),
          "mesh_dict": dict(cfg=TConfig(mesh_shape=(1, 2)),
                            mesh_devices=["cpu"] * 2)}[path]
    res = TorchEngine(db, kw.pop("cfg"), device="cpu", **kw).compare(q)
    assert res.pairs == want.pairs and res.accepted > 0
    formats = {f for f, _ in calls}
    if path == "enum":  # enumerated chunks: three words
        assert 3 in formats
    else:
        assert formats == {"seg": {"seg"}, "mesh_data": {2},
                           "mesh_dict": {2}}[path]
