"""The plain reference: its vectorised extension and aligner against the
cell-by-cell semantics, and its answers and records against the port's
CPU path on tiny seeded read sets at both extremes of the match
fraction."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import dense, judge, semantics

CFG = dict(min_e_value=1e-20, min_coverage=0.5, min_identity=0.5, igap=-5,
           egap=-2)


def _reads(rng, n, lo, hi):
    lens = rng.integers(lo, hi + 1, n)
    codes = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    return codes, (np.cumsum(lens) - lens).astype(np.int64)


def test_extension_matches_the_scalar_walk():
    rng = np.random.default_rng(5)
    qc, qs = _reads(rng, 40, 30, 200)
    dc = qc.copy()
    flip = rng.random(len(dc)) < 0.05
    dc[flip] = (dc[flip] + 1) % 4  # db = query with 5 % substitutions
    q, db = dense.Sample(qc, qs, "cpu"), dense.Sample(dc, qs, "cpu")
    reads = rng.integers(0, 40, 400)
    rs = torch.as_tensor(reads)
    off = torch.as_tensor(rng.integers(0, 10**6, 400)) % (q.lens[rs] - 11)
    qpos = q.start[rs] + off + 12
    shift = torch.as_tensor(rng.integers(-3, 4, 400))
    sid = rs
    dpos = (qpos + shift).clamp(db.start[sid] + 12, db.end[sid])
    raw = dense.raw_scores(q, db, rs, qpos, dpos, sid)
    for k in range(400):
        r = int(rs[k])
        want = semantics.extend_scalar(
            qc, dc, int(q.start[r]), int(q.end[r]) - 1, int(db.start[r]),
            int(db.end[r]) - 1, int(qpos[k]), int(dpos[k]))[0]
        assert int(raw[k]) == want, k


@pytest.mark.parametrize("gapped", [False, True])
def test_aligner_matches_the_scalar_aligner(gapped):
    rng = np.random.default_rng(11 + gapped)
    X, Y = [], []
    for b in range(24):
        x = rng.integers(0, 4, int(rng.integers(2, 90)), dtype=np.uint8)
        if b % 2:
            y = x.copy()
            y[rng.random(len(y)) < 0.1] = 0
            if gapped and len(y) > 20:
                cut = int(rng.integers(5, len(y) - 5))
                y = np.concatenate([y[:cut], y[cut + 3:]])
        else:
            y = rng.integers(0, 4, int(rng.integers(2, 90)), dtype=np.uint8)
        X.append(x)
        Y.append(y)
    stats, paths = dense.align(X, Y, -5, -2, "cpu", paths=True)
    assert dense.align(X, Y, -5, -2, "cpu") == stats
    for x, y, st, path in zip(X, Y, stats, paths):
        frm, (bi, bj) = semantics.nw_scalar(x, y, -5, -2)
        assert path == semantics.path_from_frm(frm, bi, bj)
        rx, ry, hx, hy, ml, length = semantics.buffers_from_path(x, y, path)
        _, ident = semantics.render_alignment(rx, ry, hx, hy, ml)
        assert st == (length, ident)


def _port(data):
    from imsame_tpu_torch.config import Config
    from imsame_tpu_torch.io.fasta import SeqInfo
    from imsame_tpu_torch.pipeline import TorchEngine

    def si(codes, starts):
        fresh = np.zeros(len(codes), bool)
        fresh[starts] = True
        return SeqInfo(codes=codes, start=starts, fresh=fresh,
                       headers=[b""] * len(starts))

    q = si(data["q_codes"], data["q_starts"])
    eng = TorchEngine(si(data["db_codes"], data["db_starts"]), Config(),
                      device="cpu")
    res = eng.compare(q)
    return dict(report=eng.render_report(q, res), pairs=res.pairs,
                accepted=res.accepted, n_candidates=res.n_candidates,
                nw_cells=res.nw_cells)


@pytest.mark.parametrize("config,frac", [
    ("tiny", 0.0), ("tiny", 0.5), ("tiny", 0.95),
    ("tiny_long", 0.0), ("tiny_long", 1.0)])
def test_reference_agrees_with_the_port_on_the_cpu(config, frac):
    cfg = run.load_json(f"{run.BENCH}/tests/data/{config}.json")
    gen = run.load_module(f"{run.BENCH}/gen/{cfg['generator']}.py")
    data = gen.generate(cfg, {"match_frac": frac}, np.random.default_rng(31))
    job = _port(data)
    n = len(data["q_starts"])
    reads = np.arange(n)
    ref = judge.Reference(data, CFG, "cpu")
    want = judge.reference_view(ref, reads, reads, full=True)
    view = judge.job_view(job, reads, reads)
    checks = judge.compare(want, [view, view], full=True)
    assert all(v == 0 for v, _ in checks.values()), checks
    accepted = sum(s is not None for s in want["won"].values())
    assert accepted == job["accepted"]
    if frac == 0.0:
        assert accepted == 0 and "candidates_off" in checks
    else:
        assert accepted >= 0.9 * frac * n


@pytest.mark.card
def test_aligner_on_the_card_replays_one_captured_step():
    """On a card the aligner replays a CUDA graph of one diagonal; its
    stats and paths equal the CPU's step by step run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(17)
    X = [rng.integers(0, 4, int(n), dtype=np.uint8)
         for n in rng.integers(2, 700, 40)]
    Y = [np.where(rng.random(len(x)) < 0.05, 0, x).astype(np.uint8)
         if k % 2 else rng.integers(0, 4, int(rng.integers(2, 700)),
                                    dtype=np.uint8)
         for k, x in enumerate(X)]
    assert dense.align(X, Y, -5, -2, "cuda", paths=True) == \
        dense.align(X, Y, -5, -2, "cpu", paths=True)
