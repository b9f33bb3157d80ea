"""The report in one native pass (native/host.c imsame_render_report,
TorchEngine.render_report) against the Python path (``native.lib`` None),
which defines the report: byte for byte on records whose chains walk
gaps on either side, leading and trailing gap runs, chains past the
64-entry prefix, reads of 128-3,000 bp, one record and none, the 100 %
clamps, a db of many reads with few rendered, real records of the CPU
engine and a batch split over threads.  The counter
``render_native_records`` counts the records the native pass wrote, and
a record whose identities disagree with its render raises."""

import random

import numpy as np
import pytest
import torch

from imsame_tpu_torch import native
from imsame_tpu_torch.config import Config
from imsame_tpu_torch.io.fasta import CODE_TO_CHAR, SeqInfo, read_fasta
from imsame_tpu_torch.io.reconstruct import backtrack_from_chain
from imsame_tpu_torch.io.report import render_alignment
from imsame_tpu_torch.pipeline import (
    AcceptedRead, PipelineResult, TorchEngine,
)
from util_synth import make_pair

PACK = 4096
RUN_FLAG = 1 << 26


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _needs_the_library():
    if native.load() is None:
        pytest.skip("no C compiler: the native report cannot be built")


def _sample(rng, lens):
    """A SeqInfo of random reads of the given lengths."""
    lens = np.asarray(lens, np.int64)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    codes = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    fresh = np.zeros(len(codes), bool)
    fresh[start] = True
    return SeqInfo(codes, start, fresh, [b""] * len(lens))


def _chain(rng, xl, yl, min_steps=0, trail=8, lead=True):
    """A chain over an xl x yl pair as the traceback packs it: the best
    cell (up to ``trail`` cells short of each read's end: trailing gap
    runs), then visited cells -- diagonal runs (flagged), single
    diagonal steps, and gap runs on either read -- down to a cell that
    may leave leading gap runs.  The row is as wide as the traceback's
    prefix (64 entries, or the next power of two), padded with junk."""
    x = xl - 1 - int(rng.integers(0, min(trail, xl - 1) + 1))
    y = yl - 1 - int(rng.integers(0, min(trail, yl - 1) + 1))
    cells = [x * PACK + y]
    while x > 0 and y > 0:
        if len(cells) > min_steps and rng.random() < (0.04 if lead else 0):
            break
        kind = int(rng.integers(0, 4))
        if kind == 0:
            n = int(rng.integers(1, min(x, y, 40) + 1))
            x, y = x - n, y - n
            cells.append(RUN_FLAG | (x * PACK + y))
            continue
        if kind == 1:
            x, y = x - 1, y - 1
        elif kind == 2:
            x -= int(rng.integers(1, min(x, 6) + 1))
        else:
            y -= int(rng.integers(1, min(y, 6) + 1))
        cells.append(x * PACK + y)
    width = 64
    while width < len(cells):
        width *= 2
    row = rng.integers(-2**31, 2**31, width).astype(np.int32)
    row[: len(cells)] = cells
    return row, len(cells) - 1


def _rendered_identities(db, q, qread, dbread, chain, n_steps):
    """The identity count the Python render emits for one pair."""
    xs, xe = int(db.start[dbread]), db.read_end(dbread)
    ys, ye = int(q.start[qread]), q.read_end(qread)
    bufs = backtrack_from_chain(
        chain, n_steps, xe - xs, ye - ys,
        CODE_TO_CHAR[db.codes[xs:xe]], CODE_TO_CHAR[q.codes[ys:ye]])
    return render_alignment(*bufs)[1]


def _records(rng, db, q, pairs, clamp=False, **chain_kw):
    """Accepted records of the (qread, dbread) pairs with random chains
    and the identities their render emits; ``length`` near those
    identities, or with ``clamp`` at and past both 100 % clamps."""
    recs = []
    for i, (qr, dr) in enumerate(pairs):
        xl, yl = db.read_len(dr), q.read_len(qr)
        chain, n_steps = _chain(rng, xl, yl, **chain_kw)
        ident = _rendered_identities(db, q, qr, dr, chain, n_steps)
        if clamp:  # identities == length, identities > length, length > ylen
            length = [ident, max(ident - 3, 1), yl + 7 + ident][i % 3]
        else:
            length = ident + int(rng.integers(1, 40))
        recs.append(AcceptedRead(qr, dr, length, ident, yl, n_steps, chain))
    return recs


def _engine(db):
    return TorchEngine(db, Config(), device="cpu")


def _case(name, tmp_path):
    """(engine, query sample, result) of a case; the records' chains are
    set, so render_report renders them with no compare behind it."""
    rng = np.random.default_rng(2026 + CASES.index(name))
    if name == "engine":
        qp, dp = make_pair(tmp_path, random.Random(7), n_query=60, n_db=60,
                           read_len=150, sub_rate=0.05, indel_rate=0.03)
        q, db = read_fasta(str(qp)), read_fasta(str(dp))
        eng = _engine(db)
        res = eng.compare(q)
        eng._materialize_chains(res.records)
        assert res.accepted > 10
        return eng, q, res
    if name == "gaps":
        db = _sample(rng, rng.integers(200, 260, 40))
        q = _sample(rng, rng.integers(200, 260, 40))
        pairs = [(i, int(rng.integers(0, 40))) for i in range(40)]
        recs = _records(rng, db, q, pairs, trail=30)
        first = [divmod(int(r.chain[0]), PACK) for r in recs]
        last = [divmod(int(r.chain[r.n_steps]) & (RUN_FLAG - 1), PACK)
                for r in recs]
        ends = [(db.read_len(r.dbread), r.ylen) for r in recs]
        assert any(x < xl - 1 for (x, _), (xl, _) in zip(first, ends))
        assert any(y < yl - 1 for (_, y), (_, yl) in zip(first, ends))
        assert any(x > 0 for x, _ in last) and any(y > 0 for _, y in last)
    elif name == "wide_chains":
        db = _sample(rng, [1000, 3000, 2000, 800])
        q = _sample(rng, [3000, 1000, 900, 2500])
        recs = _records(rng, db, q, [(0, 1), (1, 0), (2, 3), (3, 2)],
                        min_steps=130)
        assert min(r.n_steps for r in recs) >= 64
        assert {len(r.chain) for r in recs} >= {256}
    elif name == "long_reads":
        lens = [128, 129, 250, 511, 1024, 1500, 2047, 2999, 3000]
        db = _sample(rng, lens)
        q = _sample(rng, lens[::-1])
        recs = _records(rng, db, q, [(i, len(lens) - 1 - i)
                                     for i in range(len(lens))] +
                        [(0, 8), (8, 8), (4, 0)])
    elif name == "one":
        db = _sample(rng, [250, 250])
        q = _sample(rng, [250])
        recs = _records(rng, db, q, [(0, 1)])
    elif name == "none":
        db = _sample(rng, [250] * 4)
        q = _sample(rng, [250] * 4)
        recs = []
    elif name == "clamps":
        db = _sample(rng, rng.integers(120, 300, 12))
        q = _sample(rng, rng.integers(120, 300, 12))
        recs = _records(rng, db, q, [(i, 11 - i) for i in range(12)],
                        clamp=True, trail=0, lead=False)
    elif name == "sparse_db":
        db = _sample(rng, rng.integers(100, 300, 6000))
        q = _sample(rng, rng.integers(100, 300, 500))
        pairs = [(int(a), int(b)) for a, b in zip(
            np.sort(rng.choice(500, 5, replace=False)),
            rng.choice(6000, 5, replace=False))]
        recs = _records(rng, db, q, pairs + [(499, 5999)])
    elif name == "threads":
        db = _sample(rng, rng.integers(128, 400, 3000))
        q = _sample(rng, rng.integers(128, 400, 4500))
        pairs = [(i, int(rng.integers(0, 3000))) for i in range(4500)]
        recs = _records(rng, db, q, pairs)
    else:
        raise KeyError(name)
    res = PipelineResult(len(recs), q.n_seqs, db.n_seqs,
                         [(r.qread, r.dbread) for r in recs], recs, {}, 0, 0)
    return _engine(db), q, res


def _rendered(eng, q, res):
    """The report and the records the native pass counted for it."""
    before = dict(eng.timer.counts()).get("render_native_records", 0)
    out = eng.render_report(q, res)
    return out, dict(eng.timer.counts())["render_native_records"] - before


def _native_args(eng, q, recs):
    """native.render_report's arguments for the records, as the engine
    builds them."""
    db = eng.db
    qr = np.array([r.qread for r in recs], np.int64)
    dr = np.array([r.dbread for r in recs], np.int64)
    xl = np.array([db.read_len(r.dbread) for r in recs], np.int32)
    yl = np.array([q.read_len(r.qread) for r in recs], np.int32)
    chain_off = np.cumsum([0] + [len(r.chain) for r in recs])
    return (db.codes, q.codes, qr, dr, db.start[dr], q.start[qr], xl, yl,
            np.array([r.length for r in recs], np.int32),
            np.array([r.identities for r in recs], np.int32), yl,
            np.array([r.n_steps for r in recs], np.int32),
            np.concatenate([r.chain for r in recs]), chain_off)


CASES = ["gaps", "wide_chains", "long_reads", "one", "none", "clamps",
         "sparse_db", "engine", "threads"]


@pytest.mark.parametrize("case", CASES)
def test_native_report_equals_the_python_report(case, tmp_path, monkeypatch):
    eng, q, res = _case(case, tmp_path)
    P = len(res.records)
    out, counted = _rendered(eng, q, res)
    assert counted == P
    with monkeypatch.context() as m:
        m.setattr(native, "lib", None)
        want, counted_py = _rendered(eng, q, res)
    assert counted_py == 0
    assert out == want
    assert out.count(b" $$$$$$$ \n") == P
    if case == "clamps":
        assert out.count(b"% 100% ") >= 4  # length > ylen
        assert out.count(b") : 100% ") >= 8  # identities >= length
    if case == "threads":
        args = _native_args(eng, q, res.records)
        rendered = {}
        for cores in (1, 4):
            monkeypatch.setattr(native.os, "cpu_count", lambda: cores)
            rendered[cores] = native.render_report(*args)
        (one, em1), (many, em4) = rendered[1], rendered[4]
        assert one.tobytes() == many.tobytes() == want
        assert np.array_equal(em1, em4)


@pytest.mark.parametrize("path", ["native", "python"])
def test_identities_unlike_the_render_raise(path, tmp_path, monkeypatch):
    eng, q, res = _case("gaps", tmp_path)
    res.records[17].identities += 1
    if path == "python":
        monkeypatch.setattr(native, "lib", None)
    with pytest.raises(AssertionError):
        eng.render_report(q, res)
