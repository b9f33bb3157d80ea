"""The NW waves' long-bucket and render counters (imsame_tpu_torch/pipeline.py
TorchEngine._nw_chunks): on a CPU compare whose pairs fall in the 256, 512
and 1024 buckets, nw_long_cells and nw_long_launched_cells are the real
and the launched cells of the accept wave's chunks past nw_cuda.STRIP,
render_launched_cells is B * L * L over the render's chunks, all three
are 0 on a compare of 250 bp reads, and the counting changes no pair,
count or report byte."""

import numpy as np
import pytest
import torch

from imsame_tpu_torch.config import Config
from imsame_tpu_torch.io.fasta import SeqInfo
from imsame_tpu_torch.ops import nw_cuda
from imsame_tpu_torch.pipeline import TorchEngine
from imsame_tpu_torch.utils.timing import PhaseTimer

# several accept and render chunks a bucket
SMALL = {"first_window": 4, "nw_stats_batches": (8, 4),
         "nw_render_batches": (8,)}
NEW = ("nw_long_cells", "nw_long_launched_cells", "render_launched_cells")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _seqinfo(reads):
    lens = np.array([len(r) for r in reads], np.int64)
    starts = np.cumsum(lens) - lens
    codes = np.concatenate(reads).astype(np.uint8)
    fresh = np.zeros(len(codes), bool)
    fresh[starts] = True
    return SeqInfo(codes=codes, start=starts, fresh=fresh,
                   headers=[b""] * len(reads))


def _samples(lens, seed):
    """Query reads of the given lengths; the db holds a 4 %-substituted
    copy of every other one and random reads of the rest's lengths."""
    rng = np.random.default_rng(seed)
    q = [rng.integers(0, 4, n, dtype=np.uint8) for n in lens]
    db = []
    for k, r in enumerate(q):
        if k % 2:
            db.append(rng.integers(0, 4, len(r), dtype=np.uint8))
            continue
        c = r.copy()
        sub = rng.random(len(c)) < 0.04
        c[sub] = (c[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        db.append(c)
    order = rng.permutation(len(db))
    return _seqinfo(q), _seqinfo([db[k] for k in order])


@pytest.fixture(scope="module")
def long_samples():
    # 256, 512 and 1024 buckets
    return _samples([200, 240, 400, 450, 500, 300, 700, 900, 1000, 800,
                     600, 1020, 350, 480, 760, 980], 11)


@pytest.fixture(scope="module")
def short_samples():
    return _samples([250] * 24, 12)


def _watched(samples):
    """Engine, result, counters after the compare, report, and each chunk
    _nw_chunks yields: (render, L, B, real cells of its pairs)."""
    chunks_seen = []
    chunks = TorchEngine._nw_chunks

    def watched(self, r_ids, sids, qlens, *a, render=False, **kw):
        for chunk, rpad, spad, L in chunks(self, r_ids, sids, qlens, *a,
                                           render=render, **kw):
            real = int((self.db_read_lens[sids[chunk]].astype(np.int64)
                        * qlens[r_ids[chunk]]).sum())
            chunks_seen.append((render, L, len(rpad), real))
            yield chunk, rpad, spad, L

    q, db = samples
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchEngine, "_nw_chunks", watched)
        eng = TorchEngine(db, Config(**SMALL), device="cpu")
        res = eng.compare(q)
        after_compare = dict(eng.timer.counts())
        report = eng.render_report(q, res)
    return eng, res, after_compare, report, chunks_seen


@pytest.fixture(scope="module")
def long_job(long_samples):
    return _watched(long_samples)


def test_long_counters_are_the_accept_waves_long_chunks(long_job):
    eng, res, after_compare, _, seen = long_job
    accept = [c for c in seen if not c[0]]
    long = [c for c in accept if c[1] > nw_cuda.STRIP]
    assert {L for _, L, _, _ in long} == {512, 1024}
    assert any(L <= nw_cuda.STRIP for _, L, _, _ in accept)
    assert after_compare["nw_long_cells"] == sum(c[3] for c in long)
    assert after_compare["nw_long_launched_cells"] == sum(
        B * L * L for _, L, B, _ in long)
    assert after_compare["nw_long_cells"] < res.nw_cells
    assert after_compare["nw_long_launched_cells"] < \
        after_compare["nw_launched_cells"]
    assert after_compare.get("render_launched_cells", 0) == 0
    # the render counts none of the accept wave's counters
    counts = dict(eng.timer.counts())
    for k in ("nw_long_cells", "nw_long_launched_cells",
              "nw_launched_cells"):
        assert counts[k] == after_compare[k]


def test_render_launched_cells_are_the_render_chunks(long_samples, long_job):
    eng, res, _, report, seen = long_job
    render = [c for c in seen if c[0]]
    assert res.accepted > 0 and report
    assert {L for _, L, _, _ in render} >= {512, 1024}
    counts = dict(eng.timer.counts())
    assert counts["render_launched_cells"] == sum(
        B * L * L for _, L, B, _ in render)
    # the render's pairs are the accepted ones, each once
    q, _ = long_samples
    qlens = q.read_lens()
    want = sum(int(qlens[r]) * int(eng.db_read_lens[s])
               for r, s in res.pairs)
    assert sum(c[3] for c in render) == want
    assert want < counts["render_launched_cells"]


def test_the_new_counters_are_zero_on_a_short_compare(short_samples):
    eng, res, after_compare, report, seen = _watched(short_samples)
    assert res.accepted > 0 and report
    assert all(L <= nw_cuda.STRIP for _, L, _, _ in seen)
    assert all(after_compare.get(k, 0) == 0 for k in NEW)
    # the render counts its chunks at 256 too; the long counters stay 0
    counts = dict(eng.timer.counts())
    assert counts.get("nw_long_cells", 0) == 0
    assert counts.get("nw_long_launched_cells", 0) == 0
    assert counts["render_launched_cells"] == sum(
        B * L * L for render, L, B, _ in seen if render) > 0


@pytest.mark.parametrize("which", ["long", "short"])
def test_counting_changes_no_answer_or_report_byte(long_samples,
                                                   short_samples, which):
    q, db = long_samples if which == "long" else short_samples

    def job():
        eng = TorchEngine(db, Config(**SMALL), device="cpu")
        res = eng.compare(q)
        report = eng.render_report(q, res)
        return (res.pairs, res.accepted, res.n_candidates, res.nw_cells,
                report), dict(eng.timer.counts())

    counted, counts = job()
    count = PhaseTimer.count

    def skip_new(self, name, n):
        if name not in NEW:
            count(self, name, n)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PhaseTimer, "count", skip_new)
        uncounted, without = job()
    assert counted == uncounted
    assert {k: v for k, v in counts.items() if k not in NEW} == without
