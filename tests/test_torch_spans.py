"""The port's phases as spans and counters (imsame_tpu_torch/utils/
timing.py PhaseTimer): under torch.profiler each phase is an
``imsame.<name>`` range nested as the engine's layers are; with no
profiler recording no range is entered; the phase sums keep their names;
the counters nw_launched_cells, h2d_bytes and gate_cand_bytes count
what the engine launches and sends."""

import random

import numpy as np
import pytest
import torch

from imsame_tpu_torch.config import Config
from imsame_tpu_torch.io.fasta import read_fasta
from imsame_tpu_torch.pipeline import TorchEngine
from util_synth import make_pair

# test_torch_pipeline.py's "small_round" config: several gate chunks and NW
# batches a stage, a second gate stage and wave
SMALL = {"first_window": 4, "gate_chunks": (64, 32),
         "nw_stats_batches": (8,), "nw_render_batches": (8,)}
# the phase names res.timings held on this workload before the phases
# became spans, less `render` (a sort inside the compare, now part of the
# compare's own time)
PARENT_PHASES = {
    "gate.build", "gate.dispatch", "gate.encode", "gate.fetch",
    "gate.launch", "gate.upload", "index_build", "kmer_stream",
    "nw.dispatch", "nw.fetch1", "nw.fetch2", "nw.scatter", "resolve",
    "resolve.extend", "resolve.nw", "upload",
}
# (child, parent) phases whose sums nest
NESTED = [
    ("index_build", "engine"), ("engine.upload", "engine"),
    ("resolve", "compare"), ("resolve.extend", "resolve"),
    ("gate.dispatch", "resolve.extend"), ("gate.fetch", "resolve.extend"),
    ("gate.upload", "gate.dispatch"), ("gate.launch", "gate.dispatch"),
    ("resolve.nw", "resolve"), ("nw.fetch1", "resolve.nw"),
    ("resolve.judge", "resolve"), ("render.fetch", "render_report"),
    ("render.blocks", "render_report"), ("render.format", "render_report"),
]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    qp, dp = make_pair(tmp_path_factory.mktemp("spans"), random.Random(21),
                       n_query=40, n_db=40, read_len=150, sub_rate=0.05,
                       indel_rate=0.02)
    return read_fasta(str(qp)), read_fasta(str(dp))


def _job(samples, **kw):
    """Engine, compare and report, as a job of the benchmark runs them."""
    q, db = samples
    eng = TorchEngine(db, Config(**SMALL), device="cpu", **kw)
    res = eng.compare(q)
    report = eng.render_report(q, res)
    assert res.accepted > 0 and report
    return eng, res


@pytest.fixture(scope="module")
def quiet(samples):
    """One job with no profiler recording, record_function made to raise,
    and the engine's own uploads and NW chunks watched: (engine, result,
    bytes _put saw, B * L * L of each counted chunk)."""
    put_bytes, chunk_cells = [], []
    put, chunks = TorchEngine._put, TorchEngine._nw_chunks

    def watched_put(self, x):
        put_bytes.append(np.ascontiguousarray(x).nbytes)
        return put(self, x)

    def watched_chunks(self, *a, count_cells=True, **kw):
        for chunk, rpad, spad, L in chunks(self, *a, count_cells=count_cells,
                                           **kw):
            if count_cells:
                chunk_cells.append(len(rpad) * L * L)
            yield chunk, rpad, spad, L

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchEngine, "_put", watched_put)
        mp.setattr(TorchEngine, "_nw_chunks", watched_chunks)
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        eng, res = _job(samples)
    return eng, res, put_bytes, chunk_cells


def _ranges(prof):
    """(phase, start, end) of the imsame.* ranges, in seconds, from the
    profiler's raw events (prof.events() builds an object an op: a minute
    on this CPU run's million)."""
    return [(e.name()[len("imsame."):], e.start_ns() / 1e9, e.end_ns() / 1e9)
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("imsame.")]


def _parent(ranges, child):
    """The innermost range around ``child``: the latest-starting, then the
    shortest, of those that cover it."""
    _, a, b = child
    around = [r for r in ranges if r is not child and r[1] <= a
              and b <= r[2]]
    if not around:
        return None
    return max(around, key=lambda r: (r[1], -r[2]))[0]


def test_spans_nest_under_the_profiler(samples):
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        eng, _ = _job(samples)
    ranges = _ranges(prof)
    names = {n for n, _, _ in ranges}
    assert names == set(dict(eng.timer.items()))
    want = {"index_build": "engine", "engine.upload": "engine",
            "resolve": "compare", "resolve.nw": "resolve",
            "nw.fetch1": "resolve.nw", "render.fetch": "render_report",
            "render.blocks": "render_report",
            "render.format": "render_report",
            "render.dispatch": "render_report",
            "gate.fetch": "resolve.extend", "gate.upload": "gate.dispatch"}
    for child, parent in want.items():
        got = {_parent(ranges, r) for r in ranges if r[0] == child}
        assert got == {parent}, child
    for top in ("engine", "compare", "render_report"):
        assert {_parent(ranges, r) for r in ranges if r[0] == top} == {None}
    # each phase's sum is its ranges' total, on the profiler's clock
    sums = dict(eng.timer.items())
    for name in ("engine", "compare", "render_report"):
        s = sum(b - a for n, a, b in ranges if n == name)
        assert s == pytest.approx(sums[name], rel=0.05, abs=2e-3)


def test_no_record_function_without_a_profiler(quiet):
    eng, res, _, _ = quiet
    assert not eng.timer.tracing
    assert res.accepted > 0


def test_timings_keep_every_phase_name_but_render(quiet):
    eng, res, _, _ = quiet
    assert PARENT_PHASES <= set(res.timings)
    assert "render" not in res.timings
    assert {"engine", "engine.upload", "compare", "resolve.judge"} <= \
        set(res.timings)
    sums = dict(eng.timer.items())
    assert {"render_report", "render.dispatch", "render.fetch",
            "render.collect", "render.blocks", "render.format"} <= set(sums)
    for child, parent in NESTED:
        assert sums[child] <= sums[parent], (child, parent)


def test_the_render_brings_the_results_timings_up_to_date(samples):
    """compare leaves its phase sums in res.timings; render_report adds
    its own there, so a caller that keeps the result reads both."""
    q, db = samples
    eng = TorchEngine(db, Config(**SMALL), device="cpu")
    res = eng.compare(q)
    assert "compare" in res.timings and not any(
        k.startswith("render") for k in res.timings)
    kept = dict(res.timings)
    assert eng.render_report(q, res)
    assert res.timings == dict(eng.timer.items())
    assert {"render_report", "render.fetch", "render.blocks",
            "render.format"} <= set(res.timings)
    assert all(res.timings[k] == v for k, v in kept.items())


def test_launched_cells_are_the_chunks_of_the_stats_waves(quiet):
    eng, res, _, chunk_cells = quiet
    counts = dict(eng.timer.counts())
    assert len(chunk_cells) >= 2
    assert counts["nw_launched_cells"] == sum(chunk_cells)
    assert 0 < res.nw_cells <= counts["nw_launched_cells"]


def test_upload_bytes_are_what_put_sends(quiet):
    eng, _, put_bytes, _ = quiet
    assert dict(eng.timer.counts())["h2d_bytes"] == sum(put_bytes)
    # the packed index words alone: one int32 a db k-mer entry
    assert sum(put_bytes) >= 4 * eng.index.n_entries


def test_upload_bytes_on_a_mesh_count_host_arrays_once(samples):
    """On a (2, 2) mesh of CPU positions: _put's arrays, the host arrays
    the mesh uploads (put_rows, put_cols) among them; tensors copied
    between positions are not counted."""
    sent = []
    put = TorchEngine._put

    def watched_put(self, x, device=None):
        sent.append(np.ascontiguousarray(x).nbytes)
        return put(self, x, device)

    q, db = samples
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchEngine, "_put", watched_put)
        eng = TorchEngine(db, Config(mesh_shape=(2, 2)), device="cpu",
                          mesh_devices=["cpu"] * 4)
        res = eng.compare(q)
        assert res.accepted > 0 and eng.render_report(q, res)
        assert eng._mesh.upload == eng._put
    assert dict(eng.timer.counts())["h2d_bytes"] == sum(sent)


# gate candidate formats: (PACKED_MAX_READS, query reads, mesh grid, the
# rows of each array sent, or None for the seg words' three 1-D arrays)
GATE_FORMATS = {
    "seg": (None, 40, None, None),
    "two words, wide index": (30, 20, None, 2),
    "three words": (16, 40, None, 3),
    "mesh two words": (None, 40, (2, 1), 2),
    "mesh routed": (None, 40, (2, 2), 2),
    "mesh three words": (16, 40, (2, 1), 4),
}


@pytest.mark.parametrize("fmt", list(GATE_FORMATS))
def test_gate_candidate_bytes_are_what_the_dispatch_sends(samples, fmt):
    """gate_cand_bytes sums the candidate arrays the gate's dispatch hands
    to _put (on a mesh, as the column blocks Mesh.put_cols sends): seg
    words and their row tables, two words, three words (four on a mesh,
    with the valid row), the routed planner's two words."""
    from imsame_tpu_torch import pipeline

    packed_max, n_q, grid, rows = GATE_FORMATS[fmt]
    sent, inside = [], []
    put = TorchEngine._put
    dispatch = TorchEngine._gate_chunks_dispatch

    def watched_dispatch(self, *a, **kw):
        inside.append(True)
        try:
            return dispatch(self, *a, **kw)
        finally:
            inside.pop()

    def watched_put(self, x, device=None):
        if inside:
            sent.append(np.ascontiguousarray(x))
        return put(self, x, device)

    q, db = samples
    q = q.slice_reads(0, n_q)
    cfg = Config(**SMALL) if grid is None else Config(mesh_shape=grid)
    with pytest.MonkeyPatch.context() as mp:
        if packed_max is not None:
            mp.setattr(pipeline, "PACKED_MAX_READS", packed_max)
        mp.setattr(TorchEngine, "_gate_chunks_dispatch", watched_dispatch)
        mp.setattr(TorchEngine, "_put", watched_put)
        eng = TorchEngine(db, cfg, device="cpu",
                          mesh_devices=None if grid is None
                          else ["cpu"] * (grid[0] * grid[1]))
        res = eng.compare(q)
    assert res.accepted > 0 and sent
    counts = dict(eng.timer.counts())
    assert counts["gate_cand_bytes"] == sum(x.nbytes for x in sent)
    if rows is None:
        assert all(x.ndim == 1 for x in sent) and len(sent) % 3 == 0
    else:
        assert all(x.shape[0] == rows for x in sent)
        # 4 B a row and a slot, the slots padded to 32 a data shard
        assert counts["gate_cand_bytes"] >= 4 * rows * res.n_candidates
