"""The `gut1m` configuration on the CPU: its generator against
`bench_config3.py`'s, the port's engine in the wide-db regime against the
plain reference, a rehearsal of the `slice` job kind through
`run.measure`, and the per-job shares of a resident engine's sums and
counters.  A db of 2^20 reads is too large for a CPU test, so the tests
lower `pipeline.PACKED_MAX_READS` (and the index build's own 2^20) below
the rehearsal's 2,048 db reads: the db takes the wide index and the gate
the two-word candidates, as at full size."""

import numpy as np
import pytest
import torch

import bench_config3
from benchmark import run
from benchmark.reference import judge
from imsame_tpu_torch.utils.hostmem import retain_freed_memory

CONFIG = run.load_json(f"{run.BENCH}/tests/data/tiny_gut.json")
TRAFFIC = run.load_json(f"{run.BENCH}/traffic/slice.json")
LAYERS = {m["name"]: m["unit"] for m in run.load_json(
    f"{run.ROOT}/BENCHMARK.json")["per_layer"]}
COUNTERS = ("gate_cand_bytes", "gate_built_cands", "nw_launched_cells")


def _module(kind, name):
    return run.load_module(f"{run.BENCH}/{kind}/{name}.py")


@pytest.fixture(autouse=True)
def _glibc_defaults_after():
    """A slice job keeps freed host memory process-wide; each test gives
    the worker glibc's defaults back."""
    yield
    retain_freed_memory(False)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def wide(monkeypatch):
    """Past 1,024 reads a sample the engine takes the wide formats, and
    the index build keeps (pos, sid) and no packed words."""
    from imsame_tpu_torch import native, pipeline

    build = native.build_index_arrays
    monkeypatch.setattr(pipeline, "PACKED_MAX_READS", 1024)
    monkeypatch.setattr(native, "build_index_arrays",
                        lambda codes, fresh, start, k, packable:
                        build(codes, fresh, start, k, False))
    return pipeline


@pytest.fixture(scope="module")
def data():
    return _module("gen", "gut").generate(CONFIG, TRAFFIC,
                                          np.random.default_rng(2**32 + 19))


def _files(config, traffic):
    return dict(cell=dict(name=f"{config}.{traffic}", config=config,
                          traffic=traffic, chips=1),
                e2e=["reads_per_s", "setup_s"], layers=LAYERS,
                config=f"{run.BENCH}/tests/data/{config}.json",
                traffic=f"{run.BENCH}/traffic/{traffic}.json")


def test_gut_generator_is_bench_config3s():
    """The db side bit for bit bench_config3.synth's at the same seed; the
    query side that sample's reads at the seeded slice, in sample order."""
    g = _module("gen", "gut")
    n, k, L = 3000, 400, 250
    args = (n, L, bench_config3.MATCH_FRAC, bench_config3.SUB_RATE)
    want_q, want_db = bench_config3.synth(*args, 99)
    rng = np.random.default_rng(99)
    for got, want in zip(g.synth(*args, rng), (want_q, want_db)):
        np.testing.assert_array_equal(got, want)
    keep = np.sort(rng.choice(n, size=k, replace=False))
    d = g.generate(dict(reads=n, read_len=L, sub=bench_config3.SUB_RATE,
                        query_reads=k),
                   dict(match_frac=bench_config3.MATCH_FRAC),
                   np.random.default_rng(99))
    np.testing.assert_array_equal(d["db_codes"], want_db.reshape(-1))
    np.testing.assert_array_equal(d["q_codes"], want_q[keep].reshape(-1))
    np.testing.assert_array_equal(d["q_starts"], np.arange(k) * L)
    np.testing.assert_array_equal(d["db_starts"], np.arange(n) * L)
    # reads past the copied 90 % of the sample have no copy in the db
    orphans = (keep >= int(n * bench_config3.MATCH_FRAC)).mean()
    assert 0.05 < orphans < 0.15


def test_gut_repeats_by_seed_with_one_size():
    g = _module("gen", "gut")
    a, b, c = (g.generate(CONFIG, TRAFFIC, np.random.default_rng(s))
               for s in (7, 7, 8))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["q_codes"], c["q_codes"])
    for d in (a, c):
        assert len(d["q_codes"]) == CONFIG["query_reads"] * 250
        assert len(d["db_codes"]) == CONFIG["reads"] * 250


def test_wide_engine_holds_to_the_reference(wide, data, monkeypatch):
    """The engine on the wide index, every chunk in the two-word format:
    every read's answer and a sample of records equal the reference's."""
    from imsame_tpu_torch.config import Config
    from imsame_tpu_torch.io.fasta import SeqInfo

    slice_job = _module("jobs", "slice")
    packed = wide.flat_gate_packed
    slots = []

    def two_words(qp, dp, qlen, dlen, idx_tab, cand, thr, **kw):
        assert isinstance(idx_tab, tuple) and len(idx_tab) == 3
        slots.append(cand.shape)
        return packed(qp, dp, qlen, dlen, idx_tab, cand, thr, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a gate format other than the two words")

    monkeypatch.setattr(wide, "flat_gate_packed", two_words)
    monkeypatch.setattr(wide, "flat_gate_seg", refuse)
    monkeypatch.setattr(wide, "flat_gate", refuse)
    q = slice_job._seqinfo(SeqInfo, data["q_codes"], data["q_starts"])
    db = slice_job._seqinfo(SeqInfo, data["db_codes"], data["db_starts"])
    eng = wide.TorchEngine(db, Config(**CONFIG["thresholds"]), device="cpu")
    assert eng.index.packed is None and not eng._packed_idx
    res = eng.compare(q)
    job = dict(report=eng.render_report(q, res), pairs=res.pairs,
               accepted=res.accepted, n_candidates=res.n_candidates,
               nw_cells=res.nw_cells)
    assert slots and all(s[0] == 2 for s in slots)
    counts = dict(eng.timer.counts())
    assert counts["gate_cand_bytes"] == 8 * sum(s[1] for s in slots)
    assert counts["gate_built_cands"] == res.n_candidates
    assert 0.8 * len(q.start) <= res.accepted < len(q.start)

    reads = np.arange(len(q.start))
    rec = np.random.default_rng(5).choice(reads, 40, replace=False)
    ref = judge.Reference(data, CONFIG["thresholds"], "cpu")
    want = judge.reference_view(ref, reads, rec, full=False)
    checks = judge.compare(want, [judge.job_view(job, reads, rec)], False)
    assert all(v == 0 for v, _ in checks.values()), checks
    assert sum(s is not None for s in want["won"].values()) == res.accepted


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal_of_the_slice_kind(wide, trace):
    result, checks = run.measure(_files("tiny_gut", "slice"), 2**33 + 41,
                                 0.5, bool(trace), "cpu", lambda m: None)
    assert result["correct"] and result["attempted"] >= 1
    assert all(v == 0 for v, _ in checks.values()), checks
    if trace:
        m = result["metrics"]
        assert {"gate_cand_mb", "gate_cands_per_read", "plan_s",
                "compare_s", "render_s"} <= set(m)
        assert m["index_build_s"]["value"] == 0.0
        # eight bytes a candidate slot, a little padding over the
        # candidates
        per_cand = (m["gate_cand_mb"]["value"] * 1e6
                    / m["gate_cands_per_read"]["value"]
                    / CONFIG["query_reads"])
        assert 8.0 <= per_cand < 9.0
    else:
        assert set(result["metrics"]) == {"reads_per_s", "setup_s"}


def test_the_pair_kind_reads_no_gate_counters():
    result, _ = run.measure(_files("tiny", "pair"), 2**33 + 43, 0.5, True,
                            "cpu", lambda m: None)
    assert result["correct"]
    assert not {"gate_cand_mb", "gate_cands_per_read"} & set(
        result["metrics"])


def test_a_resident_engine_gives_each_job_its_share(wide, data):
    """Jobs after the warm one give equal reports, phase names and
    counters; the compare's counters equal a fresh engine's after one
    compare and render; the db's rows go up in the warm job alone."""
    from imsame_tpu_torch.config import Config

    job = _module("jobs", "slice").Job(CONFIG, data, "cpu")
    warm, a, b = job.run(), job.run(), job.run()
    assert a["report"] == b["report"] == warm["report"]
    assert a["pairs"] == b["pairs"] and a["accepted"] > 0
    assert set(a["timings"]) == set(b["timings"]) == set(warm["timings"])
    assert a["counters"] == b["counters"]
    assert all(v >= 0 for v in a["timings"].values())
    assert a["spans"]["index_build_s"] == 0.0
    assert warm["counters"]["h2d_bytes"] > a["counters"]["h2d_bytes"]

    fresh = wide.TorchEngine(job.eng.db, Config(**CONFIG["thresholds"]),
                             device="cpu")
    res = fresh.compare(job.q)
    assert fresh.render_report(job.q, res) == a["report"]
    counts = dict(fresh.timer.counts())
    for k in COUNTERS:
        assert a["counters"][k] == counts[k] > 0, k
    assert a["timings"]["compare"] < dict(job.eng.timer.items())["compare"]
