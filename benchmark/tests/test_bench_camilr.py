"""The `camilr8k` configuration on the CPU: its generator (repeatable by
seed; lengths in [min_len, max_len], ~44 % trimmed to 3,000 at the
configuration's size; copies that carry their mutations), the
`pair_counts` job kind's counters, the three readers of the program's
long-bucket and render counters on a made-up context, and a rehearsal of
the cell through `run.measure` on a tiny copy (`data/tiny_camilr.json`,
reads of 300-800 bp, so pairs in the 512 and 1024 buckets).

The rehearsal's engines take NW batch ladders of a few pairs: the default
ladders pad each chunk of these small samples to hundreds of pairs, which
the plain torch aligners compute in full on the CPU.  Reports do not
depend on them."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import run

FULL = run.load_json(f"{run.BENCH}/configs/camilr8k.json")
TINY = run.load_json(f"{run.BENCH}/tests/data/tiny_camilr.json")
TRAFFIC = run.load_json(f"{run.BENCH}/traffic/pair_counts.json")
SPEC = run.load_json(f"{run.ROOT}/BENCHMARK.json")
LAYERS = {m["name"]: m["unit"] for m in SPEC["per_layer"]}
NEW = ("long_accept_roofline", "long_accept_yield", "render_yield")


def _module(kind, name):
    return run.load_module(f"{run.BENCH}/{kind}/{name}.py")


def _lens(starts, codes):
    return np.diff(np.append(starts, len(codes)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_ladders(monkeypatch):
    from imsame_tpu_torch import config

    @dataclasses.dataclass
    class Small(config.Config):
        nw_stats_batches: tuple = (8, 4)
        nw_render_batches: tuple = (8,)

    monkeypatch.setattr(config, "Config", Small)


def test_camilr_repeats_by_seed():
    g = _module("gen", "camilr")
    cfg = dict(FULL, reads=400)
    for frac in (0.0, 0.5):
        a = g.generate(cfg, {"match_frac": frac},
                       np.random.default_rng(2**40 + 7))
        b = g.generate(cfg, {"match_frac": frac},
                       np.random.default_rng(2**40 + 7))
        c = g.generate(cfg, {"match_frac": frac}, np.random.default_rng(9))
        assert set(a) == {"q_codes", "q_starts", "db_codes", "db_starts"}
        assert all(np.array_equal(a[k], b[k]) for k in a)
        assert not all(np.array_equal(a[k], c[k]) for k in ("q_starts",
                                                            "db_starts"))
        assert len(a["q_starts"]) == len(a["db_starts"]) == 400


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**62 + 11])
def test_camilr_lengths_at_the_configurations_size(seed):
    g = _module("gen", "camilr")
    d = g.generate(FULL, TRAFFIC, np.random.default_rng(seed))
    q = _lens(d["q_starts"], d["q_codes"])
    db = _lens(d["db_starts"], d["db_codes"])
    assert len(q) == len(db) == FULL["reads"] == 8000
    assert q.min() >= 500 and q.max() <= 3000 and db.max() <= 3000
    assert 0.40 <= (q == 3000).mean() <= 0.48
    assert (q > 2048).mean() > 0.8  # most reads in the 3072 bucket


def test_camilr_copies_carry_their_mutations():
    g = _module("gen", "camilr")
    cfg = dict(TINY, reads=200, len_mean=400, len_sd=100, min_len=200,
               max_len=600)
    # substitutions only: each of the first half's reads has one copy at
    # ~96 % identity, base for base
    d = g.generate(dict(cfg, indel=0.0), {"match_frac": 0.5},
                   np.random.default_rng(3))
    q = np.split(d["q_codes"], d["q_starts"][1:])
    db = np.split(d["db_codes"], d["db_starts"][1:])
    by_len = {}
    for s, r in enumerate(db):
        by_len.setdefault(len(r), []).append(s)
    for r in q[:100]:
        same = [float((db[s] == r).mean()) for s in by_len[len(r)]]
        close = [x for x in same if x > 0.85]
        assert len(close) == 1 and close[0] < 1.0
    assert sorted(map(len, q)) == sorted(map(len, db))
    # with indels the copies' lengths move, the random reads' do not
    d = g.generate(cfg, {"match_frac": 0.5}, np.random.default_rng(3))
    ql = _lens(d["q_starts"], d["q_codes"])
    dl = _lens(d["db_starts"], d["db_codes"])
    assert sorted(ql) != sorted(dl)
    assert np.isin(ql[100:], dl).all()


def test_pair_counts_carries_the_engines_counters(small_ladders):
    kind = _module("jobs", "pair_counts")
    data = _module("gen", "camilr").generate(
        TINY, TRAFFIC, np.random.default_rng(5))
    job = kind.Job(TINY, data, "cpu")
    out = job.run()
    pair = _module("jobs", "pair").Job(TINY, data, "cpu").run()
    assert set(out) == set(pair) | {"counters"}
    assert out["report"] == pair["report"] and out["pairs"] == pair["pairs"]
    c = out["counters"]
    assert {"nw_launched_cells", "nw_long_cells", "nw_long_launched_cells",
            "render_launched_cells", "h2d_bytes"} <= set(c)
    assert 0 < c["nw_long_cells"] <= c["nw_long_launched_cells"]
    assert job.eng is None
    # a fresh engine a job: the second job's counts are its own
    assert job.run()["counters"] == c


class _Trace:
    def __init__(self, nw_stats_s):
        self.s = nw_stats_s

    def kernel_s(self, pattern):
        return self.s if "nw_stats_kernel" in pattern else 0.0


def _ctx(counters, nw_stats_s=0.01):
    data = dict(q_starts=np.array([0, 3000]), q_codes=np.zeros(5000),
                db_starts=np.array([0, 1000]), db_codes=np.zeros(4000))
    jobs = [dict(pairs=[(0, 1), (1, 0)], counters=c) for c in counters]
    card = dict(name="H100", sms=132, sm_hz=1.98e9, power_limit_w=700.0)
    return run.Context(jobs, _Trace(nw_stats_s), card, data)


def test_the_readers_read_the_counters():
    c = dict(nw_long_cells=3 * 10**7, nw_long_launched_cells=4 * 10**7,
             render_launched_cells=2 * 3072 * 3072)
    ctx = _ctx([c, c])
    read = {n: _module("metrics", n).read for n in NEW}
    assert read["long_accept_yield"](ctx) == pytest.approx(75.0)
    # pairs (0, 1) and (1, 0): 3,000 x 3,000 and 2,000 x 1,000 cells
    assert read["render_yield"](ctx) == pytest.approx(
        100 * (9e6 + 2e6) / (2 * 3072 * 3072))
    ops = 2 * 3 * 10**7 * 25
    assert read["long_accept_roofline"](ctx) == pytest.approx(
        100 * ops / (132 * 64 * 1.98e9) / 0.01)


@pytest.mark.parametrize("counters", [None, {}, {"nw_launched_cells": 5}])
def test_the_readers_read_nothing_without_the_counters(counters):
    ctx = _ctx([counters] * 2)
    if counters is None:
        for j in ctx.jobs:
            del j["counters"]
    for n in NEW:
        assert _module("metrics", n).read(ctx) is None
    assert all(_module("metrics", n).read(_ctx([])) is None for n in NEW)


def test_the_new_metrics_list_only_the_long_cell():
    for m in SPEC["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == ["camilr8k.pair"]
            assert m["moves"] == "reads_per_s"
    files = run.cell_files("camilr8k.pair")
    assert set(NEW) <= set(files["layers"])
    assert not set(NEW) & set(run.cell_files("mock100k.distant")["layers"])


def _files():
    return dict(cell=dict(name="tiny_camilr.pair_counts",
                          config="tiny_camilr", traffic="pair_counts",
                          chips=1),
                e2e=["reads_per_s", "setup_s"], layers=LAYERS,
                config=f"{run.BENCH}/tests/data/tiny_camilr.json",
                traffic=f"{run.BENCH}/traffic/pair_counts.json")


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal_of_the_long_cell(small_ladders, trace):
    data = _module("gen", "camilr").generate(
        TINY, TRAFFIC, np.random.default_rng(2**33 + 17))
    assert _lens(data["q_starts"], data["q_codes"]).max() > 512
    result, checks = run.measure(_files(), 2**33 + 17, 0.5, bool(trace),
                                 "cpu", lambda m: None)
    assert result["correct"] and result["attempted"] >= 1, checks
    assert set(checks) >= {"answers_wrong", "records_wrong"}
    assert all(v == 0 for v, _ in checks.values())
    if trace:
        m = result["metrics"]
        assert 0 < m["long_accept_yield"]["value"] <= 100
        assert 0 < m["render_yield"]["value"] <= 100
        # no nw_stats kernel on the CPU: nothing to read
        assert "long_accept_roofline" not in m
    else:
        assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
