"""The `mock20k` configuration on the CPU: its generator (repeatable by
seed; the shared fragments, their strands and substitutions as the
traffic states; the plain reverse complement of the designated db against
the port's revcomp of the written FASTA), a rehearsal of the `sweep` job
kind through `run.measure`, the same with the designated db broken, and
a sweep with a failed compare, which has to raise.

The rehearsal's engines take NW batch ladders of a few pairs: the default
ladders pad each chunk of these small samples to hundreds of pairs, which
the plain torch aligners compute in full on the CPU.  Reports do not
depend on them."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import run

CONFIG = run.load_json(f"{run.BENCH}/tests/data/tiny_sweep.json")
FULL = run.load_json(f"{run.BENCH}/configs/mock20k.json")
TRAFFIC = run.load_json(f"{run.BENCH}/traffic/sweep.json")
TINY_TRAFFIC = dict(TRAFFIC, pool_reads=CONFIG["reads"])
LAYERS = {m["name"]: m["unit"] for m in run.load_json(
    f"{run.ROOT}/BENCHMARK.json")["per_layer"]}


def _module(kind, name):
    return run.load_module(f"{run.BENCH}/{kind}/{name}.py")


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
        nw_stats_batches: tuple = (32, 8)
        nw_render_batches: tuple = (32, 8)

    monkeypatch.setattr(config, "Config", Small)


@pytest.fixture
def files(tmp_path):
    traffic = tmp_path / "sweep.json"
    traffic.write_text(json.dumps(TINY_TRAFFIC))
    return dict(cell=dict(name="tiny_sweep.sweep", config="tiny_sweep",
                          traffic="sweep", chips=1),
                e2e=["reads_per_s", "setup_s"], layers=LAYERS,
                config=f"{run.BENCH}/tests/data/tiny_sweep.json",
                traffic=str(traffic))


def _rc_reads(reads: np.ndarray) -> np.ndarray:
    return 3 - reads[:, ::-1]


def test_samples_repeat_by_seed_with_one_size():
    g = _module("gen", "samples")
    a, b, c = (g.generate(FULL, TRAFFIC, np.random.default_rng(s))
               for s in (2**40 + 7, 2**40 + 7, 8))
    for k in ("q_codes", "q_starts", "db_codes", "db_starts"):
        assert np.array_equal(a[k], b[k])
    assert a["designated"] == b["designated"]
    assert all(np.array_equal(s[k], t[k]) for s, t in zip(a["samples"],
                                                          b["samples"])
               for k in s)
    assert not np.array_equal(a["q_codes"], c["q_codes"])
    for d in (a, c):
        assert len(d["samples"]) == FULL["samples"]
        for s in d["samples"]:
            assert len(s["codes"]) == FULL["reads"] * FULL["read_len"]
        x, y = d["designated"]
        assert 0 <= x < y < FULL["samples"]


def test_shared_fragments_strands_and_substitutions():
    """Each sample copies 10,000 distinct pool fragments, about half on
    the reverse strand; two samples share ~5,000, about half on one
    strand; two copies of a fragment differ at ~4 % of their bases once on
    one strand; the designated compare is sample X against sample Y's
    reads reversed in order, each reverse-complemented."""
    g = _module("gen", "samples")
    d = g.generate(FULL, TRAFFIC, np.random.default_rng(2**35 + 3))
    n, L = FULL["reads"], FULL["read_len"]
    n_shared = int(n * TRAFFIC["shared_frac"])
    reads = [s["codes"].reshape(n, L) for s in d["samples"]]
    for s in d["samples"]:
        pi = s["pool_index"][s["pool_index"] >= 0]
        assert len(pi) == len(np.unique(pi)) == n_shared
        assert 0.47 < s["rc"][s["pool_index"] >= 0].mean() < 0.53
        assert not s["rc"][s["pool_index"] < 0].any()
    k = len(reads)
    for x in range(k):
        for y in range(x + 1, k):
            sx, sy = d["samples"][x], d["samples"][y]
            common, ix, iy = np.intersect1d(
                sx["pool_index"], sy["pool_index"], return_indices=True)
            ix, iy = ix[common >= 0], iy[common >= 0]
            assert 4700 < len(ix) < 5300
            same = sx["rc"][ix] == sy["rc"][iy]
            assert 0.45 < same.mean() < 0.55
            a = reads[x][ix]
            b = np.where(same[:, None], reads[y][iy],
                         _rc_reads(reads[y][iy]))
            assert 0.035 < (a != b).mean() < 0.045
    x, y = d["designated"]
    np.testing.assert_array_equal(d["q_codes"], d["samples"][x]["codes"])
    np.testing.assert_array_equal(
        d["db_codes"].reshape(n, L), _rc_reads(reads[y])[::-1])
    np.testing.assert_array_equal(d["db_starts"], np.arange(n) * L)


def test_plain_revcomp_is_the_ports(tmp_path):
    """The generator's reverse complement of a sample equals the port's
    revComp of the FASTA file the job writes, parsed."""
    from imsame_tpu_torch.io.fasta import (
        parse_fasta_bytes, revcomp_fasta_bytes)

    g, sweep = _module("gen", "samples"), _module("jobs", "sweep")
    d = g.generate(CONFIG, TINY_TRAFFIC, np.random.default_rng(11))
    for k, s in enumerate(d["samples"]):
        path = tmp_path / f"s{k}.fasta"
        sweep.write_fasta(str(path), f"s{k}", s["codes"], s["starts"])
        raw = path.read_bytes()
        fwd = parse_fasta_bytes(raw)
        np.testing.assert_array_equal(fwd.codes, s["codes"])
        np.testing.assert_array_equal(fwd.start, s["starts"])
        rc = parse_fasta_bytes(revcomp_fasta_bytes(raw))
        codes, starts = g.revcomp(s["codes"], s["starts"])
        np.testing.assert_array_equal(rc.codes, codes)
        np.testing.assert_array_equal(rc.start, starts)


def _recording(monkeypatch, seen: list, revcomp=None):
    """run.load_module, keeping each sweep job's result and, given
    `revcomp`, putting it in the generator's place."""
    load = run.load_module

    def patched(path):
        mod = load(path)
        if path.endswith("jobs/sweep.py"):
            class Job(mod.Job):
                def run(self):
                    seen.append(super().run())
                    return seen[-1]
            mod.Job = Job
        if path.endswith("gen/samples.py") and revcomp is not None:
            mod.revcomp = revcomp
        return mod

    monkeypatch.setattr(run, "load_module", patched)


def test_cpu_rehearsal_of_a_sweep(monkeypatch, small_ladders, files):
    """Every check 0 over every read of the designated compare, which
    accepts reads; the sweep's readers and the spans in the traced line."""
    seen = []
    _recording(monkeypatch, seen)
    result, checks = run.measure(files, 2**33 + 5, 0.1, True, "cpu",
                                 lambda m: None)
    assert result["correct"], checks
    assert all(v == 0 for v, _ in checks.values()), checks
    assert len(seen) == 1 + result["attempted"]
    for job in seen:
        assert job["accepted"] > 0 and len(job["pairs"]) == job["accepted"]
        assert job["reads"] == 12 * CONFIG["reads"]
        assert job["counters"]["sweep_jobs"] == 12
        assert job["counters"]["sweep_engine_builds"] == 6
        assert job["counters"]["nw_launched_cells"] > 0
    m = result["metrics"]
    assert {"sweep_host_s", "sweep_written_mb", "index_build_s",
            "compare_s", "render_s", "plan_s", "render_host_s"} <= set(m)
    assert m["sweep_written_mb"]["value"] > 0


@pytest.mark.parametrize("how", ["file_order", "forward"])
def test_a_broken_designated_db_is_not_correct(monkeypatch, small_ladders,
                                               files, how):
    """The reference given sample Y's reverse complement in file order,
    or sample Y itself, in place of the revComp tool's file: the answers
    differ from the program's."""
    def file_order(codes, starts):
        L = int(starts[1] - starts[0])
        return (3 - codes.reshape(-1, L)[:, ::-1]).reshape(-1), starts

    broken = dict(file_order=file_order,
                  forward=lambda codes, starts: (codes, starts))[how]
    _recording(monkeypatch, [], broken)
    result, checks = run.measure(files, 2**33 + 5, 0.1, False, "cpu",
                                 lambda m: None)
    assert not result["correct"]
    assert checks["answers_wrong"][0] > 0, checks


def test_a_failed_compare_fails_the_job(monkeypatch, small_ladders):
    """A compare that raises fails the job, not just its report."""
    from imsame_tpu_torch import pipeline

    def boom(self, q):
        raise RuntimeError("injected")

    g, sweep = _module("gen", "samples"), _module("jobs", "sweep")
    config = dict(CONFIG, samples=2)
    d = g.generate(config, TINY_TRAFFIC, np.random.default_rng(3))
    job = sweep.Job(config, d, "cpu")
    monkeypatch.setattr(pipeline.TorchEngine, "compare", boom)
    with pytest.raises(RuntimeError, match="0 of 2 reports"):
        job.run()
