"""The harness's control flow on the CPU, to the printing of the result's
line, on a tiny configuration used only here; and the same run with the
timed path broken underneath, where `correct` has to come out false.  The
command itself refuses to measure without a card."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run

LAYERS = {m["name"]: m["unit"] for m in run.load_json(
    f"{run.ROOT}/BENCHMARK.json")["per_layer"]}


def _files(traffic="pair"):
    return dict(cell=dict(name="tiny." + traffic, config="tiny",
                          traffic=traffic, chips=1),
                e2e=["reads_per_s", "setup_s"], layers=LAYERS,
                config=f"{run.BENCH}/tests/data/tiny.json",
                traffic=f"{run.BENCH}/traffic/{traffic}.json")


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal_reaches_the_result(trace):
    result, checks = run.measure(_files(), 2**31 + 77, 0.5, bool(trace),
                                 "cpu", lambda m: None)
    assert result["correct"] and result["attempted"] >= 1
    assert set(checks) >= {"answers_wrong", "records_wrong"}
    assert all(v == 0 for v, _ in checks.values())
    if trace:
        assert {"index_build_s", "compare_s", "render_s",
                "plan_s"} <= set(result["metrics"])
        assert "breakdown" in result and "window_s" in result["device"]
    else:
        assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    json.dumps(result)


def _broken(monkeypatch, how):
    from imsame_tpu_torch import pipeline

    compare = pipeline.TorchEngine.compare
    render = pipeline.TorchEngine.render_report

    def unchanged(self, q):
        res = compare(self, q.slice_reads(0, 0))
        res.n_query = q.n_seqs
        return res

    def half(self, q):  # the second half of the reads only
        h = q.n_seqs // 2
        res = compare(self, q.slice_reads(h, q.n_seqs))
        res.pairs = [(r + h, s) for r, s in res.pairs]
        for rec in res.records:
            rec.qread += h
        res.n_query = q.n_seqs
        return res

    def altered(self, q, res, dev=None):
        out = bytearray(render(self, q, res, dev))
        k = out.index(b"\n", out.index(b"$$$$$$$") + 9)
        out[k - 1] = ord("A") if out[k - 1] != ord("A") else ord("C")
        return bytes(out)

    def moved(self, q):
        res = compare(self, q)
        r, s = res.pairs[0]
        res.pairs[0] = (r, (s + 1) % self.db.n_seqs)
        return res

    if how == "render":
        monkeypatch.setattr(pipeline.TorchEngine, "render_report", altered)
    else:
        monkeypatch.setattr(pipeline.TorchEngine, "compare",
                            dict(unchanged=unchanged, half=half,
                                 moved=moved)[how])


@pytest.mark.parametrize("how", ["unchanged", "half", "moved", "render"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, how):
    """A compare that returns its state unchanged (no read done), one that
    leaves half the query reads out, an answer altered where the compare
    makes it, and a record altered where the render makes it.  (The cells
    run on one card: there is no exchange between chips to leave out.)"""
    _broken(monkeypatch, how)
    result, checks = run.measure(_files(), 5, 0.5, False, "cpu",
                                 lambda m: None)
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"]


def test_a_distant_run_holds_the_counts():
    result, checks = run.measure(_files("distant"), 9, 0.5, False, "cpu",
                                 lambda m: None)
    assert result["correct"]
    assert "candidates_off" in checks and "nw_cells_off" in checks


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the refusal is for machines "
                    "without one")
    out = subprocess.run(
        [sys.executable, f"{run.BENCH}/run.py", "--workload",
         "mock100k.pair", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_card_rehearsal():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = run.measure(_files(), 3, 0.5, True, "cuda",
                                 lambda m: None)
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0


def test_rare_accepts_are_each_held():
    from benchmark.reference import judge

    jobs = [dict(pairs=[(7, 1), (9, 2)]), dict(pairs=[(7, 1)])]
    assert list(judge.with_accepted(np.array([1, 2, 3]), jobs)) == \
        [1, 2, 3, 7, 9]
    many = [dict(pairs=[(r, 0) for r in range(10)])]
    assert list(judge.with_accepted(np.array([1, 2]), many)) == [1, 2]
