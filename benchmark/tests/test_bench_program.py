"""The program's own ranges and counters as the benchmark reads them:
`harness/program.py` on a hand-worked trace and on a profiler's, the two
readers of the program's phase sums, and `spans.py`'s window on the CPU
with the tiny configuration."""

import pytest

from benchmark import run, spans
from benchmark.harness import program, trace

LAYERS = {m["name"]: m["unit"] for m in run.load_json(
    f"{run.ROOT}/BENCHMARK.json")["per_layer"]}


def _files():
    return dict(cell=dict(name="tiny.pair", config="tiny", traffic="pair",
                          chips=1),
                e2e=["reads_per_s", "setup_s"], layers=LAYERS,
                config=f"{run.BENCH}/tests/data/tiny.json",
                traffic=f"{run.BENCH}/traffic/pair.json")


def _program_trace():
    """A window of [0, 10] s, the device busy in [1, 2] and [6, 7]: idle
    gaps [0, 1], [2, 6] (across compare's and render_report's ranges and
    the time between them) and [7, 10] (its last second outside every
    range); one range reaching back before the window, two that start
    together."""
    prog = [("engine", -1.0, 0.25), ("compare", 0.5, 5.0),
            ("resolve", 1.5, 4.5), ("gate.fetch", 3.0, 3.5),
            ("render_report", 5.5, 9.0), ("render.dispatch", 5.5, 5.8),
            ("render.fetch", 6.5, 8.0)]
    tr = trace.Trace([("k", 1.0, 2.0), ("k", 6.0, 7.0)],
                     [("bench.job", 0.0, 10.0)], 0.0, 10.0)
    return tr, prog


def test_span_seconds_inside_the_window():
    tr, prog = _program_trace()
    assert program.span_s(prog, tr.t0, tr.t1, ["render_report"]) == \
        pytest.approx(3.5)
    assert program.span_s(prog, tr.t0, tr.t1,
                          ["gate.fetch", "render.fetch"]) == \
        pytest.approx(2.0)
    assert program.span_s(prog, tr.t0, tr.t1, ["engine"]) == \
        pytest.approx(0.25)
    assert program.span_s(prog, tr.t0, tr.t1, ["no such phase"]) == 0.0


def test_idle_time_by_innermost_span():
    tr, prog = _program_trace()
    got = dict(program.idle_by_span(tr, prog))
    want = {program.OUTSIDE: 0.25 + 0.5 + 1.0, "engine": 0.25,
            "compare": 1.0, "resolve": 2.0, "gate.fetch": 0.5,
            "render.dispatch": 0.3, "render_report": 0.2 + 1.0,
            "render.fetch": 1.0}
    assert got.keys() == want.keys()
    for name, s in want.items():
        assert got[name] == pytest.approx(s), name
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s)
    top = program.idle_by_span(tr, prog, 2)
    assert [n for n, _ in top] == ["resolve", program.OUTSIDE]
    assert len(program.idle_by_span(tr, prog, None)) == len(want)
    # no program ranges: every idle second is outside the program
    assert program.idle_by_span(tr, []) == \
        [[program.OUTSIDE, pytest.approx(8.0)]]


def test_the_programs_ranges_from_the_profiler():
    import torch

    rf = torch.profiler.record_function
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with rf("bench.job"):
            with rf("imsame.compare"):
                with rf("imsame.resolve"):
                    torch.ones(8).sum()
    tr = trace.Trace.from_profiler(prof)
    prog = program.ranges(prof)
    assert sorted(n for n, _, _ in prog) == ["compare", "resolve"]
    assert [n for n, _, _ in tr.ranges] == ["bench.job"] and tr.ops == []
    (_, c0, c1), = [r for r in prog if r[0] == "compare"]
    (_, r0, r1), = [r for r in prog if r[0] == "resolve"]
    assert tr.t0 <= c0 <= r0 <= r1 <= c1 <= tr.t1
    assert program.span_s(prog, tr.t0, tr.t1, ["compare"]) == \
        pytest.approx(c1 - c0)


@pytest.mark.parametrize("name", ["render_host_s", "host_wait_s"])
def test_readers_of_the_phase_sums(name):
    """Each reads the jobs' render phases, and leaves its metric out for
    a program whose results carry none."""
    mod = run.load_module(f"{run.BENCH}/metrics/{name}.py")

    class Ctx:
        jobs = [dict(timings={"render_report": 0.5, "render.fetch": 0.1,
                              "gate.fetch": 0.02, "nw.fetch1": 0.03}),
                dict(timings={"render_report": 0.3, "gate.fetch": 0.04})]

    want = {"render_host_s": (0.4 + 0.3) / 2,
            "host_wait_s": (0.15 + 0.04) / 2}[name]
    assert mod.read(Ctx) == pytest.approx(want)
    Ctx.jobs = [dict(timings={"render": 0.01, "gate.fetch": 0.02})]
    assert mod.read(Ctx) is None
    Ctx.jobs = []
    assert mod.read(Ctx) is None


def test_cpu_rehearsal_reads_the_programs_phases():
    result, _ = run.measure(_files(), 2**31 + 91, 0.5, True, "cpu",
                            lambda m: None)
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"render_host_s", "host_wait_s"} <= set(m)
    assert 0 < m["render_host_s"] <= m["render_s"]
    assert 0 <= m["host_wait_s"] < m["compare_s"] + m["render_s"]


def test_cpu_window_of_spans_and_counters():
    """The idle time by phase, nearly all of it inside the program's
    ranges, and the counters a job."""
    out = spans.window(_files(), 2**31 + 93, 0.5, "cpu")
    assert out["jobs"] >= 1 and out["ranges_per_job"] > 0
    idle = dict(out["idle_by_span"])
    assert idle.get(program.OUTSIDE, 0.0) < 0.1 * sum(idle.values())
    assert {"engine", "compare", "render_report"} <= set(out["phase_s"])
    assert out["upload_mb"] > 0
    assert 0 < out["accept_cell_yield"] <= 100
    assert set(out["counters"]) == {"h2d_bytes", "nw_launched_cells"}
