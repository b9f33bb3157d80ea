"""The busy union, the idle gaps, the roofline share and the e-value
boundary against hand-worked cases."""

import numpy as np
import pytest

from benchmark.harness import peaks, trace
from benchmark.reference import semantics


def test_busy_union_counts_overlaps_once():
    assert trace.busy_union([]) == 0.0
    assert trace.busy_union([(0, 1), (2, 3)]) == 2.0
    assert trace.busy_union([(0, 2), (1, 3)]) == 3.0
    assert trace.busy_union([(1, 3), (0, 10), (4, 5)]) == 10.0


def test_idle_gaps_within_the_window():
    assert trace.idle_gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert trace.idle_gaps([(0, 3), (1, 2)], 0, 3) == []
    assert trace.idle_gaps([], 2, 3) == [(2, 3)]


def test_trace_labels_and_tops():
    tr = trace.Trace(
        [("k1", 1.0, 1.5), ("k2", 1.5, 1.6), ("k1", 3.0, 3.5)],
        [("bench.job", 0.5, 4.0), ("bench.compare", 0.9, 2.5),
         ("bench.render", 2.5, 4.0)], 0.5, 4.0)
    assert tr.busy_s == pytest.approx(1.1)
    assert tr.window_s == pytest.approx(3.5)
    assert tr.kernel_s(r"^k1$") == pytest.approx(1.0)
    assert tr.top_ops()[0][0] == "k1"
    gaps = tr.top_gaps()
    assert gaps[0][0].startswith("compare +0.700") and gaps[0][1] == \
        pytest.approx(1.4)
    assert sorted(g[0][:10] for g in gaps[1:]) == ["job +0.000", "render +1."]


def test_roofline_share_by_hand():
    card = dict(sms=132, sm_hz=1.98e9)
    rate = 132 * 64 * 1.98e9
    # cells that take exactly one second at the integer rate
    cells = int(rate / 25)
    assert peaks.cells_roofline_pct(cells, 1.0, card) == pytest.approx(
        100.0, rel=1e-6)
    assert peaks.cells_roofline_pct(cells, 4.0, card) == pytest.approx(
        25.0, rel=1e-6)
    assert peaks.cells_roofline_pct(0, 1.0, card) is None
    assert peaks.cells_roofline_pct(10, 0.0, card) is None


def test_evalue_boundary_is_the_least_passing_score():
    qlens = np.array([250, 300, 1650, 3000])
    for total in (25_000_000, 33_000_000):
        thr = semantics.min_passing_raw(qlens, total, 1e-20)
        assert semantics.evalue_passes(qlens, total, thr, 1e-20).all()
        assert not semantics.evalue_passes(qlens, total, thr - 1,
                                           1e-20).any()
    # (ln(0.333 * 250 * 25e6) - ln(1e-20)) / 0.275 = 245.47...
    assert semantics.min_passing_raw([250], 25_000_000, 1e-20)[0] == 246


def test_percent_is_the_floor_clamped():
    assert semantics.percent(240, 250) == 96
    assert semantics.percent(249, 250) == 99
    assert semantics.percent(300, 250) == 100
