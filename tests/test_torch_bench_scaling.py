"""The port's scaling scan (imsame_tpu_torch.bench_scaling) on the CPU:
its main at 300 reads a side over eight CPU positions prints one JSON
line a grid, each with the one-device engine's accepted count, and a
summary whose overhead covers every grid; it refuses a CUDA device on a
machine with no card.  (On the CPU the kernel wrappers take their plain
versions, so no kernel launches.)

The plain NW functions compute each pair row once per test
(tests/test_torch_sharded.py plain_rows_once)."""

import json

import pytest
import torch

from imsame_tpu_torch import bench_scaling
from test_torch_sharded import plain_rows_once  # noqa: F401 (fixture)

MESHES = ["single", "2x1", "4x1", "8x1", "4x2", "2x4", "1x8"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_scaling_scan_on_cpu(plain_rows_once, capsys):
    assert bench_scaling.main(["--device", "cpu", "--reads", "300"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    grids, summary = lines[:-1], lines[-1]
    assert [g["mesh"] for g in grids] == MESHES
    for g in grids:
        assert g["accepted"] == 150
        assert g["seconds"] == min(g["seconds_runs"]) > 0
        assert len(g["seconds_runs"]) == bench_scaling.TIMED_RUNS
        assert g["reads_per_s"] == pytest.approx(300 / g["seconds"])
        # this compare's phases, not the engine's index build
        assert "resolve.nw" in g["phases"] and "index_build" not in g["phases"]
        assert g["launches"] == dict.fromkeys(bench_scaling.COUNTED, 0)
    assert set(summary) == {"metric", "overhead_by_mesh",
                            "reads_per_s_by_mesh", "n_reads", "device",
                            "cards", "name_power_limit", "note"}
    assert list(summary["overhead_by_mesh"]) == MESHES[1:]
    for g in grids[1:]:
        assert summary["overhead_by_mesh"][g["mesh"]] == pytest.approx(
            g["seconds"] / grids[0]["seconds"])
    assert summary["n_reads"] == 300
    assert (summary["device"], summary["cards"]) == ("cpu", 1)
    assert summary["name_power_limit"] is None
    assert "not speedup" in summary["note"]


def test_scaling_scan_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scaling.main(["--reads", "300"])

