"""Every configuration, traffic mix, job kind and metric that
BENCHMARK.json names is a file of its own that the harness finds by name,
and each agrees with BENCHMARK.json and with the contract's forms."""

import glob
import json
import os
import re

from benchmark import run

SPEC = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _stems(d, ext):
    return sorted(os.path.basename(p)[:-len(ext)]
                  for p in glob.glob(os.path.join(run.BENCH, d, "*" + ext)))


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = 24
    assert 2 + 14 * n * (SPEC["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) < 65536


def test_configs_are_files_found_by_name():
    names = [c["name"] for c in SPEC["configs"]]
    assert sorted(names) == _stems("configs", ".json")
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = run.load_json(os.path.join(run.ROOT, c["file"]))
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in body for k in c["reduced"])
        assert c["name"] in used
        assert os.path.exists(os.path.join(
            run.BENCH, "gen", body["generator"] + ".py"))
        assert 1 <= len(c["source"]) <= 200 and NAME.match(c["name"])


def test_cells_find_their_files_by_name():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    pairs = set()
    for name, w in cells.items():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        files = run.cell_files(name)
        assert files["cell"] == w and os.path.exists(files["config"])
        traffic = run.load_json(files["traffic"])
        assert os.path.exists(os.path.join(run.BENCH, "jobs",
                                           traffic["job"] + ".py"))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
        assert NAME.match(name) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        assert "setup_s" in files["e2e"] and len(files["e2e"]) >= 2
        assert files["layers"]
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)


def test_metrics_are_readers_found_by_name():
    assert sorted(m["name"] for m in SPEC["per_layer"]) == \
        _stems("metrics", ".py")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        mod = run.load_module(os.path.join(run.BENCH, "metrics",
                                           m["name"] + ".py"))
        assert callable(mod.read)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m.get("workloads", cells)) <= cells
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert {"reads_per_s", "setup_s"} <= e2e


def test_the_json_files_parse():
    for p in glob.glob(os.path.join(run.BENCH, "**", "*.json"),
                       recursive=True):
        with open(p) as f:
            json.load(f)
