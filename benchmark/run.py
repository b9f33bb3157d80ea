#!/usr/bin/env python3
"""The benchmark of imsame_tpu_torch: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of `BENCHMARK.json`'s `workloads`) names a configuration
(`configs/`, the read sets' sizes and the compare's thresholds) and a
traffic mix (`traffic/`, the parameters the configuration's generator in
`gen/` reads, and the job kind in `jobs/`).  Set-up makes the inputs from the seed and runs one
job; the window then runs jobs back to back, one client, until
`--seconds` have passed, and ends with the job in flight.  With
`--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (`metrics/<name>.py`, each a reader of
the traced window).  Every run then holds the window's outputs to the
plain reference (`reference/`) and prints each number compared beside its
limit, last on standard error and as the last key of the result's line,
the last line of standard output.  It needs a CUDA card and never falls
back to the CPU.  The program builds its kernels into the checkout's
`build/` on a checkout's first run; later runs load them from there.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "imsame_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader sees: the traced window's jobs,
    its trace, the card and the inputs."""

    def __init__(self, jobs, trace, card, data):
        self.jobs, self.trace, self.card = jobs, trace, card
        self.q_lens = _lens(data["q_starts"], len(data["q_codes"]))
        self.db_lens = _lens(data["db_starts"], len(data["db_codes"]))

    def mean_span(self, name: str):
        if not self.jobs:
            return None
        return sum(j["spans"][name] for j in self.jobs) / len(self.jobs)

    def pair_cells(self, pairs) -> int:
        import numpy as np
        if not pairs:
            return 0
        p = np.asarray(pairs, np.int64)
        return int((self.q_lens[p[:, 0]] * self.db_lens[p[:, 1]]).sum())

    def roofline(self, cells: int, kernel_s: float):
        from benchmark.harness import peaks
        return peaks.cells_roofline_pct(cells, kernel_s, self.card)


def _lens(starts, total):
    import numpy as np
    starts = np.asarray(starts, np.int64)
    return np.diff(np.append(starts, total))


def cell_files(name: str) -> dict:
    """A cell of BENCHMARK.json, with the files of its configuration and
    traffic mix and the units of its metrics, found by name."""
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c["file"] for c in spec["configs"]}
    e2e = [m["name"] for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    layers = {m["name"]: m["unit"] for m in spec["per_layer"]
              if name in m.get("workloads", [name])}
    return dict(cell=cell, e2e=e2e, layers=layers,
                config=os.path.join(ROOT, configs[cell["config"]]),
                traffic=os.path.join(BENCH, "traffic",
                                     cell["traffic"] + ".json"))


def measure(files: dict, seed: int, seconds: float, trace: bool,
            device: str, log=print) -> tuple:
    """Set-up, window, metrics and the reference's comparison.  Returns
    (result dict, checks dict)."""
    import numpy as np
    import torch
    from benchmark.harness import peaks
    from benchmark.harness.trace import Trace
    from benchmark.reference import judge

    config, traffic = load_json(files["config"]), load_json(files["traffic"])
    gen = load_module(os.path.join(BENCH, "gen", config["generator"] + ".py"))
    kind = load_module(os.path.join(BENCH, "jobs", traffic["job"] + ".py"))
    seed64 = seed % (1 << 64)
    data = gen.generate(config, traffic, np.random.default_rng(seed64))
    job = kind.Job(config, data, device)
    job.run()  # the warm job: every shape of this cell's traffic
    if device != "cpu":
        torch.cuda.synchronize()
    gc.collect()
    setup_s = process_age()
    log(f"set-up {setup_s:.3f} s")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    jobs = []
    prof = None
    if trace:
        act = torch.profiler.ProfilerActivity
        acts = [act.CPU] + ([act.CUDA] if device != "cpu" else [])
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        jobs.append(job.run())
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    log(f"window {window_s:.3f} s, {len(jobs)} jobs: " + " ".join(
        f"{sum(j['spans'].values()):.3f}" for j in jobs))

    card = dict(name="cpu", sms=0, sm_hz=0.0, power_limit_w=0.0)
    peak = 0
    if device != "cpu":
        card = peaks.read_card(torch)
        peak = torch.cuda.max_memory_allocated()
    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": card["name"], "count": 1,
                "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(jobs), "failed": 0}
    if trace:
        t_read = time.perf_counter()
        tr = Trace.from_profiler(prof)
        del prof
        ctx = Context(jobs, tr, card, data)
        metrics = {}
        for name, unit in files["layers"].items():
            mod = load_module(os.path.join(BENCH, "metrics", name + ".py"))
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.top_gaps()}
        log(f"trace read in {time.perf_counter() - t_read:.3f} s")
    else:
        metrics = {k: v for k, v in kind.end_to_end(jobs, window_s).items()
                   if k in files["e2e"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result["metrics"] = metrics
    result["device"] = dev_info
    log(f"card {card['name']}, power limit {card['power_limit_w']} W, "
        f"peak device memory {peak} B")

    # the reference, once the program's state is freed
    ans_reads, rec_reads = judge.plan(
        config, _lens(data["q_starts"], len(data["q_codes"])),
        np.random.default_rng([seed64, 1]))
    ans_reads = judge.with_accepted(ans_reads, jobs)
    views = [judge.job_view(j, ans_reads, rec_reads) for j in jobs]
    full = all(v["accepted"] == 0 for v in views)
    del job, jobs
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = judge.Reference(data, config["thresholds"], device)
    want = judge.reference_view(ref, ans_reads, rec_reads, full)
    checks = judge.compare(want, views, full)
    log(f"reference {time.perf_counter() - t_ref:.3f} s: answers of "
        f"{len(ans_reads)} reads, records of {len(rec_reads)}, of "
        f"{len(views)} jobs; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in ref.seconds.items()))
    result["failed"] = 0 if all(v <= lim for v, lim in checks.values()) \
        else len(views)
    result["correct"] = result["failed"] == 0 and len(views) > 0
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]
    files = cell_files(args.workload)
    # One process with few threads: the program's host work is numpy and
    # its own native threads, so the pools of torch and of the BLAS
    # libraries, idle on its path, keep one thread each and spin on no
    # core that the native threads need.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < files["cell"]["chips"]):
        print(f"{args.workload} needs {files['cell']['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    result, checks = measure(files, args.seed, args.seconds,
                             bool(args.trace), "cuda", log)
    found = forbidden_modules()
    if found:
        print("loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
