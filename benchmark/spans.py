#!/usr/bin/env python3
"""One traced window of a cell, read for the program's own ranges and
counters, which `run.py`'s line does not carry:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

Set-up and window as `run.py --trace 1` makes them (the cell's inputs
from the seed, a warm job, then jobs back to back under torch.profiler),
with no check against the reference.  Prints one JSON line: the jobs and
their mean time on the host clock, the window's busy and idle seconds,
all its idle seconds by the program phase they fall in
(`idle_by_span`), the program's phase seconds and ranges a job, and its
counters a job (`h2d_bytes` as `upload_mb`, `nw_cells` over
`nw_launched_cells` as `accept_cell_yield`).  A program that opens no `imsame.*` ranges or keeps
no counters leaves those entries empty.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def window(files: dict, seed: int, seconds: float, device: str) -> dict:
    import numpy as np
    import torch
    from benchmark import run
    from benchmark.harness import program
    from benchmark.harness.trace import Trace

    config = run.load_json(files["config"])
    traffic = run.load_json(files["traffic"])
    gen = run.load_module(os.path.join(BENCH, "gen",
                                       config["generator"] + ".py"))
    kind = run.load_module(os.path.join(BENCH, "jobs",
                                        traffic["job"] + ".py"))
    data = gen.generate(config, traffic,
                        np.random.default_rng(seed % (1 << 64)))
    job = kind.Job(config, data, device)
    made, Engine = [], job.Engine

    def engine(*a, **kw):  # keeps each job's engine for its counters
        made.append(Engine(*a, **kw))
        return made[-1]

    job.Engine = engine
    job.run()
    made.clear()
    if device != "cpu":
        torch.cuda.synchronize()

    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if device != "cpu" else [])
    jobs, counts = [], {}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            jobs.append(job.run())
            eng = made.pop()
            for k, v in getattr(eng.timer, "counts", dict)():
                counts[k] = counts.get(k, 0) + v
            del eng
    tr = Trace.from_profiler(prof)
    prog = program.ranges(prof)
    del prof
    n = len(jobs)
    inside = [r for r in prog if tr.t0 <= r[1] and r[2] <= tr.t1]
    phases = sorted({r[0] for r in inside})
    phase_s = {p: program.span_s(inside, tr.t0, tr.t1, [p]) / n
               for p in phases}
    launched = counts.get("nw_launched_cells", 0)
    out = dict(
        jobs=n,
        job_s=sum(sum(j["spans"].values()) for j in jobs) / n,
        window_s=tr.window_s, busy_s=tr.busy_s,
        idle_s=tr.window_s - tr.busy_s,
        idle_by_span=program.idle_by_span(tr, prog, None),
        ranges_per_job=len(inside) / n,
        phase_s=dict(sorted(phase_s.items(), key=lambda kv: -kv[1])),
        counters={k: v / n for k, v in sorted(counts.items())},
    )
    if "h2d_bytes" in counts:
        out["upload_mb"] = counts["h2d_bytes"] / 1e6 / n
    if launched:
        out["accept_cell_yield"] = 100.0 * sum(
            j["nw_cells"] for j in jobs) / launched
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]
    from benchmark import run
    files = run.cell_files(args.workload)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    out = window(files, args.seed, args.seconds, "cuda")
    out["card"] = torch.cuda.get_device_name()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
