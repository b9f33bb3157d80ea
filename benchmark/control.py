#!/usr/bin/env python3
"""The control of the benchmark's comparison, on the card at a cell's own
size: for each seed, the plain reference's answers against the control's
(the reference with each read walking only the first
`judge.CONTROL_WINDOW` candidates of its stream) in the program's place,
through the same comparison as a run's.  Prints one JSON line a seed with
each number and its limit; the control fails where a number passes its
limit.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def control_checks(files: dict, seed: int, device: str) -> dict:
    import numpy as np
    from benchmark import run
    from benchmark.reference import judge

    config = run.load_json(files["config"])
    traffic = run.load_json(files["traffic"])
    gen = run.load_module(os.path.join(BENCH, "gen",
                                       config["generator"] + ".py"))
    seed64 = seed % (1 << 64)
    data = gen.generate(config, traffic, np.random.default_rng(seed64))
    ans, rec = judge.plan(config, run._lens(data["q_starts"],
                                            len(data["q_codes"])),
                          np.random.default_rng([seed64, 1]))
    ref = judge.Reference(data, config["thresholds"], device)
    want = judge.reference_view(ref, ans, rec, full=False)
    full = all(s is None for s in want["won"].values())
    if full:
        want["counts"] = ref.full_counts()
    ctrl = judge.Reference(data, config["thresholds"], device,
                           window=judge.CONTROL_WINDOW)
    got = judge.control_view(ctrl, ans, rec, full)
    checks = judge.compare(want, [got], full)
    print("reference " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                    ref.seconds.items()), file=sys.stderr)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != BENCH]
    import torch
    from benchmark import run
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    files = run.cell_files(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_checks(files, seed, "cuda")
        fails = [k for k, (v, lim) in checks.items() if v > lim]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "control_fails": fails,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
