"""Job kind `sweep`: one whole all-vs-all sweep a job, as the console
script `imsame-tpu-torch-all-vs-all` runs it: a fresh `AllVsAllRunner`
with its defaults (an LRU of 2 engines and 4 queries, the index cache on)
over a folder of FASTA samples, into a fresh outdir; every unordered
sample pair X < Y against db Y and against its reverse complement.  Set-up
writes the samples as `s0.fasta`, `s1.fasta`, ... (one line a read) into
a folder of its own under the temporary directory.

A job raises where a compare failed or a report is missing: a failed
compare must not pass for a faster sweep.  Its result holds the compare
the generator designated (`gen/samples.py`: X-Y.r), read back from disk:
the report from `X-Y.r.align`, the pairs from its records' headers, and
the accepted reads, candidates and NW cells from its stats file; and the
pass's query reads, every compare's.  `timings` and `counters` are the
runner's phases and counters with its engines' sums; the spans are the
runner's phases: `index_build_s` = `sweep.index` + `sweep.engine`,
`compare_s` = `sweep.compare`, `render_s` = `sweep.render`.  The outdir
is removed before the job returns."""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import weakref

import numpy as np

from benchmark.jobs.pair import end_to_end  # noqa: F401

_HEAD = re.compile(rb"^\((\d+), (\d+)\) : ", re.M)
_LETTERS = np.frombuffer(b"ACGT", np.uint8)


def write_fasta(path: str, name: str, codes: np.ndarray,
                starts: np.ndarray) -> None:
    ends = np.append(starts[1:], len(codes))
    seq = _LETTERS[codes].tobytes()
    with open(path, "wb") as f:
        f.write(b"".join(b">%s_%d\n%s\n" % (name.encode(), i, seq[a:b])
                         for i, (a, b) in enumerate(zip(starts, ends))))


class Job:
    def __init__(self, config: dict, data: dict, device: str):
        import torch
        from imsame_tpu_torch.config import Config
        from imsame_tpu_torch.orchestrator import AllVsAllRunner, list_samples

        self.torch, self.device = torch, device
        self.Runner, self.Config = AllVsAllRunner, Config
        self.cfg = config["thresholds"]
        self.dir = tempfile.mkdtemp(prefix="sweep-samples-")
        weakref.finalize(self, shutil.rmtree, self.dir, True)
        for k, s in enumerate(data["samples"]):
            write_fasta(os.path.join(self.dir, f"s{k}.fasta"), f"s{k}",
                        s["codes"], s["starts"])
        self.samples = list_samples(self.dir, "fasta")
        x, y = data["designated"]
        self.designated = f"s{x}-s{y}.r.align"
        k = len(self.samples)
        self.n_reports = k * (k - 1)

    def run(self) -> dict:
        rf = self.torch.profiler.record_function
        out = tempfile.mkdtemp(prefix="sweep-out-")
        try:
            with rf("bench.job"):
                runner = self.Runner(out, self.Config(**self.cfg),
                                     device=self.device)
                timer = runner.timer
                stats = runner.run(self.samples)
                if self.device != "cpu":
                    self.torch.cuda.synchronize()
            if runner.failures or len(stats) != self.n_reports:
                raise RuntimeError(
                    f"the sweep made {len(stats)} of {self.n_reports} "
                    f"reports; failures: {runner.failures}")
            with open(os.path.join(out, self.designated), "rb") as f:
                report = f.read()
            with open(os.path.join(out, self.designated + ".json")) as f:
                entry = json.load(f)
        finally:
            shutil.rmtree(out, ignore_errors=True)
        phases = dict(timer.items())

        def span(*names):
            return sum(phases.get(n, 0.0) for n in names)

        return dict(
            report=report,
            pairs=[(int(r), int(s)) for r, s in _HEAD.findall(report)],
            accepted=entry["accepted"], n_candidates=entry["candidates"],
            nw_cells=entry["nw_cells"],
            timings={**runner.engine_timings, **phases},
            counters={**runner.engine_counts, **dict(timer.counts())},
            reads=sum(s["n_query"] for s in stats.values()),
            spans=dict(index_build_s=span("sweep.index", "sweep.engine"),
                       compare_s=span("sweep.compare"),
                       render_s=span("sweep.render")))
