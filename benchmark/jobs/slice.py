"""Job kind `slice`: one query slice compared against a resident engine,
as a group runs a whole query sample through one db index slice by
slice (`bench_config3.py`).  The engine over the db (its index built and
put on the card) is built once, with the kind, so its build falls in
set-up; it must hold the wide index (`index.packed` is None: the db has
2^20 reads or more).  Each job is the slice's compare and its report
rendered, each ended by a synchronise, with `pair`'s result keys.  The
span `index_build_s` is 0.0: no index is built inside a job.

The engine's phase sums and counters add up over its life, so a job
carries its own share of them: the sums and counters after the job less
those before (`timings`, `counters`).

The process keeps the host memory a compare frees for the next one
(`imsame_tpu_torch.utils.hostmem.retain_freed_memory`), as a process
that serves one resident engine does."""

from __future__ import annotations

import time

from benchmark.jobs.pair import _seqinfo, end_to_end  # noqa: F401
from imsame_tpu_torch.utils.hostmem import retain_freed_memory


def _since(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


class Job:
    def __init__(self, config: dict, data: dict, device: str):
        import torch
        from imsame_tpu_torch.config import Config
        from imsame_tpu_torch.io.fasta import SeqInfo
        from imsame_tpu_torch.pipeline import TorchEngine

        retain_freed_memory()
        self.torch, self.device = torch, device
        self.q = _seqinfo(SeqInfo, data["q_codes"], data["q_starts"])
        db = _seqinfo(SeqInfo, data["db_codes"], data["db_starts"])
        self.n_reads = len(data["q_starts"])
        self.eng = TorchEngine(db, Config(**config["thresholds"]),
                               device=device)
        self._sync()
        if self.eng.index.packed is not None:
            raise ValueError(
                f"a db of {db.n_seqs} reads took the packed index; the "
                f"slice kind measures the wide one")

    def _sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def run(self) -> dict:
        rf = self.torch.profiler.record_function
        timer = self.eng.timer
        t_before, c_before = dict(timer.items()), dict(timer.counts())
        with rf("bench.job"):
            t1 = time.perf_counter()
            with rf("bench.compare"):
                res = self.eng.compare(self.q)
                self._sync()
            t2 = time.perf_counter()
            with rf("bench.render"):
                report = self.eng.render_report(self.q, res)
                self._sync()
            t3 = time.perf_counter()
        return dict(report=report, pairs=res.pairs, accepted=res.accepted,
                    n_candidates=res.n_candidates, nw_cells=res.nw_cells,
                    timings=_since(dict(timer.items()), t_before),
                    counters=_since(dict(timer.counts()), c_before),
                    reads=self.n_reads,
                    spans=dict(index_build_s=0.0, compare_s=t2 - t1,
                               render_s=t3 - t2))
