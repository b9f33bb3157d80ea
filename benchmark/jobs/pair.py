"""Job kind `pair`: one comparison of a query sample against a db sample,
as `imsame_torch -query Q -db D` runs it without reading FASTA or
writing the file: a fresh engine over the db (the index built and put on
the card), the compare, and the report rendered, each ended by a
synchronise.  Spans are the benchmark's own, on the host clock."""

from __future__ import annotations

import time

import numpy as np


def _seqinfo(SeqInfo, codes: np.ndarray, starts: np.ndarray):
    fresh = np.zeros(len(codes), bool)
    fresh[starts] = True
    return SeqInfo(codes=codes, start=starts, fresh=fresh,
                   headers=[b""] * len(starts))


class Job:
    def __init__(self, config: dict, data: dict, device: str):
        import torch
        from imsame_tpu_torch.config import Config
        from imsame_tpu_torch.io.fasta import SeqInfo
        from imsame_tpu_torch.pipeline import TorchEngine

        self.torch, self.Config, self.Engine = torch, Config, TorchEngine
        self.device = device
        self.cfg = config["thresholds"]
        self.q = _seqinfo(SeqInfo, data["q_codes"], data["q_starts"])
        self.db = _seqinfo(SeqInfo, data["db_codes"], data["db_starts"])
        self.n_reads = len(data["q_starts"])

    def _sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def run(self) -> dict:
        rf = self.torch.profiler.record_function
        with rf("bench.job"):
            t0 = time.perf_counter()
            with rf("bench.engine_build"):
                eng = self.Engine(self.db, self.Config(**self.cfg),
                                  device=self.device)
                self._sync()
            t1 = time.perf_counter()
            with rf("bench.compare"):
                res = eng.compare(self.q)
                self._sync()
            t2 = time.perf_counter()
            with rf("bench.render"):
                report = eng.render_report(self.q, res)
                self._sync()
            t3 = time.perf_counter()
        out = dict(report=report, pairs=res.pairs, accepted=res.accepted,
                   n_candidates=res.n_candidates, nw_cells=res.nw_cells,
                   timings=dict(res.timings), reads=self.n_reads,
                   spans=dict(index_build_s=t1 - t0, compare_s=t2 - t1,
                              render_s=t3 - t2))
        del eng, res
        return out


def end_to_end(jobs: list, window_s: float) -> dict:
    """Query reads of the window's jobs over the window's seconds."""
    return {"reads_per_s": {"value": sum(j["reads"] for j in jobs) / window_s,
                            "unit": "reads/s"}}
