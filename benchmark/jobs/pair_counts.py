"""Job kind `pair_counts`: `pair`'s job (a fresh engine over the db, the
compare and the report rendered, each ended by a synchronise), whose
result also carries the engine's counters (`counters`, the program's
`engine.timer.counts()`).  The engine is fresh each job, so they are the
job's own counts."""

from __future__ import annotations

from benchmark.jobs.pair import Job as PairJob, end_to_end  # noqa: F401


class Job(PairJob):
    def __init__(self, config: dict, data: dict, device: str):
        super().__init__(config, data, device)
        build = self.Engine

        def engine(*a, **kw):
            self.eng = build(*a, **kw)
            return self.eng

        self.Engine = engine
        self.eng = None

    def run(self) -> dict:
        out = super().run()
        out["counters"] = dict(self.eng.timer.counts())
        self.eng = None
        return out
