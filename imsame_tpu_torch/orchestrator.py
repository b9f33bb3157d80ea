"""All-vs-all orchestration over N samples (replaces the reference's
bash script bin/all_vs_all_metagenomes_IMSAME.sh).

Per unordered sample pair (i < j) two comparisons run, exactly like the
reference: query=X vs db=Y (forward, "X-Y.align") and query=X vs
db=revcomp(Y) ("X-Y.r.align"; the reference revComp tool emits reads in
reverse file order, which changes read indices in the report -- preserved
by going through the same revcomp code path).  Resume is file-based like
the reference's existence check (sh:35,45) but crash-safe: reports are
written to a temp name and atomically renamed on completion.

Multi-process task parallelism: pass (host_id, n_hosts) to stripe the
pair list across processes round-robin; each process only computes its
own share (``--distributed`` derives the stripe from the gloo process
group, see distributed.py).

Jobs run one after another on the calling thread: each compares and then
renders its report before the next starts (a thread in the background
only writes each new index to the cache).  The JAX orchestrator overlaps
a render worker and an engine prefetch with the compare; on one H100 that
design gave no gain the measurement could resolve (PERF.md), so the port
keeps the serial loop.

The runner keeps its own ``PhaseTimer`` (``runner.timer``), whose phases
are ``imsame.sweep.*`` ranges while a torch profiler records:
``sweep.read`` (FASTA parses of queries and forward dbs), ``sweep.revcomp``
(a db's reverse complement and its parse), ``sweep.index`` (the cache's
load or the build, and the save's start), ``sweep.engine`` (the engine's
construction and uploads), ``sweep.compare``, ``sweep.render``,
``sweep.write`` (each report and stats file, written and renamed) and
``sweep.save_wait`` (the cache's saves joined at the end); and its
counters ``sweep_jobs``, ``sweep_engine_builds``, ``sweep_index_builds``
(cache misses) with ``index_built_entries`` (the entries those builds
placed), ``sweep_index_loads`` (cache hits) and
``sweep_bytes_written`` (every report, stats file and cached index that
lands).  ``engine_timings`` and ``engine_counts`` sum the phases and
counters of every engine the runner built, its construction and each
job's share, so the LRU's evictions lose none of them.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .config import Config
from .index.kmer import build_index, load_index, save_index
from .io.fasta import (
    SeqInfo,
    parse_fasta_bytes,
    read_fasta,
    revcomp_fasta_bytes,
)
from .io.report import jaccard_index
from .pipeline import TorchEngine
from .utils.timing import PhaseTimer


@dataclasses.dataclass
class PairJob:
    qname: str
    dbname: str
    qpath: Path
    dbpath: Path
    reverse: bool  # db is reverse-complemented

    @property
    def out_name(self) -> str:
        suffix = ".r.align" if self.reverse else ".align"
        return f"{self.qname}-{self.dbname}{suffix}"


def list_samples(directory: str, ext: str) -> List[Tuple[str, Path]]:
    d = Path(directory)
    out = []
    for p in sorted(d.glob(f"*.{ext}")):
        out.append((p.name[: -(len(ext) + 1)], p))
    return out


def make_jobs(samples: List[Tuple[str, Path]]) -> List[PairJob]:
    jobs: List[PairJob] = []
    for i in range(len(samples)):
        for j in range(i + 1, len(samples)):
            (xn, xp), (yn, yp) = samples[i], samples[j]
            jobs.append(PairJob(xn, yn, xp, yp, reverse=False))
            jobs.append(PairJob(xn, yn, xp, yp, reverse=True))
    return jobs


class AllVsAllRunner:
    def __init__(
        self,
        outdir: str,
        cfg: Optional[Config] = None,
        host_id: int = 0,
        n_hosts: int = 1,
        max_engines: int = 2,
        max_queries: int = 4,
        index_cache: bool = True,
        device="cuda",
    ):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg or Config()
        self.host_id = host_id
        self.n_hosts = n_hosts
        # torch device every engine runs on; no fallback to the CPU
        self.device = device
        # Engines hold device-resident indexes (~8 B per db base): LRU-bound
        # so a many-sample sweep never holds more than max_engines samples'
        # tables on the device; jobs are grouped by (db, reverse) below so
        # eviction is rare.
        self.max_engines = max_engines
        self.max_queries = max_queries
        self.index_cache = index_cache
        self._engines: "collections.OrderedDict[Tuple[str, bool], TorchEngine]" = (
            collections.OrderedDict()
        )
        self._queries: "collections.OrderedDict[str, SeqInfo]" = (
            collections.OrderedDict()
        )
        # each cache save's thread and the size it landed (None until it
        # has), which the calling thread counts once the threads joined
        self._saves: List[Tuple[threading.Thread, list]] = []
        self._tmp_swept = False
        self.timer = PhaseTimer()
        self.engine_timings: Dict[str, float] = collections.defaultdict(float)
        self.engine_counts: Dict[str, int] = collections.defaultdict(int)

    def _add_engine_share(self, eng: TorchEngine, before=None) -> None:
        """Add to the sweep's engine sums what `eng`'s timer gained since
        `before` (its sums then, as (timings, counts); all of it where
        None)."""
        t0, c0 = before or ({}, {})
        for k, v in eng.timer.items():
            self.engine_timings[k] += v - t0.get(k, 0.0)
        for k, v in eng.timer.counts():
            self.engine_counts[k] += v - c0.get(k, 0)

    def _load_query(self, job: PairJob) -> SeqInfo:
        q = self._queries.get(job.qname)
        if q is None:
            # read_fasta streams >256 MB files in bounded memory
            with self.timer.phase("sweep.read"):
                q = read_fasta(str(job.qpath))
            self._queries[job.qname] = q
        self._queries.move_to_end(job.qname)
        while len(self._queries) > self.max_queries:
            self._queries.popitem(last=False)
        return q

    def _index_for(self, key: Tuple[str, bool], db: SeqInfo):
        """Per-sample persisted index: built once per (sample, strand) per
        sweep, reloaded on resume instead of rebuilt (the reference
        rebuilds from FASTA every run).  The .npz format is the JAX
        package's, so either package's sweep reads the other's cache."""
        if not self.index_cache:
            return None
        cache_dir = self.outdir / ".index"
        cache_dir.mkdir(exist_ok=True)
        if not self._tmp_swept:
            # a process killed mid-save leaves orphan {stem}.tmpXXXX.npz
            # files (never loaded; swept here on the next resumed sweep).
            # Only files older than an hour: another process sharing this
            # outdir may have an in-flight save on a younger tmp.
            self._tmp_swept = True
            cutoff = time.time() - 3600
            for orphan in cache_dir.glob("*.tmp*.npz"):
                try:
                    if orphan.stat().st_mtime < cutoff:
                        orphan.unlink()
                except OSError:
                    pass
        path = cache_dir / f"{key[0]}{'.r' if key[1] else ''}.npz"
        if path.exists():
            try:
                idx = load_index(str(path), db_start=db.start)
                if (
                    idx.db_total_len == db.total_len
                    and idx.db_n_seqs == db.n_seqs
                ):
                    self.timer.count("sweep_index_loads", 1)
                    return idx
            except Exception:
                pass  # corrupt/stale cache entry: rebuild below
        idx = build_index(db)
        self.timer.count("sweep_index_builds", 1)
        self.timer.count("index_built_entries", idx.n_entries)
        # Cache write off the critical path: the save only pays off on a
        # RESUMED sweep, so it runs in a background thread (numpy I/O
        # releases the GIL); the atomic rename keeps partial writes
        # invisible to readers.  Unique per save: a rebuild after LRU
        # eviction may overlap an earlier save thread for the same key,
        # and two writers on one tmp path would rename a corrupt entry.
        fd, tmp = tempfile.mkstemp(
            prefix=path.stem + ".tmp", suffix=".npz", dir=cache_dir
        )
        os.close(fd)
        landed = [None]

        def _persist():
            try:
                save_index(idx, tmp)
                size = os.path.getsize(tmp)
                os.replace(tmp, path)
                landed[0] = size
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                # cache miss next run; never fails the sweep

        t = threading.Thread(target=_persist, daemon=True)
        t.start()
        self._saves.append((t, landed))
        return idx

    def _build_engine(self, job: PairJob) -> TorchEngine:
        """Parse (+revcomp) the db sample and build its engine."""
        key = (job.dbname, job.reverse)
        timer = self.timer
        if job.reverse:
            # revComp reverses file order (src/reverseComplement.c:56)
            # -- inherently two-pass, so it stays whole-file
            with timer.phase("sweep.revcomp"):
                db = parse_fasta_bytes(
                    revcomp_fasta_bytes(job.dbpath.read_bytes())
                )
        else:
            with timer.phase("sweep.read"):
                db = read_fasta(str(job.dbpath))
        with timer.phase("sweep.index"):
            idx = self._index_for(key, db)
        with timer.phase("sweep.engine"):
            eng = TorchEngine(db, self.cfg, index=idx, device=self.device)
        timer.count("sweep_engine_builds", 1)
        self._add_engine_share(eng)
        return eng

    def _engine_for(self, job: PairJob) -> TorchEngine:
        key = (job.dbname, job.reverse)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._build_engine(job)
            self._engines[key] = eng
        self._engines.move_to_end(key)
        while len(self._engines) > max(self.max_engines, 1):
            self._engines.popitem(last=False)
        return eng

    def _run_job(self, job: PairJob) -> dict:
        """Compare, render and write one job's report and stats, each file
        atomically.  The recorded 'seconds' is the job's wall from loading
        its query to its rendered report, as the JAX tool records it."""
        timer = self.timer
        t0 = time.perf_counter()
        q = self._load_query(job)
        eng = self._engine_for(job)
        before = (dict(eng.timer.items()), dict(eng.timer.counts()))
        try:
            with timer.phase("sweep.compare"):
                res = eng.compare(q)
            with timer.phase("sweep.render"):
                report = eng.render_report(q, res)
        finally:
            self._add_engine_share(eng, before)
        seconds = time.perf_counter() - t0
        with timer.phase("sweep.write"):
            out_path = self.outdir / job.out_name
            tmp = out_path.with_suffix(out_path.suffix + ".tmp")
            tmp.write_bytes(report)
            os.replace(tmp, out_path)  # atomic completion marker
            entry = {
                "query": job.qname,
                "db": job.dbname,
                "reverse": job.reverse,
                "accepted": res.accepted,
                "n_query": res.n_query,
                "n_db": res.n_db,
                "jaccard": jaccard_index(res.accepted, res.n_query, res.n_db),
                "seconds": seconds,
                "nw_cells": res.nw_cells,
                "candidates": res.n_candidates,
            }
            text = json.dumps(entry)  # ASCII: one byte a character
            stats_path = self.outdir / (job.out_name + ".json")
            tmp_s = stats_path.with_suffix(".json.tmp")
            tmp_s.write_text(text)
            os.replace(tmp_s, stats_path)
        timer.count("sweep_bytes_written", len(report) + len(text))
        timer.count("sweep_jobs", 1)
        return entry

    def run(self, samples: List[Tuple[str, Path]]) -> Dict[str, dict]:
        """Run all pair jobs assigned to this process; returns per-pair
        stats.

        Jobs whose output file already exists are skipped (resume).  This
        process's jobs are grouped by (db, reverse) so the LRU engine
        cache (device-resident index + packed rows) is reused across every
        pair sharing a database sample."""
        self.timer.trace()
        jobs = [
            job
            for k, job in enumerate(make_jobs(samples))
            if k % self.n_hosts == self.host_id
        ]
        jobs.sort(key=lambda j: (j.dbname, j.reverse))
        stats: Dict[str, dict] = {}
        failures: Dict[str, str] = {}
        for job in jobs:
            out_path = self.outdir / job.out_name
            stats_path = self.outdir / (job.out_name + ".json")
            if out_path.exists():
                if stats_path.exists():
                    stats[job.out_name] = json.loads(stats_path.read_text())
                continue
            try:
                stats[job.out_name] = self._run_job(job)
            except Exception as e:  # failure isolation: one bad pair must
                # not kill the sweep; the missing output file marks the
                # job for retry on the next (resumed) run.
                failures[job.out_name] = f"{type(e).__name__}: {e}"
        if failures:
            fp = self.outdir / f"failures.host{self.host_id}.json"
            fp.write_text(json.dumps(failures, indent=1))
        self.failures = failures
        with self.timer.phase("sweep.save_wait"):
            for t, _ in self._saves:  # let cache writes land before exit
                t.join(timeout=60)
        for _, landed in self._saves:
            if landed[0] is not None:
                self.timer.count("sweep_bytes_written", landed[0])
        self._saves.clear()
        return stats


def main(argv=None, device="cuda") -> int:
    """The all-vs-all console script.  ``device`` is the torch device the
    engines run on (a keyword for tests, not a flag: the JAX tool has
    none)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="imsame-tpu-torch-all-vs-all",
        description="All-vs-all sample comparison "
        "(replaces all_vs_all_metagenomes_IMSAME.sh)",
    )
    p.add_argument("directory")
    p.add_argument("coverage", type=float)
    p.add_argument("similarity", type=float)
    p.add_argument("threads", type=int, help="accepted for CLI parity")
    p.add_argument("extension")
    p.add_argument("outpath")
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--n-hosts", type=int, default=1)
    p.add_argument(
        "--distributed",
        action="store_true",
        help="join a gloo process group from IMSAME_COORDINATOR / "
        "IMSAME_NUM_PROCESSES / IMSAME_PROCESS_ID and derive the pair "
        "stripe from the process id (imsame_tpu_torch/distributed.py)",
    )
    a = p.parse_args(argv)
    host_id, n_hosts = a.host_id, a.n_hosts
    ctx = None
    if a.distributed:
        from .distributed import init_distributed

        ctx = init_distributed()
        host_id, n_hosts = ctx.process_id, ctx.num_processes
    try:
        cfg = Config(min_coverage=a.coverage, min_identity=a.similarity)
        runner = AllVsAllRunner(a.outpath, cfg, host_id, n_hosts,
                                device=device)
        stats = runner.run(list_samples(a.directory, a.extension))
        for name, s in sorted(stats.items()):
            print(f"{name}: accepted={s['accepted']} "
                  f"jaccard={s['jaccard']:.6e}")
        if ctx is not None and ctx.is_distributed:
            # Merge the sweep-level tally across processes: every process
            # prints the same global number.
            from .distributed import allreduce_sum

            total = allreduce_sum(
                sum(s["accepted"] for s in stats.values()), ctx
            )
            print(
                f"[INFO] Distributed sweep total accepted reads: {total} "
                f"({ctx.num_processes} processes)"
            )
    finally:
        if ctx is not None and ctx.is_distributed:
            import torch.distributed

            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
