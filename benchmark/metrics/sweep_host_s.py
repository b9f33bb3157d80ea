"""Seconds a sweep spends on the host's files: the runner's phases
`sweep.read` (the FASTA parses of queries and forward dbs),
`sweep.revcomp` (each db's reverse complement and its parse),
`sweep.write` (each report and stats file, written and renamed) and
`sweep.save_wait` (joining the index cache's saves at the sweep's end)
(`orchestrator.py AllVsAllRunner`); mean per job; nothing where the jobs
carry no such phases."""

PHASES = ("sweep.read", "sweep.revcomp", "sweep.write", "sweep.save_wait")


def read(ctx):
    if not ctx.jobs or any("sweep.write" not in j["timings"]
                           for j in ctx.jobs):
        return None
    return sum(sum(j["timings"].get(p, 0.0) for p in PHASES)
               for j in ctx.jobs) / len(ctx.jobs)
