"""Seconds a job's compare spends planning on the host: the program's
own phases `kmer_stream`, `gate.build` and `gate.encode`
(`pipeline.py _kmer_stream`, `build_flat`, the seg encode), which do no
device work; mean per job."""

PHASES = ("kmer_stream", "gate.build", "gate.encode")


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(sum(j["timings"].get(p, 0.0) for p in PHASES)
               for j in ctx.jobs) / len(ctx.jobs)
