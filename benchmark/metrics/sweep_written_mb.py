"""Megabytes a sweep writes: the runner's counter `sweep_bytes_written`
(`orchestrator.py AllVsAllRunner`: every report, stats file and cached
index that lands) over 10^6; mean per job; nothing where the jobs carry
no such counter."""


def read(ctx):
    if not ctx.jobs or any("sweep_bytes_written" not in j.get("counters", ())
                           for j in ctx.jobs):
        return None
    return sum(j["counters"]["sweep_bytes_written"]
               for j in ctx.jobs) / 1e6 / len(ctx.jobs)
