"""Share of the accept wave's launched cells past L = 256 that are real:
100 x the program's counter `nw_long_cells` (db length x query length of
the pairs in buckets past 256) over `nw_long_launched_cells` (B x L x L
of those buckets' chunks, padding pairs and padded lengths included),
summed over the jobs; the stats ladder's padding at long buckets.
Nothing where the jobs carry no such counters."""

KEYS = ("nw_long_cells", "nw_long_launched_cells")


def read(ctx):
    if not ctx.jobs or any(k not in j.get("counters", ())
                           for j in ctx.jobs for k in KEYS):
        return None
    cells, launched = (sum(j["counters"][k] for j in ctx.jobs) for k in KEYS)
    return 100.0 * cells / launched if launched else None
