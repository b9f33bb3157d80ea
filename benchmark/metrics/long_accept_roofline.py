"""Share of its bound that the accept wave's kernel (`csrc/nw_stats.cu`)
reaches at the long buckets: the DP cells of the real pairs it aligned
past L = 256 (the program's counter `nw_long_cells`, sum of db length x
query length, padding excluded) at 25 int32 operations a cell over the
card's integer rate, divided by the `nw_stats` kernels' device time.
Listed only for cells where every pair lies past 256, so that the
kernel's time is all long-bucket time; nothing where the jobs carry no
such counter."""

KERNELS = r"\bnw_stats_kernel\b"


def read(ctx):
    if not ctx.jobs or any("nw_long_cells" not in j.get("counters", ())
                           for j in ctx.jobs):
        return None
    cells = sum(j["counters"]["nw_long_cells"] for j in ctx.jobs)
    return ctx.roofline(cells, ctx.trace.kernel_s(KERNELS))
