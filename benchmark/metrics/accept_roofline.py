"""Share of its bound that the accept wave's kernel (`csrc/nw_stats.cu`)
reaches: the DP cells of the real pairs the compare aligned (the
program's counter `nw_cells`, sum of db length x query length, padding
excluded) at 25 int32 operations a cell over the card's integer rate,
divided by the `nw_stats` kernels' device time."""

KERNELS = r"\bnw_stats_kernel\b"


def read(ctx):
    cells = sum(j["nw_cells"] for j in ctx.jobs)
    return ctx.roofline(cells, ctx.trace.kernel_s(KERNELS))
