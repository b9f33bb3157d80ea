"""Share of its bound that the render wave's kernels (`csrc/nw_forward.cu`
and `csrc/traceback.cu`) reach: the DP cells of the accepted pairs (db
read length x query read length, worked out by the benchmark from its
inputs and the job's pairs) at 25 int32 operations a cell over the card's
integer rate, divided by the two kernels' device time."""

KERNELS = r"\b(nw_forward_kernel|traceback_kernel)\b"


def read(ctx):
    cells = sum(ctx.pair_cells(j["pairs"]) for j in ctx.jobs)
    return ctx.roofline(cells, ctx.trace.kernel_s(KERNELS))
