"""Share of the render wave's launched cells that are real: 100 x the DP
cells of the accepted pairs (db read length x query read length, worked
out by the benchmark from its inputs and the job's pairs) over the
program's counter `render_launched_cells` (B x L x L of each render chunk,
padding pairs and padded lengths included), summed over the jobs; the
render budget's padding.  Nothing where the jobs carry no such counter."""


def read(ctx):
    if not ctx.jobs or any("render_launched_cells" not in j.get("counters", ())
                           for j in ctx.jobs):
        return None
    launched = sum(j["counters"]["render_launched_cells"] for j in ctx.jobs)
    cells = sum(ctx.pair_cells(j["pairs"]) for j in ctx.jobs)
    return 100.0 * cells / launched if launched else None
