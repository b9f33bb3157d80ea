"""Seconds a job's host waits on the card: the program's read-backs, each
a `.cpu()` that synchronises, the gate's bits (`gate.fetch`), the accept
waves' stats (`nw.fetch1`-`nw.fetch3`) and the render wave's chains
(`render.fetch`).  Read from the phase sums the program leaves in the
result's `timings` once it has rendered; mean per job; nothing where the
program leaves no render phases there."""

FETCHES = ("gate.fetch", "nw.fetch1", "nw.fetch2", "nw.fetch3",
           "render.fetch")


def read(ctx):
    if not ctx.jobs or any("render_report" not in j["timings"]
                           for j in ctx.jobs):
        return None
    return sum(sum(j["timings"].get(p, 0.0) for p in FETCHES)
               for j in ctx.jobs) / len(ctx.jobs)
