"""Seconds a job's `render_report` spends on the host: the program's
phase `render_report` less its `render.fetch` phases (the read-backs of
the render wave, `pipeline.py _render_collect_chains`); what is left is
the queueing of the render wave, the chains' host loop, the native block
render and the `format_record` loop.  Read from the phase sums the
program leaves in the result's `timings` once it has rendered; mean per
job; nothing where the program leaves no render phases there."""


def read(ctx):
    if not ctx.jobs or any("render_report" not in j["timings"]
                           for j in ctx.jobs):
        return None
    return sum(j["timings"]["render_report"]
               - j["timings"].get("render.fetch", 0.0)
               for j in ctx.jobs) / len(ctx.jobs)
