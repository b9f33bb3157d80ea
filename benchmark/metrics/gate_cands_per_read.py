"""Candidates the host gate builds a query read: the program's counter
`gate_built_cands` (`pipeline.py build_flat`'s candidates of every gate
stage) over the job's query reads, the dictionary's load as it reaches
the gate; mean per job; nothing where the jobs carry no such counter."""


def read(ctx):
    if not ctx.jobs or any("gate_built_cands" not in j.get("counters", ())
                           for j in ctx.jobs):
        return None
    return sum(j["counters"]["gate_built_cands"] / j["reads"]
               for j in ctx.jobs) / len(ctx.jobs)
