"""Megabytes of gate candidates a job puts on the card: the program's
counter `gate_cand_bytes` (`pipeline.py _gate_chunks_dispatch` and the
routed planner: the candidate arrays each gate chunk uploads, in every
format) over 10^6; mean per job; nothing where the jobs carry no such
counter."""


def read(ctx):
    if not ctx.jobs or any("gate_cand_bytes" not in j.get("counters", ())
                           for j in ctx.jobs):
        return None
    return sum(j["counters"]["gate_cand_bytes"]
               for j in ctx.jobs) / 1e6 / len(ctx.jobs)
