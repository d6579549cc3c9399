"""Warm pipeline: the warm result's wallSeconds, mean per window. Read from
the requests served before the profiler started. Moves
warm_soft_violations."""


def read(run):
    walls = [r.result["wallSeconds"] for r in run.requests
             if r.kind == "warm" and r.result is not None and not r.traced]
    return sum(walls) / len(walls) if walls else None
