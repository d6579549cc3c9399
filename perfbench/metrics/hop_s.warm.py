"""Sidecar edge, warm: Propose round trip minus the result's wallSeconds, mean
per window. Read from the requests served before the profiler started.
Moves warm_soft_violations."""


def read(run):
    hops = [r.rtt_s - r.result["wallSeconds"] for r in run.requests
            if r.kind == "warm" and r.result is not None and not r.traced]
    return sum(hops) / len(hops) if hops else None
