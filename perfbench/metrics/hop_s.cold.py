"""Sidecar edge, cold: Propose round trip minus the result's wallSeconds, mean
per request. Read from the requests served before the profiler started.
Moves propose_s."""


def read(run):
    hops = [r.rtt_s - r.result["wallSeconds"] for r in run.requests
            if r.kind == "cold" and r.result is not None and not r.traced]
    return sum(hops) / len(hops) if hops else None
