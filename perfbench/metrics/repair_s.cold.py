"""Repair: the result's phaseSeconds["repair"], mean per cold proposal. Read
from the requests served before the profiler started. Moves propose_s."""

PHASES = ('repair',)


def read(run):
    vals = [sum(r.result["phaseSeconds"].get(p, 0.0) for p in PHASES)
            for r in run.requests if r.kind == "cold" and r.result is not None and not r.traced]
    return sum(vals) / len(vals) if vals else None
