"""Sidecar edge, warm: the delta put's wall, client side, mean per window.
Read from the requests served before the profiler started. Moves
warm_soft_violations."""


def read(run):
    puts = [r.put_s for r in run.requests
            if r.kind == "warm" and r.result is not None and not r.traced]
    return sum(puts) / len(puts) if puts else None
