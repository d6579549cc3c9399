"""Sidecar edge, warm: the client's wall of a warm window (delta put and
warm-start Propose), mean per window. Read from the requests served before
the profiler started. Host-bound: it follows the host's speed, which
wanders by more than a bound can hold between runs."""


def read(run):
    walls = [r.wall_s for r in run.requests if r.kind == "warm" and not r.traced]
    return sum(walls) / len(walls) if walls else None
