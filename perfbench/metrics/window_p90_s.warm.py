"""Sidecar edge, warm: the 90th percentile (nearest rank) of the client's
walls of the warm windows served before the profiler started."""


def read(run):
    from perfbench.harness import nearest_rank

    walls = [r.wall_s for r in run.requests if r.kind == "warm" and not r.traced]
    return nearest_rank(walls, 0.9) if walls else None
