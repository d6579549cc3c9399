"""Sidecar edge, warm: the summed wall of the request's edge spans on the
warm result's span tree, mean per window. Read from the requests served
before the profiler started; a tree without the request entry reads 0
(``perfbench.spans``). Moves warm_soft_violations."""

from perfbench import spans


def read(run):
    return spans.mean_untraced(run, "warm", spans.edge_seconds)
