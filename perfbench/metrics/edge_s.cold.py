"""Sidecar edge, cold: the summed wall of the request's edge spans on the
result's span tree (decode, registry, warm-base, bank, assembly, pack),
mean per cold Propose. Read from the requests served before the profiler
started; a tree without the request entry reads 0 (``perfbench.spans``).
Moves propose_s."""

from perfbench import spans


def read(run):
    return spans.mean_untraced(run, "cold", spans.edge_seconds)
