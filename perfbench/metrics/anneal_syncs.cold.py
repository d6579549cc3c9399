"""Annealer: the host syncs (reads of device data) the system's tracer
counts in the anneal phase's span subtree, mean per cold proposal. Read
from the requests served before the profiler started; a tree without the
counter reads 0 (``perfbench.spans``). Moves propose_s."""

from perfbench import spans

PHASES = ('anneal',)


def read(run):
    return spans.mean_untraced(run, "cold", lambda res: spans.phases_total(res, PHASES, "syncs"))
