"""Warm pipeline: the seconds the host blocked in the syncs of the warm
result's whole ``optimize`` span tree, mean per window. Read from the
requests served before the profiler started; a tree without the counter
reads 0 (``perfbench.spans``). Moves warm_soft_violations."""

from perfbench import spans


def read(run):
    return spans.mean_untraced(run, "warm", lambda res: spans.tree_total(res, "syncWaitSeconds"))
