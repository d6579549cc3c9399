"""Annealer: the seconds the host blocked in the syncs of the anneal phase
(``syncWaitSeconds`` of its span subtree), mean per cold proposal. Read
from the requests served before the profiler started; a tree without the
counter reads 0 (``perfbench.spans``). Moves propose_s."""

from perfbench import spans

PHASES = ('anneal',)


def read(run):
    return spans.mean_untraced(
        run, "cold", lambda res: spans.phases_total(res, PHASES, "syncWaitSeconds"))
