"""Descents: the seconds the host blocked in the syncs of polish,
leader-pass, swap-polish and swap-polish-post, summed, mean per cold
proposal. Read from the requests served before the profiler started; a
tree without the counter reads 0 (``perfbench.spans``). Moves
propose_s."""

from perfbench import spans

PHASES = ('polish', 'leader-pass', 'swap-polish', 'swap-polish-post')


def read(run):
    return spans.mean_untraced(
        run, "cold", lambda res: spans.phases_total(res, PHASES, "syncWaitSeconds"))
