"""Repair: the sweeps the repair ran (the ``sweeps`` counter of the result's
``repair`` phase spans, the repair retries' included), mean per cold heal.
Read from the requests served before the profiler started; a tree without
the counter reads 0 (``perfbench.spans``). Moves propose_s."""

from perfbench import spans


def sweeps(res: dict) -> float:
    tree = res.get("spanTree") or {}
    return sum((c.get("attrs") or {}).get("sweeps", 0)
               for c in tree.get("children", ()) if c.get("name") == "repair")


def read(run):
    return spans.mean_untraced(run, "cold", sweeps)
