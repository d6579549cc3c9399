"""Annealer: milliseconds of the anneal phase per sub-step (1000 x
phaseSeconds["anneal"] over the ``subSteps`` counter of the result's
``anneal`` phase span: the proposal applications the run made; 0 where the
counter is 0 or absent), mean per cold heal. Read from the requests served
before the profiler started. Moves propose_s."""

from perfbench import spans


def per_substep_ms(res: dict) -> float:
    tree = res.get("spanTree") or {}
    n = sum((c.get("attrs") or {}).get("subSteps", 0)
            for c in tree.get("children", ()) if c.get("name") == "anneal")
    return 1000.0 * res["phaseSeconds"].get("anneal", 0.0) / n if n else 0.0


def read(run):
    return spans.mean_untraced(run, "cold", per_substep_ms)
