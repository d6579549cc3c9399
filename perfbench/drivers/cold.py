"""Cold proposals, back to back: each request is a new session on a
snapshot of its own (the configuration's layout with loads redrawn from
the run's seed and the request's index, made before the request's clock
starts), sent as a full put and a Propose with the traffic's options.

Set-up warms the path with one Propose of the cell's own shapes at the
traffic's cut ``warmup_options``."""

from __future__ import annotations

import time

from perfbench.harness import Request
from perfbench.reference import generator as gen


def setup(run) -> None:
    run.spec = gen.spec_of(run.config)
    run.layout = gen.snapshot(gen.random_cluster_arrays(run.spec))
    snap = gen.redraw_loads(run.layout, run.spec, run.rng(0))
    run.put("warm-up", 1, snap)
    res, _ = run.propose("warm-up", {**run.traffic["options"], **run.traffic["warmup_options"]})
    if not res["verified"]:
        raise RuntimeError("the warm-up Propose came back unverified")


def request(run, index: int) -> Request:
    r = Request("cold", index, gen.redraw_loads(run.layout, run.spec, run.rng(1, index)))
    session = f"cold-{index}"
    r.t0 = time.monotonic()
    try:
        r.put_s = run.put(session, 1, r.snap)
        r.result, r.rtt_s = run.propose(session, run.traffic["options"])
    except Exception as e:  # noqa: BLE001 — a failed request is counted, the loop goes on
        r.error = repr(e)
    r.t1 = time.monotonic()
    run.mark("client")
    return r
