"""The steady loop of one cluster: set-up proposes the cold placement of
the configuration's own cluster, which the sidecar banks as the session's
warm base, and puts the snapshot with that placement applied; then every
request is one metrics window: ``drift_fraction`` of the partitions, drawn
from the run's seed, have their loads scaled around the cluster's own
(before the request's clock starts), and a delta put of the changed fields
and a warm-start Propose with the traffic's cold options under its warm
ones follow. ``prewarm_windows`` untimed windows run in set-up.

Each window drifts from the cluster's own loads, not from the last
window's: the traffic assumes a stationary workload, whose windows scatter
about one mean, not a random walk.

With ``within_capacity`` the mix holds metrics windows only: a drift that
would take a broker of the placement in force (the last proposal, which
the next warm start inherits) over a capacity threshold is drawn again
from the same stream. Such a window takes the system's warm structural
path (repair and a warm anneal, 4-5 s at B5), which is a cell of its own.
A placement in force that is over a threshold on the cluster's own loads
already, or ``MAX_DRAWS`` draws that all overload it, are the system's to
answer for: the window is then served as drawn and counted. The run's
context line counts the draws made again, the windows served over
capacity and the windows that took the structural path."""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import Request
from perfbench.reference import generator as gen
from perfbench.reference.compare import hard_goals
from perfbench.reference.goals import CAPACITY_GOALS, apply_diff

SESSION = "steady"
#: draws of one window's drift before it is served as drawn
MAX_DRAWS = 100


def setup(run) -> None:
    t = run.traffic
    snap = gen.snapshot(gen.random_cluster_arrays(gen.spec_of(run.config)))
    run.put(SESSION, 1, snap)
    res, _ = run.propose(SESSION, t["cold_options"])
    if not res["verified"]:
        raise RuntimeError("the cold Propose of the warm base came back unverified")
    placement, faults = apply_diff(snap, res["proposalsColumnar"])
    if faults:
        raise RuntimeError(f"{faults} rows of the cold proposal do not fit its snapshot")
    run.base = run.arrays = dict(snap, **placement)
    hold(run, placement)
    run.put(SESSION, 2, run.arrays)
    run.gen, run.base_gen = 2, 1
    run.drift = run.rng(2)
    for i in range(t["prewarm_windows"]):
        r = request(run, -1 - i)
        if r.result is None:
            raise RuntimeError(f"prewarm window failed: {r.error}")
    run.notes.update(cold_fallbacks=0, structural_windows=0, drifts_redrawn=0,
                     windows_over_capacity=0)


def hold(run, placement: dict) -> None:
    """Make ``placement`` the one in force: each replica's broker, its
    partition and whether it leads, for the capacity check of the next
    draws."""
    a = placement["assignment"]
    valid = a >= 0
    lead = (np.arange(a.shape[1])[None, :] == placement["leader_slot"][:, None]) & valid
    run.in_force = (a[valid], np.nonzero(valid)[0], lead[valid])
    run.in_force_fits = overloads(run, run.base) == 0


def overloads(run, snap: dict) -> int:
    """Brokers of the placement in force over the threshold of a hard
    capacity goal on ``snap``'s loads (as ``goals.goal_stack`` counts
    them)."""
    b, p, leads = run.in_force
    B = snap["broker_capacity"].shape[1]
    alive = np.asarray(snap["broker_alive"], bool)
    thr = run.config["thresholds"]["capacity_threshold"]
    n = 0
    for goal in hard_goals(run.config):
        r = CAPACITY_GOALS.get(goal)
        if r is None:
            continue
        w = np.where(leads, snap["leader_load"][r, p], snap["follower_load"][r, p])
        load = np.bincount(b, weights=w.astype(np.float64), minlength=B)
        cap = np.asarray(snap["broker_capacity"][r], np.float64) * thr[r]
        n += int(((load > cap) & alive).sum())
    return n


def draw(run) -> dict:
    t = run.traffic
    screen = t.get("within_capacity") and run.in_force_fits
    for _ in range(MAX_DRAWS if screen else 1):
        new = gen.drift_loads(run.base, run.drift, t["drift_fraction"])
        if not screen or not overloads(run, new):
            return new
        run.notes["drifts_redrawn"] = run.notes.get("drifts_redrawn", 0) + 1
    run.notes["windows_over_capacity"] = run.notes.get("windows_over_capacity", 0) + 1
    return new


def request(run, index: int) -> Request:
    t = run.traffic
    new = draw(run)
    r = Request("warm", index, new)
    r.t0 = time.monotonic()
    try:
        r.put_s = run.put(SESSION, run.gen + 1, new, base=run.arrays, base_generation=run.gen)
        run.gen += 1
        run.arrays = new
        r.result, r.rtt_s = run.propose(SESSION, {**t["cold_options"], **t["warm_options"]},
                                        warm_start=True, base_generation=run.base_gen)
        run.base_gen = run.gen
    except Exception as e:  # noqa: BLE001 — a failed request is counted, the loop goes on
        r.error = repr(e)
    r.t1 = time.monotonic()
    run.mark("client")
    if r.result is not None:
        if not (r.result.get("incremental") or {}).get("warmStart"):
            run.notes["cold_fallbacks"] = run.notes.get("cold_fallbacks", 0) + 1
        if "repair" in (r.result.get("phaseSeconds") or {}):
            run.notes["structural_windows"] = run.notes.get("structural_windows", 0) + 1
        hold(run, apply_diff(new, r.result["proposalsColumnar"])[0])
    return r
