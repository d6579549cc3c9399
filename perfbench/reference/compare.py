"""The comparison that decides ``correct``: every proposal of a run,
recomputed by the plain reference from the snapshot the benchmark handed
over and the diff the system returned.

``judge`` reads one request's result against the reference and returns its
readings; ``control`` makes the result a lower-precision scoring path would
have reported for the same proposal (the reference in bfloat16 in the
system's place), so that its readings show where the limits must fail.
``summarize`` folds the readings of all requests into the numbers compared,
each beside its limit.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import goals as rg

def hard_goals(config: dict) -> list[str]:
    return [g["name"] for g in config["goals"] if g["hard"]]


def soft_goals(config: dict) -> list[str]:
    return [g["name"] for g in config["goals"] if not g["hard"]]


def _cost_gap(reported: dict, ref: dict, soft: list[str]) -> float:
    """Worst |reported - reference| over the goals, each against the larger
    of its own reference cost and the soft goals' median reference cost."""
    scale = float(np.median([abs(ref[g][1]) for g in soft])) if soft else 0.0
    gaps = [abs(reported[g][1] - ref[g][1]) / max(abs(ref[g][1]), scale, 1e-12) for g in ref]
    return max(gaps, default=0.0)


def _stats_gap(reported: dict | None, ref: dict) -> float:
    """Worst relative gap of the reported ClusterModelStats block, each value
    against the larger of itself and its key's average."""
    worst = 0.0
    for stat in ("AVG", "STD", "MIN", "MAX"):
        for key, want in ref[stat].items():
            got = reported["statistics"][stat][key]
            scale = max(abs(want), abs(ref["AVG"][key]), 1e-12)
            worst = max(worst, abs(got - want) / scale)
    if reported["metadata"].get("brokers") != ref["metadata"]["brokers"] or \
            reported["metadata"].get("replicas") != ref["metadata"]["replicas"]:
        worst = float("inf")
    return worst


def _summary(result: dict) -> tuple[dict, dict]:
    """(before, after): goal -> (violations, cost) as the result reports."""
    before = {g["goal"]: (g["violationsBefore"], g["costBefore"]) for g in result["goalSummary"]}
    after = {g["goal"]: (g["violationsAfter"], g["costAfter"]) for g in result["goalSummary"]}
    return before, after


def judge(snap: dict, result: dict, config: dict) -> dict:
    """Readings of one request: the diff applied to ``snap``, the reference's
    hard and soft violations of the placement it gives, and the gaps between
    what the result reports and what the reference computes."""
    goals = [g["name"] for g in config["goals"]]
    thr = config["thresholds"]
    soft = soft_goals(config)
    try:
        placement, faults = rg.apply_diff(snap, result["proposalsColumnar"])
    except rg.DiffFault:
        placement, faults = {"assignment": snap["assignment"],
                             "leader_slot": snap["leader_slot"]}, float("inf")
    ref_after = rg.goal_stack(snap, placement, goals, thr)
    ref_before = rg.goal_stack(snap, snap, goals, thr)
    before, after = _summary(result)
    missing = set(goals) - set(after)
    readings = {
        "unverified": 0 if result.get("verified") else 1,
        "diff_faults": faults + (0 if int(result.get("numProposals", 0)) == len(
            result["proposalsColumnar"]["partition"]) else 1),
        "hard_violations": sum(ref_after[g][0] for g in hard_goals(config)),
        "soft_violations": sum(ref_after[g][0] for g in soft),
        "per_goal": {g: ref_after[g][0] for g in goals},
    }
    if missing:
        readings["violation_gap"] = readings["cost_gap"] = float("inf")
    else:
        # a warm result's "before" block scores its warm base (the last
        # proposal's placement on the new loads), not the snapshot
        pairs = [(after, ref_after)]
        if not (result.get("incremental") or {}).get("warmStart"):
            pairs.append((before, ref_before))
        gaps = [(abs(rep[g][0] - ref[g][0]), g, side, rep[g][0], ref[g][0])
                for side, (rep, ref) in enumerate(pairs) for g in goals]
        worst = max(gaps)
        readings["violation_gap"] = worst[0]
        if worst[0] > 0:
            # where it is: goal, after (0) or before (1), reported, reference
            readings["violation_gap_at"] = list(worst[1:])
        readings["cost_gap"] = max(_cost_gap(rep, ref, soft) for rep, ref in pairs)
    stats = result.get("clusterModelStats")
    if stats is not None:
        readings["stats_gap"] = max(
            _stats_gap(stats["before"], rg.cluster_stats(snap, snap)),
            _stats_gap(stats["after"], rg.cluster_stats(snap, placement)))
    return readings


def control(snap: dict, result: dict, config: dict) -> dict:
    """``result`` with every number the system reports about its proposal
    recomputed by the reference in bfloat16: what a lower-precision scoring
    path in the system's place would have reported."""
    goals = [g["name"] for g in config["goals"]]
    thr = config["thresholds"]
    placement, _ = rg.apply_diff(snap, result["proposalsColumnar"])
    after = rg.goal_stack(snap, placement, goals, thr, precision="bf16")
    before = rg.goal_stack(snap, snap, goals, thr, precision="bf16")
    out = dict(result)
    out["goalSummary"] = [
        {"goal": g, "violationsBefore": before[g][0], "costBefore": before[g][1],
         "violationsAfter": after[g][0], "costAfter": after[g][1]} for g in goals
    ]
    if result.get("clusterModelStats") is not None:
        def block(pl):
            s = rg.cluster_stats(snap, pl, precision="bf16")
            return {"metadata": s.pop("metadata"), "statistics": s}

        out["clusterModelStats"] = {"before": block(snap), "after": block(placement)}
    return out


def summarize(readings: list[dict], limits: dict) -> dict:
    """name -> {"value": worst reading over the requests, "limit": limit}
    for every number the cell compares (``limits``' keys)."""
    out = {}
    for name, limit in limits.items():
        vals = [r[name] for r in readings if name in r]
        out[name] = {"value": max(vals) if vals else None, "limit": limit}
    return out


def passes(checks: dict) -> bool:
    """Every number compared is present and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
