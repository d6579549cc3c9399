"""OptimizationVerifier equivalent — post-condition checks on an optimization.

The reference's analyzer tests assert post-conditions after a goal run
(hard goals satisfied, stats not worsened, proposals self-consistent, dead
brokers evacuated) rather than move-for-move outputs. This module is that
verifier for the port; the checks read the placements on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ccx_torch.common.resources import Resource
from ccx_torch.feasibility import feasibility_report
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.proposals import ColumnarDiff


@dataclasses.dataclass
class Verification:
    ok: bool
    failures: list[str]
    #: hard goals with remaining violations proven unfixable for this input
    #: (reported, not counted as failures)
    infeasible: dict[str, str] = dataclasses.field(default_factory=dict)

    def __bool__(self) -> bool:
        return self.ok


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def verify_model_consistency(m: TensorClusterModel) -> list[str]:
    """Structural invariants any placement must satisfy."""
    failures: list[str] = []
    a = _np(m.assignment)
    pvalid = _np(m.partition_valid)
    bvalid = _np(m.broker_valid)
    leader = _np(m.leader_slot)
    if np.any(a[pvalid] >= m.B):
        failures.append("replica assigned to out-of-range broker index")
    placed = a[pvalid]
    refs = placed[placed >= 0]
    if refs.size and not bvalid[refs].all():
        failures.append("replica assigned to an invalid (padding) broker")
    # distinct brokers within each replica set
    keyed = np.where(a >= 0, a, -1 - np.arange(m.R)[None, :])
    srt = np.sort(keyed, axis=1)
    dup_rows = pvalid & np.any((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0), axis=1)
    if dup_rows.any():
        failures.append(f"partition {int(np.nonzero(dup_rows)[0][0])}: duplicate broker in replica set")
    # leader slot points at a live replica slot
    lp = leader[pvalid]
    rows = a[pvalid]
    lead_b = rows[np.arange(rows.shape[0]), np.clip(lp, 0, m.R - 1)]
    if np.any((lp < 0) | (lp >= m.R)) or np.any(lead_b < 0):
        failures.append("leader slot does not hold a replica")
    return failures


#: soft goals counted per (topic x broker) cell and per (broker x disk) cell
_TOPIC_CELL_GOALS = frozenset({"TopicReplicaDistributionGoal"})
_DISK_CELL_GOALS = frozenset({"IntraBrokerDiskUsageDistributionGoal"})


def soft_goal_slack(
    name: str,
    m: TensorClusterModel,
    cfg: GoalConfig,
    violations_before: float,
    hard_feasible_start: bool,
) -> float:
    """Allowed violation-count increase for one soft goal.

    Lexicographic optimization trades lower tiers for higher ones and a
    balance band is a knife edge, so the slack is 2% of the goal's scoring
    units (brokers, topic x broker cells, broker x disk cells; at least 2).
    PreferredLeaderElectionGoal gets none: the final canonicalization zeroes
    every fixable violation. PotentialNwOutGoal excuses brokers whose cap
    sits below the alive-average potential (over cap in any placement).
    From a hard-infeasible start, displaced load must land on scored brokers:
    3% of units more (at least 2) plus 10% of the input count."""
    if name == "PreferredLeaderElectionGoal":
        return 0.0
    alive_mask = _np(m.broker_ok)
    alive = float(alive_mask.sum())
    if name in _TOPIC_CELL_GOALS:
        units = alive * max(float(m.num_topics), 1.0)
    elif name in _DISK_CELL_GOALS:
        units = float(_np(m.disk_alive).sum())
    else:
        units = alive
    slack = max(2.0, 0.02 * units)
    if name == "PotentialNwOutGoal":
        pvalid = _np(m.partition_valid)
        rf = ((_np(m.assignment) >= 0) & pvalid[:, None]).sum(axis=1)
        total = float(np.sum(_np(m.leader_load[int(Resource.NW_OUT)]) * rf * pvalid))
        avg = total / max(alive, 1.0)
        cap_eff = _np(m.broker_capacity[int(Resource.NW_OUT)]) * float(
            cfg.capacity_threshold[int(Resource.NW_OUT)]
        )
        unavoidable = float(np.sum(alive_mask & (cap_eff < avg)))
        slack += max(0.0, unavoidable - violations_before)
    if not hard_feasible_start:
        slack += max(2.0, 0.03 * units) + 0.10 * violations_before
    return slack


def verify_optimization(
    before: TensorClusterModel,
    after: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    proposals: ColumnarDiff | None = None,
    check_evacuation: bool = True,
    stack_before: StackResult | None = None,
    stack_after: StackResult | None = None,
    require_hard_zero: bool = True,
) -> Verification:
    """The reference verifier's post-conditions:

    1. structural consistency of the optimized placement;
    2. replication factor preserved per partition;
    3. excluded (immovable) partitions untouched;
    4. dead brokers fully evacuated;
    5. hard goals satisfied, unless proven infeasible for the input (with
       ``require_hard_zero`` off: no hard goal's violations increased);
    6. soft cost not worsened from a hard-feasible start, and no soft goal's
       violation count regressed beyond ``soft_goal_slack``;
    7. proposals consistent with the before/after placements.
    """
    failures = verify_model_consistency(after)
    a0, a1 = _np(before.assignment), _np(after.assignment)
    pvalid = _np(before.partition_valid)
    if np.any(((a0 >= 0).sum(1) != (a1 >= 0).sum(1))[pvalid]):
        failures.append("replication factor changed by optimization")
    immovable = _np(before.partition_immovable) & pvalid
    if np.any(a0[immovable] != a1[immovable]):
        failures.append("excluded/immovable partition was moved")
    l0, l1 = _np(before.leader_slot), _np(after.leader_slot)
    if np.any(l0[immovable] != l1[immovable]):
        failures.append("excluded/immovable partition's leadership was moved")
    if check_evacuation:
        dead = ~_np(after.broker_ok)
        placed = a1[pvalid]
        on = placed[placed >= 0]
        if on.size and dead[on].any():
            failures.append("dead broker not evacuated")

    s0 = stack_before if stack_before is not None else evaluate_stack(before, cfg, goal_names)
    s1 = stack_after if stack_after is not None else evaluate_stack(after, cfg, goal_names)
    v0, v1 = s0.by_name(), s1.by_name()
    infeasible: dict[str, str] = {}
    feas = feasibility_report(before, cfg)
    for n in (n for n in goal_names if GOAL_REGISTRY[n].hard):
        if not require_hard_zero:
            if v1[n][0] > v0[n][0]:
                failures.append(f"hard goal {n}: violations increased")
        elif v1[n][0] > 0:
            if n in feas:
                infeasible[n] = feas.infeasible[n]
            else:
                failures.append(f"hard goal {n}: {v1[n][0]:.0f} violations remain")

    hard_feasible_start = float(s0.hard_violations) == 0
    soft0, soft1 = float(s0.soft_scalar), float(s1.soft_scalar)
    # only from a hard-feasible start: repairing hard violations may
    # legitimately land load on scored brokers
    if hard_feasible_start and soft1 > soft0 * (1.0 + 1e-4) + 1e-6:
        failures.append(f"soft cost worsened: {soft0:.4f} -> {soft1:.4f}")
    for n in s1.names:
        if GOAL_REGISTRY[n].hard:
            continue
        vb_, va_ = v0[n][0], v1[n][0]
        if va_ > vb_ + soft_goal_slack(n, after, cfg, vb_, hard_feasible_start):
            failures.append(f"soft goal {n}: violations regressed {vb_:.0f} -> {va_:.0f}")

    if proposals is not None:
        failures.extend(_verify_proposals(before, after, proposals))
    return Verification(ok=not failures, failures=failures, infeasible=infeasible)


def _verify_proposals(
    before: TensorClusterModel, after: TensorClusterModel, proposals: ColumnarDiff
) -> list[str]:
    failures = []
    a0, a1 = _np(before.assignment), _np(after.assignment)
    l0, l1 = _np(before.leader_slot), _np(after.leader_slot)
    d0, d1 = _np(before.replica_disk), _np(after.replica_disk)
    idx = proposals.cols["partition"].astype(np.int64)
    oldr, newr = proposals.cols["oldReplicas"], proposals.cols["newReplicas"]
    # replica slots are left-packed: a valid broker after a -1 hole is malformed
    for label, rows in (("old", oldr), ("new", newr)):
        holes = (rows[:, :-1] < 0) & (rows[:, 1:] >= 0)
        if holes.any():
            p = int(idx[np.nonzero(holes.any(axis=1))[0][0]])
            failures.append(f"proposal {p}: {label} replica slots not left-packed")
    bad_old = np.any(a0[idx] != oldr, axis=1)
    bad_new = np.any(a1[idx] != newr, axis=1)
    if bad_old.any():
        failures.append(f"proposal {int(idx[np.nonzero(bad_old)[0][0]])}: old replicas mismatch")
    if bad_new.any():
        failures.append(f"proposal {int(idx[np.nonzero(bad_new)[0][0]])}: new replicas mismatch")
    # every changed partition must be covered by a proposal
    changed = _np(before.partition_valid) & (
        np.any(a0 != a1, axis=1) | (l0 != l1) | np.any(d0 != d1, axis=1)
    )
    covered = np.zeros(changed.shape[0], bool)
    covered[idx] = True
    missing = changed & ~covered
    if missing.any():
        failures.append(f"changed partition {int(np.nonzero(missing)[0][0])} missing from proposals")
    return failures
