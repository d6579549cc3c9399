"""Hard-goal infeasibility proofs (the reference's OptimizationFailureException).

Conservative lower-bound proofs that no placement could satisfy a hard
goal, so the verifier can tell "the input is impossible" from "the search
under-converged". A goal reported here is provably infeasible; absence of a
report does not prove feasibility.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ccx_torch.common.resources import Resource
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.tensor_model import TensorClusterModel

_CAPACITY_GOAL_RESOURCE = {
    "CpuCapacityGoal": Resource.CPU,
    "NetworkInboundCapacityGoal": Resource.NW_IN,
    "NetworkOutboundCapacityGoal": Resource.NW_OUT,
    "DiskCapacityGoal": Resource.DISK,
}


@dataclasses.dataclass
class FeasibilityReport:
    """goal name -> human-readable proof of infeasibility."""

    infeasible: dict[str, str]

    def __contains__(self, goal: str) -> bool:
        return goal in self.infeasible


def feasibility_report(m: TensorClusterModel, cfg: GoalConfig = GoalConfig()) -> FeasibilityReport:
    out: dict[str, str] = {}
    pvalid = TRACER.numpy(m.partition_valid)
    alive = TRACER.numpy(m.broker_ok)
    n_alive = int(alive.sum())
    a = TRACER.numpy(m.assignment)
    rf = ((a >= 0) & pvalid[:, None]).sum(axis=1)
    lead = TRACER.numpy(m.leader_load)
    foll = TRACER.numpy(m.follower_load)
    if n_alive == 0:
        return FeasibilityReport({"StructuralFeasibility": "no alive brokers"})

    # capacity: (a) some partition's leader alone exceeds every broker's
    # allowance, or (b) the total minimal load exceeds the total allowance
    cap = TRACER.numpy(m.broker_capacity)
    for goal, res in _CAPACITY_GOAL_RESOURCE.items():
        allowed = np.where(alive, cap[res] * cfg.capacity_threshold[int(res)], 0.0)
        max_allowed = float(allowed.max(initial=0.0))
        worst = float(np.where(pvalid, lead[res], 0.0).max(initial=0.0))
        if worst > max_allowed * (1 + 1e-6):
            out[goal] = (
                f"partition leader load {worst:.3f} exceeds max broker "
                f"allowance {max_allowed:.3f} ({res.name})"
            )
            continue
        total = float(np.sum(np.where(pvalid, lead[res] + foll[res] * np.maximum(rf - 1, 0), 0.0)))
        if total > float(allowed.sum()) * (1 + 1e-6):
            out[goal] = (
                f"total load {total:.3f} exceeds cluster allowance "
                f"{float(allowed.sum()):.3f} ({res.name})"
            )

    total_replicas = int(rf.sum())
    if total_replicas > cfg.max_replicas_per_broker * n_alive:
        out["ReplicaCapacityGoal"] = (
            f"{total_replicas} replicas > {cfg.max_replicas_per_broker:.0f} "
            f"per broker x {n_alive} alive brokers"
        )

    racks = TRACER.numpy(m.broker_rack)
    n_alive_racks = len(set(racks[alive].tolist()))
    max_rf = int(rf.max(initial=0))
    if max_rf > n_alive_racks:
        out["RackAwareGoal"] = f"replication factor {max_rf} > {n_alive_racks} racks with alive brokers"
    if max_rf > n_alive:
        out["RackAwareDistributionGoal"] = f"replication factor {max_rf} > {n_alive} alive brokers"
        out.setdefault("StructuralFeasibility", f"replication factor {max_rf} > {n_alive} alive brokers")

    tml = TRACER.numpy(m.topic_min_leaders)
    if tml.any():
        eligible = alive & ~TRACER.numpy(m.broker_excl_leadership)
        n_eligible = int(eligible.sum())
        topics = TRACER.numpy(m.partition_topic)
        for t in np.nonzero(tml)[0]:
            n_parts = int(np.sum(pvalid & (topics == t)))
            need = cfg.min_topic_leaders_per_broker * n_eligible
            if 0 < n_parts < need:
                out["MinTopicLeadersPerBrokerGoal"] = (
                    f"topic {t}: {n_parts} partitions < "
                    f"{cfg.min_topic_leaders_per_broker} leaders x "
                    f"{n_eligible} eligible brokers"
                )
                break

    disk_alive = TRACER.numpy(m.disk_alive) & alive[:, None]
    if disk_alive.any():
        dcap = TRACER.numpy(m.disk_capacity)
        allowance = np.where(disk_alive, dcap * cfg.intra_disk_capacity_threshold, 0.0)
        worst_disk = float(np.where(pvalid, lead[Resource.DISK], 0.0).max(initial=0.0))
        if worst_disk > float(allowance.max(initial=0.0)) * (1 + 1e-6):
            out["IntraBrokerDiskCapacityGoal"] = (
                f"partition disk load {worst_disk:.3f} exceeds max disk "
                f"allowance {float(allowance.max(initial=0.0)):.3f}"
            )
    return FeasibilityReport(out)
