"""Goal-stack evaluation — lexicographic priority as tiered scalarization.

The reference's GoalOptimizer runs goals in priority order, later goals
forbidden from breaking earlier ones. Here hard goals form one feasibility
tier, soft goals get geometrically-tiered weights in priority order, and
search compares full per-goal cost vectors lexicographically; the verifier
checks the reference's post-conditions.
"""

from __future__ import annotations

import dataclasses

import torch

from ccx_torch.goals import kernels  # noqa: F401  (populates the registry)
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.model.aggregates import BrokerAggregates, broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel

#: Default priority order (AnalyzerConfig ``goals`` default), structural
#: term first. RackAwareDistributionGoal is registered but not in the
#: default stack (the configurable alternative to RackAwareGoal).
DEFAULT_GOAL_ORDER: tuple[str, ...] = (
    "StructuralFeasibility",
    "RackAwareGoal",
    "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
    "PreferredLeaderElectionGoal",
)

#: Goal stack for the rebalance_disk endpoint.
INTRA_BROKER_GOAL_ORDER: tuple[str, ...] = (
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
)

HARD_WEIGHT = 1e6
SOFT_TIER_BASE = 4.0


def soft_weights(
    hard_mask: tuple[bool, ...], device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Tiered weights: hard goals get HARD_WEIGHT; soft goals decay
    geometrically in priority order, first soft goal at weight 1."""
    w = []
    soft_rank = 0
    for h in hard_mask:
        if h:
            w.append(HARD_WEIGHT)
        else:
            w.append(SOFT_TIER_BASE ** (-soft_rank))
            soft_rank += 1
    return torch.tensor(w, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class StackResult:
    names: tuple[str, ...]
    hard_mask: tuple[bool, ...]
    violations: torch.Tensor  # float32[G]
    costs: torch.Tensor       # float32[G]

    def _mask(self) -> torch.Tensor:
        return torch.tensor(self.hard_mask, device=self.costs.device)

    @property
    def hard_violations(self) -> torch.Tensor:
        return torch.where(self._mask(), self.violations, 0.0).sum()

    @property
    def soft_scalar(self) -> torch.Tensor:
        """Tier-weighted soft cost only (search compares (hard_cost,
        soft_scalar) lexicographically)."""
        w = soft_weights(self.hard_mask, self.costs.device)
        return torch.where(self._mask(), 0.0, self.costs * w).sum()

    def by_name(self) -> dict[str, tuple[float, float]]:
        v = self.violations.tolist()
        c = self.costs.tolist()
        return {n: (v[i], c[i]) for i, n in enumerate(self.names)}


def evaluate_stack(
    m: TensorClusterModel,
    cfg: GoalConfig,
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    agg: BrokerAggregates | None = None,
) -> StackResult:
    """Score one model state against an ordered goal stack."""
    if agg is None:
        agg = broker_aggregates(m)
    results = [GOAL_REGISTRY[n].fn(m, agg, cfg) for n in goal_names]
    return StackResult(
        names=tuple(goal_names),
        hard_mask=tuple(GOAL_REGISTRY[n].hard for n in goal_names),
        violations=torch.stack([r.violations for r in results]),
        costs=torch.stack([r.cost for r in results]),
    )
