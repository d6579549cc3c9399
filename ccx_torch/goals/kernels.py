"""The built-in goal stack as penalty functions.

These are plain PyTorch functions on tensors, not GPU kernels: each mirrors
one reference goal class from ``analyzer/goals/`` (class names in
``register_goal``) and runs as a handful of tensor ops on whatever device
the model lives on.

Conventions:
* Averages and bands are taken over alive, valid brokers — dead brokers
  must end up empty, which the structural term enforces.
* ``violations`` counts discrete offenders; ``cost`` is a smooth normalized
  hinge search descends.
* Aggregate-only goals accept aggregates with leading batch dimensions (the
  search scores many candidate aggregate states at once); goals that read
  placement score the model's own placement.
"""

from __future__ import annotations

import torch

from ccx_torch.common.resources import Resource
from ccx_torch.goals import partition_terms as pt
from ccx_torch.goals import topic_terms as tt
from ccx_torch.goals.base import GoalConfig, GoalResult, register_goal, result
from ccx_torch.model.aggregates import BrokerAggregates
from ccx_torch.model.tensor_model import TensorClusterModel


def _alive(m: TensorClusterModel) -> torch.Tensor:
    return m.broker_valid & m.broker_alive


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 1.0)


def _n_alive(m: TensorClusterModel) -> torch.Tensor:
    return _alive(m).sum().clamp(min=1).float()


# --------------------------------------------------------------------------
# Structural feasibility: replicas off dead brokers/disks, leadership off
# leadership-excluded brokers, no broker twice in a replica set.
# --------------------------------------------------------------------------
@register_goal("StructuralFeasibility", hard=True, ref_class="ClusterModel invariants + self-healing requirements", placement_dependent=True)
def structural_feasibility(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    n = pt.structural_rows(
        m, m.assignment, m.leader_slot, m.replica_disk, m.partition_valid
    ).sum()
    return result(n, n)


@register_goal("RackAwareGoal", hard=True, placement_dependent=True)
def rack_aware(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Replicas of a partition live on distinct racks."""
    n = pt.rack_aware_rows(m, m.assignment, m.partition_valid).sum()
    return result(n, n)


@register_goal("RackAwareDistributionGoal", hard=True, placement_dependent=True)
def rack_aware_distribution(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """No rack holds more than ceil(rf / #racks) replicas of a partition."""
    n = pt.rack_aware_distribution_rows(m, m.assignment, m.partition_valid).sum()
    return result(n, n)


# --------------------------------------------------------------------------
# Capacity goals (hard)
# --------------------------------------------------------------------------
def _capacity_goal(res: Resource):
    def fn(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
        cap = m.broker_capacity[res] * cfg.capacity_threshold[int(res)]
        load = agg.broker_load[..., int(res), :]
        excess = torch.where(_alive(m), (load - cap).clamp(min=0), 0.0)
        return result((excess > 0).sum(-1), (excess / _safe(cap)).sum(-1))

    return fn


register_goal("CpuCapacityGoal", hard=True)(_capacity_goal(Resource.CPU))
register_goal("NetworkInboundCapacityGoal", hard=True)(_capacity_goal(Resource.NW_IN))
register_goal("NetworkOutboundCapacityGoal", hard=True)(_capacity_goal(Resource.NW_OUT))
register_goal("DiskCapacityGoal", hard=True)(_capacity_goal(Resource.DISK))


@register_goal("ReplicaCapacityGoal", hard=True)
def replica_capacity(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    over = torch.where(
        _alive(m),
        (agg.replica_count - cfg.max_replicas_per_broker).clamp(min=0),
        0.0,
    )
    return result((over > 0).sum(-1), over.sum(-1) / cfg.max_replicas_per_broker)


@register_goal("MinTopicLeadersPerBrokerGoal", hard=True)
def min_topic_leaders(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Each alive broker hosts >= k leaders of each flagged topic."""
    n = tt.mtl_row(m, cfg, m.topic_min_leaders, agg.topic_leader_count).sum()
    return result(n, n)


# --------------------------------------------------------------------------
# Distribution (soft) goals
# --------------------------------------------------------------------------
def _band_penalty(values, alive, avg, threshold):
    """Hinge penalty outside [avg*(2-t), avg*t], normalized by avg.
    ``values`` is [..., B], ``avg`` is [...]."""
    a = avg[..., None]
    over = (values - a * threshold).clamp(min=0)
    under = (a * (2.0 - threshold) - values).clamp(min=0)
    pen = torch.where(alive, over + under, 0.0)
    return (pen > 0).sum(-1).float(), pen.sum(-1) / _safe(avg)


def _usage_distribution_goal(res: Resource):
    def fn(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
        """Broker utilization within a band around the cluster-average
        utilization, gated by ``*.low.utilization.threshold``."""
        alive = _alive(m)
        cap = torch.where(alive, m.broker_capacity[res], 0.0)
        load = torch.where(alive, agg.broker_load[..., int(res), :], 0.0)
        avg_util = load.sum(-1) / _safe(cap.sum(-1))
        util = load / _safe(m.broker_capacity[res])
        n, cost = _band_penalty(util, alive, avg_util, cfg.balance_threshold[int(res)])
        gate = avg_util > cfg.low_utilization_threshold[int(res)]
        return result(torch.where(gate, n, 0.0), torch.where(gate, cost, 0.0))

    return fn


register_goal("CpuUsageDistributionGoal", hard=False)(_usage_distribution_goal(Resource.CPU))
register_goal("NetworkInboundUsageDistributionGoal", hard=False)(_usage_distribution_goal(Resource.NW_IN))
register_goal("NetworkOutboundUsageDistributionGoal", hard=False)(_usage_distribution_goal(Resource.NW_OUT))
register_goal("DiskUsageDistributionGoal", hard=False)(_usage_distribution_goal(Resource.DISK))


@register_goal("ReplicaDistributionGoal", hard=False)
def replica_distribution(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    avg = agg.replica_count.sum(-1).float() / _n_alive(m)
    n, cost = _band_penalty(
        agg.replica_count.float(), _alive(m), avg, cfg.replica_balance_threshold
    )
    return result(n, cost)


@register_goal("LeaderReplicaDistributionGoal", hard=False)
def leader_replica_distribution(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    alive = _alive(m) & ~m.broker_excl_leadership
    avg = agg.leader_count.sum(-1).float() / alive.sum().clamp(min=1)
    n, cost = _band_penalty(
        agg.leader_count.float(), alive, avg, cfg.leader_balance_threshold
    )
    return result(n, cost)


@register_goal("TopicReplicaDistributionGoal", hard=False)
def topic_replica_distribution(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Per-topic replica counts within a band around each topic's
    alive-broker average."""
    pen_sums, offenders = tt.trd_row_pen(m, cfg, agg.topic_replica_count)
    totals = tt.trd_row_total(m, agg.topic_replica_count)
    return result(offenders.sum(), pen_sums.sum() / tt.trd_normalizer(m, totals))


@register_goal("LeaderBytesInDistributionGoal", hard=False)
def leader_bytes_in_distribution(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    alive = _alive(m) & ~m.broker_excl_leadership
    lbi = torch.where(alive, agg.leader_bytes_in, 0.0)
    avg = lbi.sum(-1) / alive.sum().clamp(min=1)
    n, cost = _band_penalty(lbi, alive, avg, cfg.leader_bytes_in_balance_threshold)
    return result(n, cost)


@register_goal("PotentialNwOutGoal", hard=False)
def potential_nw_out(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Cap the outbound a broker would serve if it led every hosted replica."""
    cap = m.broker_capacity[Resource.NW_OUT] * cfg.capacity_threshold[int(Resource.NW_OUT)]
    excess = torch.where(_alive(m), (agg.potential_nw_out - cap).clamp(min=0), 0.0)
    return result((excess > 0).sum(-1), (excess / _safe(cap)).sum(-1))


@register_goal("PreferredLeaderElectionGoal", hard=False, placement_dependent=True)
def preferred_leader_election(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Leadership on the preferred (slot-0) replica when it is eligible."""
    n = pt.preferred_leader_rows(
        m, m.assignment, m.leader_slot, m.partition_valid
    ).sum()
    return result(n, n / agg.leader_count.sum(-1).float().clamp(min=1.0))


# --------------------------------------------------------------------------
# Intra-broker (JBOD) goals
# --------------------------------------------------------------------------
@register_goal("IntraBrokerDiskCapacityGoal", hard=True)
def intra_disk_capacity(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    alive = _alive(m)[:, None] & m.disk_alive
    cap = m.disk_capacity * cfg.intra_disk_capacity_threshold
    excess = torch.where(alive, (agg.disk_load - cap).clamp(min=0), 0.0)
    return result((excess > 0).sum((-2, -1)), (excess / _safe(cap)).sum((-2, -1)))


@register_goal("IntraBrokerDiskUsageDistributionGoal", hard=False)
def intra_disk_usage_distribution(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Disk utilizations within a broker stay within ``intra_disk_balance_gap``
    of the broker's mean disk utilization."""
    alive = _alive(m)[:, None] & m.disk_alive
    util = torch.where(alive, agg.disk_load / _safe(m.disk_capacity), 0.0)
    n_disks = alive.sum(1).clamp(min=1)
    broker_avg = util.sum(-1) / n_disks
    dev = (util - broker_avg[..., None]).abs() - cfg.intra_disk_balance_gap
    pen = torch.where(alive, dev.clamp(min=0), 0.0)
    return result((pen > 0).sum((-2, -1)), pen.sum((-2, -1)))


# --------------------------------------------------------------------------
# KafkaAssigner compatibility mode
# --------------------------------------------------------------------------
@register_goal("KafkaAssignerEvenRackAwareGoal", hard=True, placement_dependent=True)
def kafka_assigner_even_rack_aware(m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig) -> GoalResult:
    """Rack-distinct replicas AND leaders evenly spread over brokers."""
    ra = rack_aware(m, agg, cfg)
    avg = agg.leader_count.sum(-1).float() / _n_alive(m)
    over = torch.where(
        _alive(m), (agg.leader_count - torch.ceil(avg)[..., None]).clamp(min=0), 0.0
    )
    return result(
        ra.violations + (over > 0).sum(-1).float(),
        ra.cost + over.sum(-1) / _safe(avg),
    )


register_goal("KafkaAssignerDiskUsageDistributionGoal", hard=False)(
    _usage_distribution_goal(Resource.DISK)
)
