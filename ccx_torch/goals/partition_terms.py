"""Per-partition goal contributions, row-batched.

StructuralFeasibility, RackAwareGoal, RackAwareDistributionGoal and
PreferredLeaderElectionGoal depend on a partition's own replica row. Their
math lives in row functions so the full goal functions (over all P rows) and
the search's per-move deltas (over the few rows a move touches) share one
implementation. Every function takes row-batched tensors (leading axis n)
plus the model for broker attributes and returns float32[n].
"""

from __future__ import annotations

import torch

from ccx_torch.model.tensor_model import TensorClusterModel

#: Order of the per-partition goal slots maintained incrementally by search.
PARTITION_GOALS: tuple[str, ...] = (
    "StructuralFeasibility",
    "RackAwareGoal",
    "RackAwareDistributionGoal",
    "PreferredLeaderElectionGoal",
)


def _row_valid(assign: torch.Tensor, pvalid: torch.Tensor) -> torch.Tensor:
    return (assign >= 0) & pvalid[:, None]


def _pair_mask(R: int, device, upper: bool) -> torch.Tensor:
    """bool[R, R] — i < j (``upper``) or i > j."""
    i = torch.arange(R, device=device)
    return (i[:, None] < i[None, :]) if upper else (i[:, None] > i[None, :])


def structural_rows(
    m: TensorClusterModel,
    assign: torch.Tensor,        # int32[n, R]
    leader_slot: torch.Tensor,   # int32[n]
    replica_disk: torch.Tensor,  # int32[n, R]
    pvalid: torch.Tensor,        # bool[n]
) -> torch.Tensor:
    """Replicas on dead brokers/disks, leaders on leadership-excluded
    brokers, duplicate brokers within a replica set."""
    R = assign.shape[1]
    valid = _row_valid(assign, pvalid)
    safe_b = assign.clamp(0, m.B - 1).long()
    on_dead = valid & ~m.broker_ok[safe_b]
    safe_d = replica_disk.clamp(0, m.D - 1).long()
    on_dead_disk = valid & (replica_disk >= 0) & ~m.disk_alive[safe_b, safe_d]
    lead_b = safe_b.gather(1, leader_slot.clamp(0, R - 1).long()[:, None])[:, 0]
    lead_excl = pvalid & m.broker_excl_leadership[lead_b]
    neg = -torch.arange(1, R + 1, dtype=assign.dtype, device=assign.device)
    a = torch.where(valid, assign, neg[None, :])
    pair = (a[:, :, None] == a[:, None, :]) & _pair_mask(R, assign.device, True)
    dup = (pair & valid[:, :, None] & valid[:, None, :]).sum((1, 2))
    return (
        on_dead.sum(1) + (on_dead_disk & ~on_dead).sum(1) + lead_excl.long() + dup
    ).float()


def _rack_rank_rows(
    m: TensorClusterModel, assign: torch.Tensor, pvalid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank[n, R], valid bool[n, R]) — for each replica slot, how many
    EARLIER valid slots of the same row share its rack (pairwise over R)."""
    valid = _row_valid(assign, pvalid)
    racks = m.broker_rack[assign.clamp(0, m.B - 1).long()]
    same = (
        (racks[:, :, None] == racks[:, None, :])
        & valid[:, :, None]
        & valid[:, None, :]
        & _pair_mask(assign.shape[1], assign.device, False)
    )
    return same.sum(2), valid


def rack_aware_rows(
    m: TensorClusterModel, assign: torch.Tensor, pvalid: torch.Tensor
) -> torch.Tensor:
    # replicas that are NOT the first occupant of their rack within the row
    rank, valid = _rack_rank_rows(m, assign, pvalid)
    return (valid & (rank >= 1)).sum(1).float()


def rack_aware_distribution_rows(
    m: TensorClusterModel, assign: torch.Tensor, pvalid: torch.Tensor
) -> torch.Tensor:
    # replicas whose within-rack rank reaches ceil(rf / #racks)
    rank, valid = _rack_rank_rows(m, assign, pvalid)
    rf = valid.sum(1)
    cap = torch.ceil(rf / max(m.num_racks, 1)).long()
    return (valid & (rank >= cap[:, None])).sum(1).float()


def preferred_leader_rows(
    m: TensorClusterModel,
    assign: torch.Tensor,
    leader_slot: torch.Tensor,
    pvalid: torch.Tensor,
) -> torch.Tensor:
    safe_b0 = assign[:, 0].clamp(0, m.B - 1).long()
    can_lead = m.broker_ok & ~m.broker_excl_leadership
    eligible = pvalid & (assign[:, 0] >= 0) & can_lead[safe_b0]
    return (eligible & (leader_slot != 0)).float()


def partition_rows(
    m: TensorClusterModel,
    assign: torch.Tensor,
    leader_slot: torch.Tensor,
    replica_disk: torch.Tensor,
    pvalid: torch.Tensor,
) -> torch.Tensor:
    """float32[n, len(PARTITION_GOALS)] — each row's contributions."""
    return torch.stack(
        [
            structural_rows(m, assign, leader_slot, replica_disk, pvalid),
            rack_aware_rows(m, assign, pvalid),
            rack_aware_distribution_rows(m, assign, pvalid),
            preferred_leader_rows(m, assign, leader_slot, pvalid),
        ],
        dim=1,
    )


def partition_sums(
    m: TensorClusterModel,
    assign: torch.Tensor,
    leader_slot: torch.Tensor,
    replica_disk: torch.Tensor,
    pvalid: torch.Tensor,
) -> torch.Tensor:
    """float32[len(PARTITION_GOALS)] — summed contributions over the rows."""
    return partition_rows(m, assign, leader_slot, replica_disk, pvalid).sum(0)
