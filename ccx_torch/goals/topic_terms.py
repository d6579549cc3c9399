"""Per-topic-row goal contributions for the two [T, B]-shaped goals.

MinTopicLeadersPerBrokerGoal and TopicReplicaDistributionGoal score the
(topic, broker) count matrices. Their math lives in row functions over one
topic's [B] count row, so the full goal functions (all T rows) and the
search's per-move deltas (the one row a move touches) share one
implementation. Raw sums are integer-valued, hence exact in float32 under
incremental +/- updates.
"""

from __future__ import annotations

import torch

from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.tensor_model import TensorClusterModel

#: Goals whose contribution search maintains via topic-row deltas.
TOPIC_GOALS: tuple[str, ...] = (
    "MinTopicLeadersPerBrokerGoal",
    "TopicReplicaDistributionGoal",
)


def _n_alive(m: TensorClusterModel) -> torch.Tensor:
    return m.broker_ok.sum().clamp(min=1).float()


def mtl_row(
    m: TensorClusterModel,
    cfg: GoalConfig,
    flagged: torch.Tensor,   # bool[...] — topic is in the min-leaders set
    tlc_row: torch.Tensor,   # int32[..., B] — topic_leader_count row(s)
) -> torch.Tensor:
    """float32[...] — leader deficit of topic row(s): sum over eligible
    brokers of max(k - leaders, 0)."""
    alive = m.broker_ok & ~m.broker_excl_leadership
    deficit = (cfg.min_topic_leaders_per_broker - tlc_row).clamp(min=0)
    deficit = torch.where(flagged[..., None] & alive, deficit, 0)
    return deficit.sum(-1).float()


def trd_row_total(m: TensorClusterModel, trc_row: torch.Tensor) -> torch.Tensor:
    """float32[...] — alive-broker replica total of topic row(s)."""
    return torch.where(m.broker_ok, trc_row, 0).sum(-1).float()


def trd_row_pen(
    m: TensorClusterModel,
    cfg: GoalConfig,
    trc_row: torch.Tensor,   # int32[..., B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw_pen, n_offenders) float32[...] for topic row(s). Band edges are
    ceil/floor of avg*threshold, so the raw penalty is integer-valued."""
    alive = m.broker_ok
    avg = trd_row_total(m, trc_row) / _n_alive(m)
    t = cfg.topic_replica_balance_threshold
    upper = torch.ceil(avg * t)[..., None]
    lower = torch.floor(avg * (2.0 - t))[..., None]
    counts = trc_row.float()
    pen = (counts - upper).clamp(min=0) + (lower - counts).clamp(min=0)
    pen = torch.where(alive, pen, 0.0)
    return pen.sum(-1), (pen > 0).sum(-1).float()


def trd_normalizer(m: TensorClusterModel, topic_totals: torch.Tensor) -> torch.Tensor:
    """Normalizer of the TopicReplicaDistribution cost: mean over topics of
    max(avg replicas per alive broker, 1). ``topic_totals`` is
    float32[..., T]; the result has the leading dimensions."""
    avg = topic_totals / _n_alive(m)
    norm = avg.clamp(min=1.0).mean(-1)
    return torch.where(norm > 0, norm, 1.0)
