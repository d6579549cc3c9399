"""Goal SPI — each reference Goal class becomes a penalty function.

A goal is a function ``(model, aggregates, config) -> GoalResult`` scoring
one placement (or a batch of aggregate states); search owns all mutation.
Every goal registers under the reference class name (e.g. "RackAwareGoal").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import torch

from ccx_torch.common.resources import (
    DEFAULT_BALANCE_THRESHOLD,
    DEFAULT_CAPACITY_THRESHOLD,
    Resource,
)

_CAPACITY_DEFAULT = tuple(DEFAULT_CAPACITY_THRESHOLD[r] for r in Resource)
_BALANCE_DEFAULT = tuple(DEFAULT_BALANCE_THRESHOLD[r] for r in Resource)


@dataclasses.dataclass(frozen=True)
class GoalConfig:
    """Static analyzer thresholds (AnalyzerConfig keys): capacity thresholds
    ``*.capacity.threshold``, balance thresholds ``*.balance.threshold``,
    count balance thresholds, ``max.replicas.per.broker``,
    ``min.topic.leaders.per.broker``, low-utilization gates."""

    capacity_threshold: tuple[float, float, float, float] = _CAPACITY_DEFAULT
    balance_threshold: tuple[float, float, float, float] = _BALANCE_DEFAULT
    low_utilization_threshold: tuple[float, float, float, float] = (0.0,) * 4
    replica_balance_threshold: float = 1.1
    leader_balance_threshold: float = 1.1
    topic_replica_balance_threshold: float = 1.1
    leader_bytes_in_balance_threshold: float = 1.1
    max_replicas_per_broker: float = 10_000.0
    min_topic_leaders_per_broker: int = 1
    intra_disk_capacity_threshold: float = 0.8
    intra_disk_balance_gap: float = 0.2  # |disk util - broker avg util| allowed

    @classmethod
    def from_config(cls, config) -> "GoalConfig":
        """Bridge from the service-level ``CruiseControlConfig`` key table
        (``ccx_torch.config``) to the analyzer thresholds."""
        return cls(
            capacity_threshold=(
                config["cpu.capacity.threshold"],
                config["network.inbound.capacity.threshold"],
                config["network.outbound.capacity.threshold"],
                config["disk.capacity.threshold"],
            ),
            balance_threshold=(
                config["cpu.balance.threshold"],
                config["network.inbound.balance.threshold"],
                config["network.outbound.balance.threshold"],
                config["disk.balance.threshold"],
            ),
            low_utilization_threshold=(
                config["cpu.low.utilization.threshold"],
                config["network.inbound.low.utilization.threshold"],
                config["network.outbound.low.utilization.threshold"],
                config["disk.low.utilization.threshold"],
            ),
            leader_bytes_in_balance_threshold=config["leader.bytes.in.balance.threshold"],
            replica_balance_threshold=config["replica.count.balance.threshold"],
            leader_balance_threshold=config["leader.replica.count.balance.threshold"],
            topic_replica_balance_threshold=config["topic.replica.count.balance.threshold"],
            max_replicas_per_broker=float(config["max.replicas.per.broker"]),
            min_topic_leaders_per_broker=config["min.topic.leaders.per.broker"],
        )


@dataclasses.dataclass(frozen=True)
class GoalResult:
    """violations: discrete count (verification / reporting); cost: smooth
    normalized penalty search descends. Both 0 when satisfied; float32, with
    the aggregates' leading batch dimensions."""

    violations: torch.Tensor
    cost: torch.Tensor


class GoalFn(Protocol):
    def __call__(self, m, agg, cfg: GoalConfig) -> GoalResult: ...


@dataclasses.dataclass(frozen=True)
class GoalSpec:
    name: str
    fn: GoalFn
    hard: bool
    #: reference class this corresponds to
    ref_class: str = ""
    #: True when the goal reads per-partition placement rather than only
    #: aggregates + static broker attributes
    placement_dependent: bool = False


GOAL_REGISTRY: dict[str, GoalSpec] = {}


def register_goal(
    name: str, *, hard: bool, ref_class: str = "", placement_dependent: bool = False
) -> Callable[[GoalFn], GoalFn]:
    def deco(fn: GoalFn) -> GoalFn:
        GOAL_REGISTRY[name] = GoalSpec(
            name=name, fn=fn, hard=hard, ref_class=ref_class or name,
            placement_dependent=placement_dependent,
        )
        return fn

    return deco


def result(violations: torch.Tensor, cost: torch.Tensor) -> GoalResult:
    return GoalResult(violations=violations.float(), cost=cost.float())
