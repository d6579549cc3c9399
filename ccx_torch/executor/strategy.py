"""Replica movement strategies — task ordering policies, chainable.

Parity: ``executor/strategy/`` (SURVEY.md C25): a ``ReplicaMovementStrategy``
decides the order in which pending inter-broker movement tasks are handed to
the cluster; strategies chain (``chainPreviousStrategy``) so e.g. "min-ISR
partitions with offline replicas first, then postpone URPs, then largest
replicas first" composes; ``BaseReplicaMovementStrategy`` (task-id order) is
always the final tie-breaker.

Implementation: each strategy contributes a sort key; a chain sorts by the
key tuple. Cheap, deterministic, and trivially composable — the comparator
semantics of the reference without comparator plumbing.
"""

from __future__ import annotations

from ccx_torch.common.metadata import ClusterMetadata
from ccx_torch.executor.execution_task import ExecutionTask


class ReplicaMovementStrategy:
    """SPI (ref C25). ``key(task, metadata)`` returns a sortable value;
    smaller sorts earlier."""

    def key(self, task: ExecutionTask, metadata: ClusterMetadata | None):
        raise NotImplementedError

    def chain(self, next_strategy: "ReplicaMovementStrategy") -> "ChainedStrategy":
        return ChainedStrategy([self, next_strategy])

    def sorted_tasks(self, tasks: list[ExecutionTask],
                     metadata: ClusterMetadata | None = None) -> list[ExecutionTask]:
        return sorted(tasks, key=lambda t: self.key(t, metadata))

    @property
    def name(self) -> str:
        return type(self).__name__


class ChainedStrategy(ReplicaMovementStrategy):
    def __init__(self, strategies: list[ReplicaMovementStrategy]) -> None:
        self.strategies = []
        for s in strategies:
            if isinstance(s, ChainedStrategy):
                self.strategies.extend(s.strategies)
            else:
                self.strategies.append(s)

    def key(self, task, metadata):
        return tuple(s.key(task, metadata) for s in self.strategies)

    @property
    def name(self) -> str:
        return ",".join(s.name for s in self.strategies)


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """Task-id (creation) order — the universal tie-breaker."""

    def __init__(self, config=None) -> None:
        pass

    def key(self, task, metadata):
        return task.task_id


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    """Largest data first (get the long pole started early)."""

    def __init__(self, config=None) -> None:
        pass

    def key(self, task, metadata):
        return -task.data_to_move_mb


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    """Smallest data first (maximize early completion count)."""

    def __init__(self, config=None) -> None:
        pass

    def key(self, task, metadata):
        return task.data_to_move_mb


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move healthy partitions before under-replicated ones (an URP move
    adds replication load exactly where the cluster is already fragile)."""

    def __init__(self, config=None) -> None:
        self._cache: tuple[int, frozenset] | None = None

    def _urp_set(self, metadata) -> frozenset:
        # One URP scan per metadata generation, not one per task key —
        # planning rounds sort thousands of tasks against the same snapshot.
        if self._cache is None or self._cache[0] != metadata.generation:
            self._cache = (
                metadata.generation,
                frozenset(p.tp for p in metadata.under_replicated()),
            )
        return self._cache[1]

    def key(self, task, metadata):
        if metadata is None:
            return 0
        return 1 if task.tp in self._urp_set(metadata) else 0


class PrioritizeMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """Partitions at/under min-ISR with offline replicas move first —
    they are one failure away from unavailability (ref C25)."""

    def __init__(self, config=None) -> None:
        pass

    def key(self, task, metadata):
        if metadata is None:
            return 1
        alive = metadata.alive_broker_ids()
        offline = [b for b in task.proposal.old_replicas if b not in alive]
        live = len(task.proposal.old_replicas) - len(offline)
        # at/under min-ISR (approximated as RF-1, the common min.insync.replicas)
        at_risk = offline and live <= max(len(task.proposal.old_replicas) - 1, 1)
        return 0 if at_risk else 1


def build_strategy_chain(config, metadata_unused=None) -> ReplicaMovementStrategy:
    """Instantiate `replica.movement.strategies` + default tie-breaker
    (ref ExecutorConfig / ExecutionTaskPlanner strategy wiring)."""
    from ccx_torch.config.definition import resolve_class

    strategies: list[ReplicaMovementStrategy] = []
    for path in config["replica.movement.strategies"]:
        cls = resolve_class(path) if isinstance(path, str) else path
        strategies.append(cls())
    tail = config["default.replica.movement.strategy.class"]
    tail_cls = resolve_class(tail) if isinstance(tail, str) else tail
    strategies.append(tail_cls())
    return ChainedStrategy(strategies)
