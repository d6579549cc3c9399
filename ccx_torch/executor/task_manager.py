"""Execution planning — per-broker queues, caps, and progress tracking.

Parity: ``executor/{ExecutionTaskPlanner,ExecutionTaskManager,
ExecutionTaskTracker}.java`` (SURVEY.md C24): proposals become typed task
queues; each planning round hands out the next batch of inter-broker moves
respecting ``num.concurrent.partition.movements.per.broker`` (both source and
destination brokers count), ``max.num.cluster.movements``, and the strategy
chain's ordering; leadership tasks batch under
``num.concurrent.leader.movements``; the tracker aggregates task states for
the ``state?substates=executor`` response.
"""

from __future__ import annotations

import collections
import dataclasses

from ccx_torch.common.metadata import ClusterMetadata
from ccx_torch.executor.execution_task import (
    ExecutionTask,
    TaskState,
    TaskType,
    tasks_from_proposals,
)
from ccx_torch.executor.strategy import ReplicaMovementStrategy
from ccx_torch.proposals import ExecutionProposal


@dataclasses.dataclass
class ExecutionCaps:
    """Ref ExecutorConfig concurrency keys (C24)."""

    per_broker_inter: int = 5
    per_broker_intra: int = 2
    leadership_batch: int = 1000
    max_cluster_movements: int = 1250

    @classmethod
    def from_config(cls, config) -> "ExecutionCaps":
        return cls(
            config["num.concurrent.partition.movements.per.broker"],
            config["num.concurrent.intra.broker.partition.movements"],
            config["num.concurrent.leader.movements"],
            config["max.num.cluster.movements"],
        )


class ExecutionTaskTracker:
    """State/type counts + data-volume progress (ref C24)."""

    def __init__(self, tasks: dict[TaskType, list[ExecutionTask]]) -> None:
        self._tasks = tasks

    def all_tasks(self) -> list[ExecutionTask]:
        return [t for ts in self._tasks.values() for t in ts]

    def tasks_of(self, type_: TaskType,
                 state: TaskState | None = None) -> list[ExecutionTask]:
        ts = self._tasks.get(type_, [])
        return [t for t in ts if state is None or t.state is state]

    def counts(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for type_, ts in self._tasks.items():
            c = collections.Counter(t.state.value for t in ts)
            out[type_.value] = dict(c)
        return out

    @property
    def finished(self) -> bool:
        return all(
            t.state in (TaskState.COMPLETED, TaskState.DEAD, TaskState.ABORTED)
            for t in self.all_tasks()
        )

    def data_moved_mb(self) -> tuple[float, float]:
        inter = self._tasks.get(TaskType.INTER_BROKER_REPLICA_ACTION, [])
        total = sum(t.data_to_move_mb for t in inter)
        done = sum(
            t.data_to_move_mb for t in inter if t.state is TaskState.COMPLETED
        )
        return done, total

    def to_json(self) -> dict:
        done, total = self.data_moved_mb()
        return {
            "taskCounts": self.counts(),
            "finishedDataMovementMb": done,
            "totalDataToMoveMb": total,
        }


class ExecutionTaskPlanner:
    """Hands out ready batches under the caps (ref C24).

    When a device-scheduled movement plan (``ccx.search.movement``) rides the
    proposal, ``wave_by_partition`` maps dense partition index -> wave, and
    ``inter_broker_batch`` serves waves as barriers: while any task of wave W
    is in progress, only waves <= W may start. Per-broker caps and the
    cluster-wide budget remain as defense in depth; with no plan the batching
    is exactly the legacy greedy (test-pinned)."""

    def __init__(self, strategy: ReplicaMovementStrategy,
                 caps: ExecutionCaps,
                 wave_by_partition: dict[int, int] | None = None) -> None:
        self.strategy = strategy
        self.caps = caps
        self.wave_by_partition = wave_by_partition or {}

    def _wave_of(self, task: ExecutionTask) -> int:
        # Partitions absent from the plan (RF changes folded in later, plan
        # truncation) default to wave 0 so they are never starved.
        return self.wave_by_partition.get(int(task.proposal.partition), 0)

    def inter_broker_batch(
        self,
        tracker: ExecutionTaskTracker,
        metadata: ClusterMetadata | None,
        per_broker_cap: int | None = None,
    ) -> list[ExecutionTask]:
        """Next inter-broker tasks to start: strategy order, skipping tasks
        whose source or destination broker is at its concurrent-movement cap,
        bounded by the cluster-wide in-flight cap. With a movement plan, the
        candidate set is first narrowed to the active wave (see class doc)."""
        cap = per_broker_cap if per_broker_cap is not None else self.caps.per_broker_inter
        in_progress = tracker.tasks_of(
            TaskType.INTER_BROKER_REPLICA_ACTION, TaskState.IN_PROGRESS
        )
        in_flight_per_broker: collections.Counter = collections.Counter()
        for t in in_progress:
            for b in t.involved_brokers:
                in_flight_per_broker[b] += 1
        budget = self.caps.max_cluster_movements - len(in_progress)
        batch: list[ExecutionTask] = []
        pending = self.strategy.sorted_tasks(
            tracker.tasks_of(TaskType.INTER_BROKER_REPLICA_ACTION, TaskState.PENDING),
            metadata,
        )
        if self.wave_by_partition and pending:
            if in_progress:
                active = min(self._wave_of(t) for t in in_progress)
            else:
                active = min(self._wave_of(t) for t in pending)
            pending = [t for t in pending if self._wave_of(t) <= active]
        for t in pending:
            if len(batch) >= budget:
                break
            if any(in_flight_per_broker[b] >= cap for b in t.involved_brokers):
                continue
            for b in t.involved_brokers:
                in_flight_per_broker[b] += 1
            batch.append(t)
        return batch

    def intra_broker_batch(self, tracker: ExecutionTaskTracker) -> list[ExecutionTask]:
        in_progress = tracker.tasks_of(
            TaskType.INTRA_BROKER_REPLICA_ACTION, TaskState.IN_PROGRESS
        )
        per_broker: collections.Counter = collections.Counter()
        for t in in_progress:
            for b in t.proposal.new_replicas:
                per_broker[b] += 1
        batch = []
        for t in tracker.tasks_of(
            TaskType.INTRA_BROKER_REPLICA_ACTION, TaskState.PENDING
        ):
            brokers = [
                b for b, od, nd in zip(
                    t.proposal.new_replicas, t.proposal.old_disks,
                    t.proposal.new_disks,
                )
                if od != nd
            ]
            if any(per_broker[b] >= self.caps.per_broker_intra for b in brokers):
                continue
            for b in brokers:
                per_broker[b] += 1
            batch.append(t)
        return batch

    def leadership_batch(self, tracker: ExecutionTaskTracker) -> list[ExecutionTask]:
        pending = tracker.tasks_of(TaskType.LEADER_ACTION, TaskState.PENDING)
        return pending[: self.caps.leadership_batch]


class ExecutionTaskManager:
    """Owns the task lifecycle for one execution (ref C24)."""

    def __init__(
        self,
        proposals: list[ExecutionProposal],
        strategy: ReplicaMovementStrategy,
        caps: ExecutionCaps,
        metadata: ClusterMetadata | None = None,
        plan: object | None = None,
    ) -> None:
        self.metadata = metadata
        self.tasks = tasks_from_proposals(proposals, metadata)
        self.tracker = ExecutionTaskTracker(self.tasks)
        self.planner = ExecutionTaskPlanner(
            strategy, caps, wave_by_partition=_plan_wave_map(plan)
        )

    def mark(self, tasks: list[ExecutionTask], state: TaskState,
             now_ms: int = -1) -> None:
        for t in tasks:
            t.transition(state, now_ms)


def _plan_wave_map(plan: object | None) -> dict[int, int]:
    """dense partition index -> wave, from a ``MovementPlan`` (or any object
    exposing int arrays ``partition``/``wave``). ``None``/empty -> {} (legacy
    greedy batching)."""
    if plan is None:
        return {}
    parts = getattr(plan, "partition", None)
    waves = getattr(plan, "wave", None)
    if parts is None or waves is None:
        return {}
    return {int(p): int(w) for p, w in zip(parts, waves)}
