"""Execution tasks — the unit of cluster mutation.

Parity: ``executor/{ExecutionProposal,ExecutionTask,ExecutionTaskTracker}
.java`` (SURVEY.md C24): the planner turns each ``ExecutionProposal``
(ccx.proposals) into typed tasks — inter-broker replica movement,
intra-broker (disk) movement, leadership movement — which progress through
the reference's task state machine PENDING → IN_PROGRESS →
{COMPLETED | DEAD | ABORTING → ABORTED}.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools

from ccx_torch.common.metadata import TopicPartition
from ccx_torch.proposals import ExecutionProposal


class TaskType(enum.Enum):
    INTER_BROKER_REPLICA_ACTION = "inter_broker_replica_action"
    INTRA_BROKER_REPLICA_ACTION = "intra_broker_replica_action"
    LEADER_ACTION = "leader_action"


class TaskState(enum.Enum):
    PENDING = "pending"
    IN_PROGRESS = "in_progress"
    ABORTING = "aborting"
    ABORTED = "aborted"
    DEAD = "dead"
    COMPLETED = "completed"


_task_ids = itertools.count()


@dataclasses.dataclass
class ExecutionTask:
    proposal: ExecutionProposal
    type: TaskType
    #: the real TopicPartition (dense indices resolved via the metadata
    #: snapshot the proposals were computed against)
    tp: TopicPartition = None  # type: ignore[assignment]
    task_id: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    state: TaskState = TaskState.PENDING
    start_ms: int = -1
    end_ms: int = -1

    def __post_init__(self) -> None:
        if self.tp is None:
            self.tp = TopicPartition(str(self.proposal.topic), self.proposal.partition)

    @property
    def data_to_move_mb(self) -> float:
        return float(self.proposal.data_to_move)

    @property
    def source_brokers(self) -> tuple[int, ...]:
        """Brokers losing a replica (inter-broker only)."""
        return tuple(
            b for b in self.proposal.old_replicas
            if b not in self.proposal.new_replicas
        )

    @property
    def destination_brokers(self) -> tuple[int, ...]:
        """Brokers gaining a replica (inter-broker only)."""
        return tuple(
            b for b in self.proposal.new_replicas
            if b not in self.proposal.old_replicas
        )

    @property
    def involved_brokers(self) -> tuple[int, ...]:
        return tuple(set(self.source_brokers) | set(self.destination_brokers))

    def transition(self, state: TaskState, now_ms: int = -1) -> None:
        valid = {
            TaskState.PENDING: {TaskState.IN_PROGRESS, TaskState.ABORTED, TaskState.DEAD},
            TaskState.IN_PROGRESS: {
                TaskState.COMPLETED, TaskState.ABORTING, TaskState.DEAD
            },
            TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
        }
        if state not in valid.get(self.state, set()):
            raise ValueError(f"illegal task transition {self.state} -> {state}")
        if state is TaskState.IN_PROGRESS:
            self.start_ms = now_ms
        if state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD):
            self.end_ms = now_ms
        self.state = state

    def to_json(self) -> dict:
        return {
            "executionId": self.task_id,
            "type": self.type.value,
            "state": self.state.value.upper(),
            "proposal": self.proposal.to_json(),
        }


def tasks_from_proposals(
    proposals: list[ExecutionProposal],
    metadata=None,
) -> dict[TaskType, list[ExecutionTask]]:
    """Split proposals into typed task lists (ref ExecutionTaskPlanner
    addExecutionProposals): an inter-broker move subsumes its leadership
    change; a pure leadership change becomes a LEADER_ACTION; disk changes on
    surviving brokers become INTRA_BROKER tasks. ``metadata`` (the snapshot
    the proposals were computed against) resolves dense partition indices to
    real TopicPartitions."""
    out: dict[TaskType, list[ExecutionTask]] = {t: [] for t in TaskType}
    for p in proposals:
        tp = None
        if metadata is not None:
            # The optimizer's tensors use dense broker/partition indices;
            # the admin surface speaks real ids — resolve here, where the
            # generation's snapshot is pinned.
            tp = metadata.partitions[p.partition].tp
            ids = [b.broker_id for b in metadata.brokers]
            p = dataclasses.replace(
                p,
                old_replicas=tuple(ids[b] for b in p.old_replicas),
                new_replicas=tuple(ids[b] for b in p.new_replicas),
                old_leader=ids[p.old_leader] if p.old_leader >= 0 else -1,
                new_leader=ids[p.new_leader] if p.new_leader >= 0 else -1,
            )
        inter = set(p.old_replicas) != set(p.new_replicas)
        if inter:
            out[TaskType.INTER_BROKER_REPLICA_ACTION].append(
                ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION, tp)
            )
        if p.old_leader != p.new_leader:
            # Every leadership change gets a LEADER_ACTION — including those
            # riding an inter-broker move: the reassignment lands the replica,
            # the leadership phase reorders preferred order + elects.
            out[TaskType.LEADER_ACTION].append(
                ExecutionTask(p, TaskType.LEADER_ACTION, tp)
            )
        if p.old_disks and p.new_disks:
            old_disk = dict(zip(p.old_replicas, p.old_disks))
            moved = [
                b for b, d in zip(p.new_replicas, p.new_disks)
                if b in old_disk and old_disk[b] != d
            ]
            if moved:
                out[TaskType.INTRA_BROKER_REPLICA_ACTION].append(
                    ExecutionTask(p, TaskType.INTRA_BROKER_REPLICA_ACTION, tp)
                )
    return out
