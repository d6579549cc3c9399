"""Execution proposals — the diff of two placements, columnar first.

The reference's ``AnalyzerUtils.getDiff`` turns the optimized model into
``ExecutionProposal`` records (old/new replica lists and leaders) for the
executor. Here the canonical diff is columnar (``ColumnarDiff``): flat int32
numpy columns, one row per changed partition. ``columnar_diff`` computes the
change mask and the compaction on the models' device and moves only the
changed rows to the host; the row view is built lazily on request.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccx_torch.model.tensor_model import TensorClusterModel


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    """One partition's reassignment (ref: executor/ExecutionProposal.java)."""

    partition: int
    topic: int
    old_replicas: tuple[int, ...]
    new_replicas: tuple[int, ...]
    old_leader: int
    new_leader: int
    old_disks: tuple[int, ...] = ()
    new_disks: tuple[int, ...] = ()

    @property
    def data_to_move(self) -> int:
        """Count of replicas that change broker (the executor's concurrency
        caps are per movement)."""
        return len(set(self.new_replicas) - set(self.old_replicas))

    def to_json(self) -> dict:
        out = {
            "topicPartition": {"topic": int(self.topic), "partition": int(self.partition)},
            "oldLeader": int(self.old_leader),
            "newLeader": int(self.new_leader),
            "oldReplicas": [int(b) for b in self.old_replicas],
            "newReplicas": [int(b) for b in self.new_replicas],
        }
        if self.old_disks or self.new_disks:
            out["oldDisks"] = [int(d) for d in self.old_disks]
            out["newDisks"] = [int(d) for d in self.new_disks]
        return out


#: column order of a ``ColumnarDiff``
COLUMNS = (
    "partition", "topic", "oldReplicas", "newReplicas",
    "oldLeader", "newLeader", "oldDisks", "newDisks",
)


class ColumnarDiff:
    """One row per changed partition: ``partition/topic/oldLeader/newLeader
    int32[N]`` and ``oldReplicas/newReplicas/oldDisks/newDisks int32[N, R]``
    (-1 pad), as numpy arrays; ``rows`` builds ``ExecutionProposal``s on
    first access."""

    __slots__ = ("cols", "_rows")

    def __init__(self, cols: dict[str, np.ndarray]) -> None:
        self.cols = cols
        self._rows = None

    def __repr__(self) -> str:
        return f"ColumnarDiff(n={self.n})"

    @property
    def n(self) -> int:
        return int(self.cols["partition"].shape[0])

    def __len__(self) -> int:
        return self.n

    @property
    def num_replica_movements(self) -> int:
        """Replicas changing broker (a new replica whose broker is absent
        from the row's old set)."""
        new, old = self.cols["newReplicas"], self.cols["oldReplicas"]
        if new.size == 0:
            return 0
        member = (new[:, :, None] == old[:, None, :]).any(axis=2)
        return int(((new >= 0) & ~member).sum())

    @property
    def num_leadership_movements(self) -> int:
        return int((self.cols["oldLeader"] != self.cols["newLeader"]).sum())

    @property
    def rows(self) -> list[ExecutionProposal]:
        if self._rows is None:
            c = self.cols
            self._rows = [
                ExecutionProposal(
                    partition=p,
                    topic=t,
                    old_replicas=tuple(b for b in r0 if b >= 0),
                    new_replicas=tuple(b for b in r1 if b >= 0),
                    old_leader=s0,
                    new_leader=s1,
                    old_disks=tuple(d for d, b in zip(k0, r0) if b >= 0),
                    new_disks=tuple(d for d, b in zip(k1, r1) if b >= 0),
                )
                for p, t, r0, r1, s0, s1, k0, k1 in zip(
                    *(c[k].tolist() for k in COLUMNS)
                )
            ]
        return self._rows

    def rows_json(self) -> list[dict]:
        return [p.to_json() for p in self.rows]


def columnar_diff(before: TensorClusterModel, after: TensorClusterModel) -> ColumnarDiff:
    """The changed partitions of ``after`` against ``before``: mask and
    compaction on the models' device, then one host transfer per column of
    the changed rows only."""
    a0, a1 = before.assignment, after.assignment
    l0, l1 = before.leader_slot, after.leader_slot
    d0, d1 = before.replica_disk, after.replica_disk
    changed = before.partition_valid & (
        (a0 != a1).any(1) | (l0 != l1) | (d0 != d1).any(1)
    )
    idx = torch.nonzero(changed)[:, 0]
    g0, g1 = a0[idx], a1[idx]
    R = a0.shape[1]

    def leader(g, slot):
        lead = g.gather(1, slot[idx].clamp(0, R - 1).long()[:, None])[:, 0]
        return torch.where((g >= 0).any(1), lead, -1)

    cols = {
        "partition": idx.int(),
        "topic": before.partition_topic[idx],
        "oldReplicas": g0,
        "newReplicas": g1,
        "oldLeader": leader(g0, l0),
        "newLeader": leader(g1, l1),
        "oldDisks": torch.where(g0 >= 0, d0[idx], -1),
        "newDisks": torch.where(g1 >= 0, d1[idx], -1),
    }
    return ColumnarDiff({k: cols[k].int().cpu().numpy() for k in COLUMNS})
