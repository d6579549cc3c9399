"""Broker-level aggregates — the inputs of every aggregate goal.

One pass over the flattened (partition x slot) axis produces every
per-broker load and count the goal stack reads (the reference's
``model/ClusterModelStats.java`` inputs). On a CUDA model the pass is the
hand-written kernel in ``ccx_torch/csrc/broker_aggregates.cu``; on a CPU
model it is the plain PyTorch version beside the kernel's wrapper.
"""

from __future__ import annotations

import dataclasses

import torch

from ccx_torch.common import costmodel
from ccx_torch.model.tensor_model import TensorClusterModel


@dataclasses.dataclass(frozen=True)
class BrokerAggregates:
    """Fields may carry leading batch dimensions (search chains or
    candidates) in front of the shapes below."""

    broker_load: torch.Tensor        # float32[RES, B] role-resolved load
    replica_count: torch.Tensor      # int32[B]
    leader_count: torch.Tensor       # int32[B]
    potential_nw_out: torch.Tensor   # float32[B] if every hosted replica led
    leader_bytes_in: torch.Tensor    # float32[B] NW_IN of leader replicas only
    topic_replica_count: torch.Tensor  # int32[T, B]
    topic_leader_count: torch.Tensor   # int32[T, B]
    disk_load: torch.Tensor          # float32[B, D]

    def replace(self, **changes) -> "BrokerAggregates":
        return dataclasses.replace(self, **changes)


#: the [B]-level fields search maintains incrementally (the [T, B] topic
#: matrices are not carried in a search state)
BROKER_FIELDS: tuple[str, ...] = (
    "broker_load", "replica_count", "leader_count", "potential_nw_out",
    "leader_bytes_in", "disk_load",
)


@costmodel.instrument("broker-aggregates", work=costmodel.aggregates_work_of)
def broker_aggregates(m: TensorClusterModel) -> BrokerAggregates:
    """Launches the CUDA kernel for a CUDA model (raising if it cannot),
    the plain version for a CPU model (``ccx_torch.ops.broker_aggregates``).
    Counted on the cost ledger as ``broker-aggregates``, with the pass's
    bytes and operations as its work."""
    from ccx_torch.ops import broker_aggregates as op

    if m.device.type == "cuda":
        return op.broker_aggregates_cuda(m)
    if m.device.type == "cpu":
        return op.broker_aggregates_plain(m)
    raise ValueError(f"broker_aggregates: unsupported device {m.device}")
