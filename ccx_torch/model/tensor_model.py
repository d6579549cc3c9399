"""TensorClusterModel — the cluster as a dataclass of device tensors.

Layout (P = padded partitions, R = max replication factor, B = padded
brokers, D = max disks per broker, T = topics; RES = NUM_RESOURCES), the same
as the JAX package's model:

* ``assignment  : int32[P, R]``  broker index per replica slot, -1 = no slot.
  Slot order is the preferred replica order (slot 0 = preferred leader).
* ``leader_slot : int32[P]``     which slot currently leads.
* ``replica_disk: int32[P, R]``  disk index on the hosting broker (JBOD).
* ``leader_load / follower_load : float32[RES, P]`` — the load a replica of
  partition p exerts in each role (follower NW_OUT is 0).
* broker-axis tensors: capacity, rack, host, liveness, validity, new-broker
  and exclusion masks; disk-axis capacity/liveness for JBOD.
* ``partition_topic: int32[P]`` and ``topic_min_leaders: bool[T]``.

Padding: invalid entries are masked (valid=False) with zero loads, so every
reduction can run over full axes. P and B pad to power-of-two buckets.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ccx_torch.common.resources import NUM_RESOURCES, Resource
from ccx_torch.device import resolve_device


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class TensorClusterModel:
    # --- partition / replica axis ---
    assignment: torch.Tensor        # int32[P, R]
    leader_slot: torch.Tensor       # int32[P]
    replica_disk: torch.Tensor      # int32[P, R]
    partition_valid: torch.Tensor   # bool[P]
    partition_topic: torch.Tensor   # int32[P]
    partition_immovable: torch.Tensor  # bool[P]
    leader_load: torch.Tensor       # float32[RES, P]
    follower_load: torch.Tensor     # float32[RES, P]
    # --- broker axis ---
    broker_capacity: torch.Tensor   # float32[RES, B]
    broker_rack: torch.Tensor       # int32[B]
    broker_host: torch.Tensor       # int32[B]
    broker_valid: torch.Tensor      # bool[B]
    broker_alive: torch.Tensor      # bool[B]
    broker_new: torch.Tensor        # bool[B]
    broker_excl_replicas: torch.Tensor    # bool[B]
    broker_excl_leadership: torch.Tensor  # bool[B]
    # --- disk axis (JBOD) ---
    disk_capacity: torch.Tensor     # float32[B, D]
    disk_alive: torch.Tensor        # bool[B, D]
    # --- topic axis ---
    topic_min_leaders: torch.Tensor  # bool[T]
    # --- static metadata ---
    num_topics: int
    num_racks: int

    @property
    def device(self) -> torch.device:
        return self.assignment.device

    @property
    def P(self) -> int:
        return self.assignment.shape[0]

    @property
    def R(self) -> int:
        return self.assignment.shape[1]

    @property
    def B(self) -> int:
        return self.broker_rack.shape[0]

    @property
    def D(self) -> int:
        return self.disk_capacity.shape[1]

    @property
    def replica_valid(self) -> torch.Tensor:
        """bool[P, R] — slot holds a replica."""
        return (self.assignment >= 0) & self.partition_valid[:, None]

    @property
    def is_leader(self) -> torch.Tensor:
        """bool[P, R] — slot is the current leader of its partition."""
        slots = torch.arange(self.R, dtype=torch.int32, device=self.device)
        return (slots[None, :] == self.leader_slot[:, None]) & self.replica_valid

    @property
    def replica_load(self) -> torch.Tensor:
        """float32[RES, P, R] — role-resolved load of each replica slot."""
        load = torch.where(
            self.is_leader[None], self.leader_load[:, :, None],
            self.follower_load[:, :, None],
        )
        return torch.where(self.replica_valid[None], load, 0.0)

    @property
    def broker_ok(self) -> torch.Tensor:
        """bool[B] — valid and alive."""
        return self.broker_valid & self.broker_alive

    def replace(self, **changes) -> "TensorClusterModel":
        return dataclasses.replace(self, **changes)


#: tensor fields in declaration order (the carry-across key set)
TENSOR_FIELDS: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(TensorClusterModel)
    if f.name not in ("num_topics", "num_racks")
)

_INT_FIELDS = {
    "assignment", "leader_slot", "replica_disk", "partition_topic",
    "broker_rack", "broker_host",
}
_FLOAT_FIELDS = {
    "leader_load", "follower_load", "broker_capacity", "disk_capacity",
}


def model_from_arrays(
    arrays: dict[str, np.ndarray],
    num_topics: int,
    num_racks: int,
    device: str | torch.device | None = None,
) -> TensorClusterModel:
    """The carry-across function: a model from numpy copies of every tensor
    field (already padded), e.g. read out of the JAX package's model, so
    both packages score the identical cluster."""
    dev = resolve_device(device)
    kw: dict[str, Any] = {}
    for name in TENSOR_FIELDS:
        a = np.asarray(arrays[name])
        if name in _INT_FIELDS:
            a = a.astype(np.int32)
        elif name in _FLOAT_FIELDS:
            a = a.astype(np.float32)
        else:
            a = a.astype(bool)
        kw[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return TensorClusterModel(num_topics=int(num_topics), num_racks=int(num_racks), **kw)


def model_arrays(m: TensorClusterModel) -> dict[str, np.ndarray]:
    """Numpy copies of every tensor field (inverse of ``model_from_arrays``)."""
    return {name: getattr(m, name).cpu().numpy() for name in TENSOR_FIELDS}


def build_model(
    *,
    assignment: np.ndarray,
    leader_load: np.ndarray,
    follower_load: np.ndarray,
    broker_capacity: np.ndarray,
    broker_rack: np.ndarray | None = None,
    broker_host: np.ndarray | None = None,
    partition_topic: np.ndarray | None = None,
    leader_slot: np.ndarray | None = None,
    replica_disk: np.ndarray | None = None,
    broker_alive: np.ndarray | None = None,
    broker_new: np.ndarray | None = None,
    broker_excl_replicas: np.ndarray | None = None,
    broker_excl_leadership: np.ndarray | None = None,
    partition_immovable: np.ndarray | None = None,
    disk_capacity: np.ndarray | None = None,
    disk_alive: np.ndarray | None = None,
    topic_min_leaders: np.ndarray | None = None,
    num_racks: int | None = None,
    pad: bool = True,
    device: str | torch.device | None = None,
) -> TensorClusterModel:
    """Assemble + pad a model from dense unpadded numpy inputs.

    ``assignment`` is int[P, R] with -1 for absent slots; every other array is
    sized to the true P / B / D / T. With ``pad=True`` the P, B and T axes grow
    to power-of-two buckets (P >= 64, B >= 8, T >= 4) — the JAX package's
    rules, so equal inputs give equal padded shapes in both packages."""
    dev = resolve_device(device)
    assignment = np.asarray(assignment, np.int32)
    P, R = assignment.shape
    broker_capacity = np.asarray(broker_capacity, np.float32)
    B = int(broker_capacity.reshape(NUM_RESOURCES, -1).shape[1])
    leader_load = np.asarray(leader_load, np.float32).reshape(NUM_RESOURCES, P)
    follower_load = np.asarray(follower_load, np.float32).reshape(NUM_RESOURCES, P)
    broker_capacity = broker_capacity.reshape(NUM_RESOURCES, B)
    if broker_host is None:
        broker_host = np.arange(B, dtype=np.int32)
    broker_host = np.asarray(broker_host, np.int32)
    if broker_rack is None:
        # a broker without rack information is its own host's rack, densified
        broker_rack = np.unique(broker_host, return_inverse=True)[1]
    broker_rack = np.asarray(broker_rack, np.int32)
    if partition_topic is None:
        partition_topic = np.zeros(P, np.int32)
    partition_topic = np.asarray(partition_topic, np.int32)
    T = int(partition_topic.max(initial=0)) + 1
    if leader_slot is None:
        leader_slot = np.zeros(P, np.int32)
    if replica_disk is None:
        replica_disk = np.where(assignment >= 0, 0, -1).astype(np.int32)
    if disk_capacity is None:
        disk_capacity = broker_capacity[Resource.DISK][:, None].copy()
    disk_capacity = np.asarray(disk_capacity, np.float32)
    if disk_alive is None:
        disk_alive = np.ones(disk_capacity.shape, bool)
    if broker_alive is None:
        broker_alive = np.ones(B, bool)
    if broker_new is None:
        broker_new = np.zeros(B, bool)
    if broker_excl_replicas is None:
        broker_excl_replicas = np.zeros(B, bool)
    if broker_excl_leadership is None:
        broker_excl_leadership = np.zeros(B, bool)
    if partition_immovable is None:
        partition_immovable = np.zeros(P, bool)
    if topic_min_leaders is None:
        topic_min_leaders = np.zeros(T, bool)
    topic_min_leaders = np.asarray(topic_min_leaders, bool)
    T = max(T, topic_min_leaders.shape[0])
    if pad:
        T = bucket_size(T, 4)
    topic_min_leaders = np.pad(topic_min_leaders, (0, T - topic_min_leaders.shape[0]))
    if num_racks is None:
        num_racks = int(broker_rack.max(initial=0)) + 1
    Pp, Bp = (bucket_size(P, 64), bucket_size(B, 8)) if pad else (P, B)

    def pad_p(a: np.ndarray, fill: Any = 0) -> np.ndarray:
        return np.pad(a, [(0, Pp - P)] + [(0, 0)] * (a.ndim - 1), constant_values=fill)

    def pad_b(a: np.ndarray, fill: Any = 0, axis: int = 0) -> np.ndarray:
        width = [(0, 0)] * a.ndim
        width[axis] = (0, Bp - B)
        return np.pad(a, width, constant_values=fill)

    # padding hosts get fresh ids so a padded slot never aliases a real host
    host = np.concatenate(
        [broker_host, broker_host.max(initial=-1) + 1 + np.arange(Bp - B, dtype=np.int32)]
    )
    arrays = {
        "assignment": pad_p(assignment, -1),
        "leader_slot": pad_p(np.asarray(leader_slot, np.int32)),
        "replica_disk": pad_p(np.asarray(replica_disk, np.int32), -1),
        "partition_valid": pad_p(np.ones(P, bool)),
        "partition_topic": pad_p(partition_topic),
        "partition_immovable": pad_p(np.asarray(partition_immovable, bool)),
        "leader_load": np.pad(leader_load, [(0, 0), (0, Pp - P)]),
        "follower_load": np.pad(follower_load, [(0, 0), (0, Pp - P)]),
        "broker_capacity": pad_b(broker_capacity, axis=1),
        "broker_rack": pad_b(broker_rack),
        "broker_host": host,
        "broker_valid": pad_b(np.ones(B, bool)),
        "broker_alive": pad_b(np.asarray(broker_alive, bool)),
        "broker_new": pad_b(np.asarray(broker_new, bool)),
        "broker_excl_replicas": pad_b(np.asarray(broker_excl_replicas, bool)),
        "broker_excl_leadership": pad_b(np.asarray(broker_excl_leadership, bool)),
        "disk_capacity": pad_b(disk_capacity),
        "disk_alive": pad_b(np.asarray(disk_alive, bool)),
        "topic_min_leaders": topic_min_leaders,
    }
    return model_from_arrays(arrays, T, num_racks, dev)
