"""Synthetic cluster fixtures (seeded numpy generator).

An own copy of the JAX package's generator: for equal specs it draws the
identical numpy arrays, so both packages build bit-identical inputs. The
benchmark specs B1-B6 match BASELINE.json's configurations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccx_torch.common.resources import NUM_RESOURCES, Resource
from ccx_torch.model.tensor_model import (
    TensorClusterModel,
    build_model,
    model_arrays,
    model_from_arrays,
)

#: fields with a partition axis: first, or (the loads) second
_PARTITION_FIELDS = (
    "assignment", "leader_slot", "replica_disk", "partition_valid",
    "partition_topic", "partition_immovable",
)
_PARTITION_LOAD_FIELDS = ("leader_load", "follower_load")


def small_deterministic(device: str | torch.device | None = None) -> TensorClusterModel:
    """A tiny 3-rack / 3-broker / 2-topic model with hand-auditable loads:
    topic A has 2 partitions (RF=2), topic B has 1 partition (RF=3)."""
    assignment = np.array([[0, 1, -1], [1, 2, -1], [0, 1, 2]], np.int32)
    partition_topic = np.array([0, 0, 1], np.int32)
    leader_load = np.array(
        [
            [20.0, 10.0, 5.0],     # CPU
            [100.0, 50.0, 20.0],   # NW_IN
            [80.0, 40.0, 10.0],    # NW_OUT
            [300.0, 150.0, 60.0],  # DISK
        ],
        np.float32,
    )
    follower_load = leader_load.copy()
    follower_load[Resource.CPU] *= 0.5
    follower_load[Resource.NW_OUT] = 0.0
    broker_capacity = np.tile(
        np.array([[100.0], [2000.0], [2000.0], [5000.0]], np.float32), (1, 3)
    )
    return build_model(
        assignment=assignment,
        leader_load=leader_load,
        follower_load=follower_load,
        broker_capacity=broker_capacity,
        broker_rack=np.array([0, 1, 2], np.int32),
        partition_topic=partition_topic,
        pad=False,
        device=device,
    )


@dataclasses.dataclass
class RandomClusterSpec:
    """Knobs mirroring the reference's RandomCluster parameterization."""

    n_brokers: int = 10
    n_racks: int = 3
    n_topics: int = 10
    n_partitions: int = 1000
    min_rf: int = 2
    max_rf: int = 3
    #: mean per-partition loads, per resource (CPU %, KB/s, KB/s, MB)
    mean_load: tuple[float, float, float, float] = (0.2, 80.0, 160.0, 350.0)
    #: broker capacity headroom multiplier over perfectly-balanced load
    capacity_headroom: float = 2.5
    follower_cpu_fraction: float = 0.5
    #: fraction of partitions whose first replica lands on a hot-spot subset
    skew: float = 0.6
    n_dead_brokers: int = 0
    n_disks: int = 1
    #: brokers per physical host (1 = every broker its own host); hosts never
    #: span racks
    brokers_per_host: int = 1
    seed: int = 0


def random_cluster_arrays(spec: RandomClusterSpec) -> dict:
    """The unpadded numpy inputs of ``random_cluster`` (``build_model``
    keyword arguments)."""
    rng = np.random.default_rng(spec.seed)
    P, B = spec.n_partitions, spec.n_brokers
    R = spec.max_rf

    partition_topic = np.sort(rng.integers(0, spec.n_topics, P)).astype(np.int32)
    rf = rng.integers(spec.min_rf, spec.max_rf + 1, P)

    hot = max(1, B // 4)
    assignment = np.full((P, R), -1, np.int32)
    for p in range(P):
        if rng.random() < spec.skew:
            # biased: first replica from the hot set, rest anywhere
            pool = np.concatenate(
                [rng.permutation(hot)[:1], rng.permutation(B)[: rf[p] * 2]]
            )
            seen: list[int] = []
            for b in pool:
                if b not in seen:
                    seen.append(int(b))
                if len(seen) == rf[p]:
                    break
            assignment[p, : rf[p]] = seen
        else:
            assignment[p, : rf[p]] = rng.choice(B, size=rf[p], replace=False)

    # log-normal-ish loads: a few heavy partitions, many light ones
    mean = np.asarray(spec.mean_load, np.float32)
    raw = rng.lognormal(mean=0.0, sigma=1.0, size=(NUM_RESOURCES, P)).astype(np.float32)
    leader_load = raw * (mean / np.exp(0.5))[:, None]
    follower_load = leader_load.copy()
    follower_load[Resource.CPU] *= spec.follower_cpu_fraction
    follower_load[Resource.NW_OUT] = 0.0

    total = leader_load.sum(axis=1) + follower_load.sum(axis=1) * (rf.mean() - 1)
    per_broker = total / B * spec.capacity_headroom
    broker_capacity = np.tile(per_broker[:, None], (1, B)).astype(np.float32)
    broker_rack = (np.arange(B) % spec.n_racks).astype(np.int32)
    pos_in_rack = np.arange(B) // spec.n_racks
    host_key = broker_rack.astype(np.int64) * B + pos_in_rack // max(spec.brokers_per_host, 1)
    broker_host = np.unique(host_key, return_inverse=True)[1].astype(np.int32)

    broker_alive = np.ones(B, bool)
    if spec.n_dead_brokers:
        dead = rng.choice(B, size=spec.n_dead_brokers, replace=False)
        broker_alive[dead] = False

    disk_capacity = None
    replica_disk = None
    if spec.n_disks > 1:
        # broker DISK capacity == sum of its disks (JBOD invariant)
        disk_capacity = np.full(
            (B, spec.n_disks), per_broker[Resource.DISK] / spec.n_disks, np.float32
        )
        replica_disk = np.where(
            assignment >= 0, rng.integers(0, spec.n_disks, (P, R)), -1
        ).astype(np.int32)

    return dict(
        assignment=assignment,
        leader_load=leader_load,
        follower_load=follower_load,
        broker_capacity=broker_capacity,
        broker_rack=broker_rack,
        broker_host=broker_host,
        partition_topic=partition_topic,
        broker_alive=broker_alive,
        disk_capacity=disk_capacity,
        replica_disk=replica_disk,
        num_racks=spec.n_racks,
    )


def random_cluster(
    spec: RandomClusterSpec, device: str | torch.device | None = None
) -> TensorClusterModel:
    """A seeded random cluster with deliberate imbalance (``skew`` of the
    partitions put their first replica on the first quarter of brokers)."""
    return build_model(**random_cluster_arrays(spec), device=device)


def shuffled_partitions(m: TensorClusterModel, seed: int) -> TensorClusterModel:
    """The same cluster with its partition axis (padding included) in a
    seeded random order, on the model's device. A fixture's partitions come
    sorted by topic; a snapshot's need not."""
    perm = np.random.default_rng(seed).permutation(m.P)
    arrays = model_arrays(m)
    for name in _PARTITION_FIELDS:
        arrays[name] = arrays[name][perm]
    for name in _PARTITION_LOAD_FIELDS:
        arrays[name] = arrays[name][:, perm]
    return model_from_arrays(arrays, m.num_topics, m.num_racks, m.device)


def bench_spec(name: str) -> RandomClusterSpec:
    """Named benchmark cluster specs matching BASELINE.json configs."""
    if name == "B1":  # 10 brokers / 1k partitions
        return RandomClusterSpec(n_brokers=10, n_partitions=1_000, seed=1)
    if name == "B2":  # default goal stack, 50 brokers
        return RandomClusterSpec(
            n_brokers=50, n_racks=5, n_topics=40, n_partitions=5_000, seed=2
        )
    if name == "B3":  # self-healing: dead broker evacuation
        return RandomClusterSpec(
            n_brokers=20, n_racks=4, n_topics=20, n_partitions=2_000,
            n_dead_brokers=2, seed=3,
        )
    if name == "B4":  # JBOD intra-broker disk rebalance
        return RandomClusterSpec(n_brokers=10, n_partitions=1_000, n_disks=4, seed=4)
    if name == "B5":  # 1000 brokers / 100k partitions, full stack
        return RandomClusterSpec(
            n_brokers=1_000, n_racks=20, n_topics=500, n_partitions=100_000,
            skew=0.3, seed=5,
        )
    if name == "B6":  # 10k brokers / 1M partitions
        return RandomClusterSpec(
            n_brokers=10_000, n_racks=40, n_topics=2_000,
            n_partitions=1_000_000, skew=0.3, seed=6,
        )
    raise KeyError(name)
