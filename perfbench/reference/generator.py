"""The benchmark's cluster generator: a frozen NumPy copy of the port's
seeded ``RandomCluster`` recipe, and the snapshots the traffic sends.

``random_cluster_arrays`` draws, for one configuration's spec, the same
arrays bit for bit as the port's own generator does today
(``perfbench/tests/test_perfbench_reference.py`` holds them equal on B1-B5);
it lives here so that a later change to the program cannot move a cell's
inputs. ``redraw_loads`` draws another set of partition loads and broker
capacities for the same layout with the same recipe, and ``snapshot`` fills
in every field a sidecar snapshot carries, at the values a cluster without
exclusions, new brokers or JBOD disks has.
"""

from __future__ import annotations

import numpy as np

#: resource rows of every load and capacity array
CPU, NW_IN, NW_OUT, DISK = range(4)
NUM_RESOURCES = 4
#: the snapshot schema version the sidecar reads
SCHEMA_VERSION = 2

#: the spec keys of a configuration file, with the generator's defaults
SPEC_DEFAULTS = {
    "n_brokers": 10, "n_racks": 3, "n_topics": 10, "n_partitions": 1000,
    "min_rf": 2, "max_rf": 3, "mean_load": (0.2, 80.0, 160.0, 350.0),
    "capacity_headroom": 2.5, "follower_cpu_fraction": 0.5, "skew": 0.6,
    "n_dead_brokers": 0, "n_disks": 1, "brokers_per_host": 1, "seed": 0,
}


def spec_of(config: dict) -> dict:
    """The generator's spec of a configuration file (its ``spec`` block over
    the defaults)."""
    unknown = set(config["spec"]) - set(SPEC_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown spec keys {sorted(unknown)}")
    return {**SPEC_DEFAULTS, **config["spec"]}


def _loads(spec: dict, rng: np.random.Generator, rf: np.ndarray):
    """(leader_load, follower_load, broker_capacity): log-normal partition
    loads around ``mean_load`` and every broker's capacity at
    ``capacity_headroom`` times a perfectly balanced share."""
    P, B = spec["n_partitions"], spec["n_brokers"]
    mean = np.asarray(spec["mean_load"], np.float32)
    raw = rng.lognormal(mean=0.0, sigma=1.0, size=(NUM_RESOURCES, P)).astype(np.float32)
    leader_load = raw * (mean / np.exp(0.5))[:, None]
    follower_load = leader_load.copy()
    follower_load[CPU] *= spec["follower_cpu_fraction"]
    follower_load[NW_OUT] = 0.0
    total = leader_load.sum(axis=1) + follower_load.sum(axis=1) * (rf.mean() - 1)
    per_broker = total / B * spec["capacity_headroom"]
    broker_capacity = np.tile(per_broker[:, None], (1, B)).astype(np.float32)
    return leader_load, follower_load, broker_capacity, per_broker


def random_cluster_arrays(spec: dict) -> dict:
    """The seeded cluster of ``spec``: hot-spot skewed replica layout,
    log-normal loads, racks round-robin, dead brokers drawn last."""
    rng = np.random.default_rng(spec["seed"])
    P, B = spec["n_partitions"], spec["n_brokers"]
    R = spec["max_rf"]

    partition_topic = np.sort(rng.integers(0, spec["n_topics"], P)).astype(np.int32)
    rf = rng.integers(spec["min_rf"], spec["max_rf"] + 1, P)

    hot = max(1, B // 4)
    assignment = np.full((P, R), -1, np.int32)
    for p in range(P):
        if rng.random() < spec["skew"]:
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

    leader_load, follower_load, broker_capacity, per_broker = _loads(spec, rng, rf)
    broker_rack = (np.arange(B) % spec["n_racks"]).astype(np.int32)
    pos_in_rack = np.arange(B) // spec["n_racks"]
    host_key = broker_rack.astype(np.int64) * B + pos_in_rack // max(spec["brokers_per_host"], 1)
    broker_host = np.unique(host_key, return_inverse=True)[1].astype(np.int32)

    broker_alive = np.ones(B, bool)
    if spec["n_dead_brokers"]:
        dead = rng.choice(B, size=spec["n_dead_brokers"], replace=False)
        broker_alive[dead] = False

    disk_capacity = None
    replica_disk = None
    if spec["n_disks"] > 1:
        disk_capacity = np.full(
            (B, spec["n_disks"]), per_broker[DISK] / spec["n_disks"], np.float32
        )
        replica_disk = np.where(
            assignment >= 0, rng.integers(0, spec["n_disks"], (P, R)), -1
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
        num_racks=spec["n_racks"],
    )


def snapshot(arrays: dict) -> dict:
    """A full sidecar snapshot of generated arrays: leadership on slot 0,
    one disk a broker holding its whole disk capacity, and no immovable
    partition, new broker, exclusion or min-leaders topic."""
    a = arrays["assignment"]
    P = a.shape[0]
    B = arrays["broker_capacity"].shape[1]
    T = int(arrays["partition_topic"].max(initial=0)) + 1
    replica_disk = arrays.get("replica_disk")
    disk_capacity = arrays.get("disk_capacity")
    return {
        "version": SCHEMA_VERSION,
        "num_racks": int(arrays["num_racks"]),
        "assignment": a,
        "leader_slot": np.zeros(P, np.int32),
        "replica_disk": (np.where(a >= 0, 0, -1).astype(np.int32)
                         if replica_disk is None else replica_disk),
        "partition_topic": arrays["partition_topic"],
        "partition_immovable": np.zeros(P, bool),
        "leader_load": arrays["leader_load"],
        "follower_load": arrays["follower_load"],
        "broker_capacity": arrays["broker_capacity"],
        "broker_rack": arrays["broker_rack"],
        "broker_host": arrays["broker_host"],
        "broker_alive": arrays["broker_alive"],
        "broker_new": np.zeros(B, bool),
        "broker_excl_replicas": np.zeros(B, bool),
        "broker_excl_leadership": np.zeros(B, bool),
        "disk_capacity": (arrays["broker_capacity"][DISK][:, None].copy()
                          if disk_capacity is None else disk_capacity),
        "disk_alive": np.ones((B, 1 if disk_capacity is None else disk_capacity.shape[1]), bool),
        "topic_min_leaders": np.zeros(T, bool),
    }


def redraw_loads(snap: dict, spec: dict, rng: np.random.Generator) -> dict:
    """``snap`` with new partition loads and broker capacities drawn from
    ``rng`` by the generator's own recipe (the layout is kept)."""
    rf = (snap["assignment"] >= 0).sum(axis=1)
    leader_load, follower_load, broker_capacity, per_broker = _loads(spec, rng, rf)
    out = dict(snap, leader_load=leader_load, follower_load=follower_load,
               broker_capacity=broker_capacity)
    n_disks = snap["disk_capacity"].shape[1]
    out["disk_capacity"] = np.full_like(snap["disk_capacity"], per_broker[DISK] / n_disks)
    return out


def drift_loads(snap: dict, rng: np.random.Generator, fraction: float) -> dict:
    """One metrics window: ``fraction`` of the partitions (at least one),
    drawn without replacement, have their leader loads and then their
    follower loads scaled by factors uniform in [0.5, 1.5), one per
    partition and role."""
    P = snap["assignment"].shape[0]
    n = max(int(P * fraction), 1)
    idx = rng.choice(P, n, replace=False)
    out = dict(snap)
    for field in ("leader_load", "follower_load"):
        a = np.asarray(snap[field], np.float32).copy()
        a[:, idx] *= rng.uniform(0.5, 1.5, size=(1, n)).astype(np.float32)
        out[field] = a
    return out
