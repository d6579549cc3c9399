"""AdminApi SPI + the in-process simulated cluster.

Parity: the reference's only write path to the managed cluster is the Kafka
AdminClient plumbing in ``executor/Executor.java`` / ``KafkaCruiseControlUtils``
— ``alterPartitionReassignments``, ``electLeaders``, ``alterReplicaLogDirs``,
``describeLogDirs``, ``incrementalAlterConfigs`` + metadata reads (SURVEY.md
C28). ``AdminApi`` is that surface as an SPI; ``SimulatedAdminClient`` backs
it with an in-process cluster that replicates data over (simulated) time —
the role ``CCEmbeddedBroker``/``CCEmbeddedZookeeper`` play in the reference's
integration tests (SURVEY.md §4): multi-broker behavior with no real cluster.

The simulation is deliberately mechanical: an in-flight reassignment copies
``partition_size_mb`` at ``replication_rate_mb_s`` (capped by the throttle)
per adding replica; leadership changes are instant; a dead broker stops
serving and its replicas become offline. That is enough to exercise every
executor state (in-progress/pending/dead tasks, URP handling, progress
polling, concurrency adjustment) the way the reference's tests do.
"""

from __future__ import annotations

import dataclasses
import threading

from ccx_torch.common.metadata import (
    BrokerInfo,
    ClusterMetadata,
    PartitionInfo,
    TopicPartition,
)

THROTTLE_CONFIG = "leader.replication.throttled.rate"


class AdminApi:
    """SPI (ref C28) — everything the framework reads/writes on the cluster."""

    def describe_cluster(self) -> ClusterMetadata:
        raise NotImplementedError

    def alter_partition_reassignments(
        self, reassignments: dict[TopicPartition, tuple[int, ...]]
    ) -> None:
        raise NotImplementedError

    def list_partition_reassignments(self) -> dict[TopicPartition, tuple[int, ...]]:
        """In-flight reassignments: tp -> target replica list."""
        raise NotImplementedError

    def elect_leaders(self, partitions: list[TopicPartition] | None = None) -> None:
        """Preferred leader election (ref electLeaders)."""
        raise NotImplementedError

    def alter_replica_log_dirs(
        self, moves: dict[tuple[TopicPartition, int], int]
    ) -> None:
        """(tp, broker) -> target disk (ref alterReplicaLogDirs)."""
        raise NotImplementedError

    def describe_log_dirs(self) -> dict[int, dict[int, bool]]:
        """broker -> {disk: online} (ref describeLogDirs)."""
        raise NotImplementedError

    def incremental_alter_configs(self, broker_configs: dict[int, dict[str, str]]) -> None:
        raise NotImplementedError

    def describe_configs(self, broker_ids: list[int]) -> dict[int, dict[str, str]]:
        raise NotImplementedError

    def create_topic(self, topic: str, partitions: int, rf: int) -> None:
        raise NotImplementedError


@dataclasses.dataclass
class _SimPartition:
    replicas: list[int]
    leader: int
    dirs: list[int]
    size_mb: float = 100.0
    # in-flight reassignment
    target: list[int] | None = None
    target_dirs: list[int] | None = None
    copied_mb: dict[int, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _SimBroker:
    broker_id: int
    rack: str
    alive: bool = True
    num_disks: int = 1
    offline_disks: set[int] = dataclasses.field(default_factory=set)
    configs: dict[str, str] = dataclasses.field(default_factory=dict)
    host: str = ""  # hostname; brokers sharing it share a physical host


class SimulatedCluster:
    """In-process cluster with time-driven replica movement."""

    def __init__(self, replication_rate_mb_s: float = 1000.0) -> None:
        self.replication_rate_mb_s = replication_rate_mb_s
        self._brokers: dict[int, _SimBroker] = {}
        self._partitions: dict[TopicPartition, _SimPartition] = {}
        self._generation = 0
        self._lock = threading.RLock()
        self.time_ms = 0

    # ----- topology setup ---------------------------------------------------

    def add_broker(self, broker_id: int, rack: str, num_disks: int = 1,
                   host: str = "") -> None:
        with self._lock:
            self._brokers[broker_id] = _SimBroker(
                broker_id, rack, num_disks=num_disks, host=host
            )
            self._generation += 1

    def create_topic(self, topic: str, partitions: int, rf: int,
                     size_mb: float = 100.0) -> None:
        with self._lock:
            alive = sorted(b for b, info in self._brokers.items() if info.alive)
            for p in range(partitions):
                replicas = [alive[(p + i) % len(alive)] for i in range(rf)]
                self._partitions[TopicPartition(topic, p)] = _SimPartition(
                    replicas=replicas, leader=replicas[0],
                    dirs=[0] * rf, size_mb=size_mb,
                )
            self._generation += 1

    # ----- failure injection (ref RandomSelfHealingTest-style fixtures) -----

    def kill_broker(self, broker_id: int) -> None:
        with self._lock:
            self._brokers[broker_id].alive = False
            for part in self._partitions.values():
                if part.leader == broker_id:
                    live = [b for b in part.replicas
                            if b != broker_id and self._brokers[b].alive]
                    part.leader = live[0] if live else -1
            self._generation += 1

    def restart_broker(self, broker_id: int) -> None:
        with self._lock:
            self._brokers[broker_id].alive = True
            self._generation += 1

    def fail_disk(self, broker_id: int, disk: int) -> None:
        with self._lock:
            self._brokers[broker_id].offline_disks.add(disk)
            self._generation += 1

    # ----- time -------------------------------------------------------------

    def tick(self, ms: int) -> None:
        """Advance simulated time; progress in-flight reassignments."""
        with self._lock:
            self.time_ms += ms
            changed = False
            for tp, part in self._partitions.items():
                if part.target is None:
                    continue
                throttle = self._throttle_mb_s()
                rate = min(self.replication_rate_mb_s, throttle)
                adding = [b for b in part.target if b not in part.replicas]
                for b in adding:
                    if not self._brokers[b].alive:
                        continue
                    part.copied_mb[b] = part.copied_mb.get(b, 0.0) + rate * ms / 1000.0
                if all(part.copied_mb.get(b, 0.0) >= part.size_mb for b in adding):
                    if part.target_dirs is not None:
                        new_dirs = list(part.target_dirs)
                    else:
                        # Preserve disk placement of replicas that stayed;
                        # new replicas land on disk 0.
                        old_dir = dict(zip(part.replicas, part.dirs))
                        new_dirs = [old_dir.get(b, 0) for b in part.target]
                    part.replicas = list(part.target)
                    part.dirs = new_dirs
                    if part.leader not in part.replicas:
                        live = [b for b in part.replicas if self._brokers[b].alive]
                        part.leader = live[0] if live else -1
                    part.target = None
                    part.target_dirs = None
                    part.copied_mb.clear()
                    changed = True
            if changed:
                self._generation += 1

    def _throttle_mb_s(self) -> float:
        for b in self._brokers.values():
            v = b.configs.get(THROTTLE_CONFIG)
            if v is not None:
                return float(v) / 1e6  # bytes/s -> MB/s
        return float("inf")

    # ----- introspection for tests -----------------------------------------

    def partition(self, tp: TopicPartition) -> _SimPartition:
        return self._partitions[tp]

    @property
    def generation(self) -> int:
        return self._generation


class SimulatedAdminClient(AdminApi):
    """AdminApi over a SimulatedCluster (default ``admin.client.class``)."""

    def __init__(self, cluster: SimulatedCluster | None = None, config=None) -> None:
        self.cluster = cluster or SimulatedCluster()

    def describe_cluster(self) -> ClusterMetadata:
        c = self.cluster
        with c._lock:
            brokers = tuple(
                BrokerInfo(b.broker_id, b.rack, b.alive, b.num_disks,
                           tuple(sorted(b.offline_disks)), host=b.host)
                for b in sorted(c._brokers.values(), key=lambda b: b.broker_id)
            )
            parts = tuple(
                PartitionInfo(tp, tuple(p.replicas), p.leader, tuple(p.dirs))
                for tp, p in sorted(c._partitions.items())
            )
            return ClusterMetadata(c._generation, brokers, parts)

    def alter_partition_reassignments(self, reassignments) -> None:
        c = self.cluster
        with c._lock:
            for tp, target in reassignments.items():
                part = c._partitions[tp]
                target = list(target)
                if target == part.replicas:
                    part.target = None
                    continue
                part.target = target
                part.copied_mb = {}
            c._generation += 1

    def list_partition_reassignments(self):
        c = self.cluster
        with c._lock:
            return {
                tp: tuple(p.target)
                for tp, p in c._partitions.items()
                if p.target is not None
            }

    def elect_leaders(self, partitions=None) -> None:
        c = self.cluster
        with c._lock:
            tps = partitions if partitions is not None else list(c._partitions)
            for tp in tps:
                part = c._partitions[tp]
                for b in part.replicas:  # preferred order
                    if c._brokers[b].alive:
                        part.leader = b
                        break
            c._generation += 1

    def alter_replica_log_dirs(self, moves) -> None:
        c = self.cluster
        with c._lock:
            for (tp, broker), disk in moves.items():
                part = c._partitions[tp]
                if broker in part.replicas:
                    part.dirs[part.replicas.index(broker)] = disk
            c._generation += 1

    def describe_log_dirs(self):
        c = self.cluster
        with c._lock:
            return {
                b.broker_id: {d: d not in b.offline_disks
                              for d in range(b.num_disks)}
                for b in c._brokers.values()
            }

    def incremental_alter_configs(self, broker_configs) -> None:
        c = self.cluster
        with c._lock:
            for broker_id, cfgs in broker_configs.items():
                for k, v in cfgs.items():
                    if v is None:
                        c._brokers[broker_id].configs.pop(k, None)
                    else:
                        c._brokers[broker_id].configs[k] = str(v)

    def describe_configs(self, broker_ids):
        c = self.cluster
        with c._lock:
            return {b: dict(c._brokers[b].configs) for b in broker_ids}

    def create_topic(self, topic: str, partitions: int, rf: int) -> None:
        self.cluster.create_topic(topic, partitions, rf)
