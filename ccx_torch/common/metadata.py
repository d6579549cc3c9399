"""Cluster metadata snapshot — the topology side of model generation.

Parity: the reference builds its ``ClusterModel`` from two inputs (SURVEY.md
call stack 3.2): the Kafka **metadata** (topics, partition replica lists,
leaders, rack ids, liveness — via AdminClient/MetadataClient) and the
aggregated **load samples**. This module is the metadata half: an immutable
snapshot type produced by the admin layer (``ccx.executor.admin``) and
consumed by the LoadMonitor, plus the dense partition indexing every tensor
shares (``ModelGeneration`` pins a snapshot to an optimizer run so the JVM↔
sidecar exchange stays consistent, SURVEY.md §5.2).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class TopicPartition:
    topic: str
    partition: int

    def __str__(self) -> str:
        return f"{self.topic}-{self.partition}"


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    tp: TopicPartition
    replicas: tuple[int, ...]      # broker ids, index 0 = preferred leader
    leader: int                    # broker id, -1 = offline
    replica_dirs: tuple[int, ...] = ()   # log-dir (disk) index per replica


@dataclasses.dataclass(frozen=True)
class BrokerInfo:
    broker_id: int
    rack: str
    alive: bool = True
    num_disks: int = 1
    offline_disks: tuple[int, ...] = ()
    #: hostname (ref model/Host.java: rack -> host -> broker; several
    #: brokers may share a host). "" = unknown -> the broker is its own
    #: host. When rack is ALSO unknown, rack-awareness falls back to host
    #: distinctness (upstream ClusterModel.createBroker semantics).
    host: str = ""

    def rack_key(self) -> str:
        """Effective rack grouping key: rack, else host, else broker id."""
        return self.rack or self.host or f"broker-{self.broker_id}"

    def host_key(self) -> str:
        """Effective host grouping key: host, else broker id."""
        return self.host or f"broker-{self.broker_id}"


@dataclasses.dataclass(frozen=True)
class ClusterMetadata:
    """One generation of cluster topology (ref ModelGeneration + Cluster)."""

    generation: int
    brokers: tuple[BrokerInfo, ...]
    partitions: tuple[PartitionInfo, ...]

    # ----- dense indexing ---------------------------------------------------

    def broker_ids(self) -> list[int]:
        return [b.broker_id for b in self.brokers]

    def broker_index(self) -> dict[int, int]:
        """broker id -> dense row (tensor broker axis)."""
        return {b.broker_id: i for i, b in enumerate(self.brokers)}

    def partition_index(self) -> dict[TopicPartition, int]:
        """TopicPartition -> dense row (tensor partition axis), sorted so the
        index is stable for a given topic set (generation-independent for
        unchanged topology)."""
        return {p.tp: i for i, p in enumerate(self.partitions)}

    def topics(self) -> list[str]:
        seen: dict[str, None] = {}
        for p in self.partitions:
            seen.setdefault(p.tp.topic, None)
        return list(seen)

    def topic_index(self) -> dict[str, int]:
        return {t: i for i, t in enumerate(self.topics())}

    def rack_keys(self) -> list[str]:
        """Distinct effective rack keys (rack || host || broker id)."""
        seen: dict[str, None] = {}
        for b in self.brokers:
            seen.setdefault(b.rack_key(), None)
        return list(seen)

    def hosts(self) -> list[str]:
        """Distinct effective host keys."""
        seen: dict[str, None] = {}
        for b in self.brokers:
            seen.setdefault(b.host_key(), None)
        return list(seen)

    def alive_broker_ids(self) -> set[int]:
        return {b.broker_id for b in self.brokers if b.alive}

    def dead_broker_ids(self) -> set[int]:
        return {b.broker_id for b in self.brokers if not b.alive}

    def partitions_of(self, topic: str) -> list[PartitionInfo]:
        return [p for p in self.partitions if p.tp.topic == topic]

    def replica_count(self) -> int:
        return sum(len(p.replicas) for p in self.partitions)

    def under_replicated(self, target_rf: dict[str, int] | None = None) -> list[PartitionInfo]:
        """Partitions whose live replica count is below their RF (URP) —
        consumed by movement strategies and the topic-anomaly finder.
        ``target_rf`` overrides the required count per topic (topic-anomaly
        RF checks)."""
        alive = self.alive_broker_ids()
        target_rf = target_rf or {}
        return [
            p for p in self.partitions
            if sum(1 for b in p.replicas if b in alive)
            < target_rf.get(p.tp.topic, len(p.replicas))
        ]
