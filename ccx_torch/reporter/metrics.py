"""Raw metric records + serde — the cluster-side data plane vocabulary.

Parity: ``cruise-control-metrics-reporter``'s ``metric/{CruiseControlMetric,
BrokerMetric,TopicMetric,PartitionMetric,RawMetricType}.java`` and
``MetricSerde`` (SURVEY.md C37, M3/L0): every broker runs a reporter that
serializes typed raw metrics onto the ``__CruiseControlMetrics`` transport
each ``metric.reporting.interval.ms``; the monitor-side sampler deserializes
and rolls them into samples. The binary format is little-endian and
versioned, record-per-metric, exactly the shape the reference ships.
"""

from __future__ import annotations

import dataclasses
import enum
import struct


class RawMetricType(enum.IntEnum):
    """Representative subset of the reference's ~50 RawMetricTypes, keeping
    the broker/topic/partition scope split (ids are stable wire values)."""

    # broker scope
    ALL_TOPIC_BYTES_IN = 0
    ALL_TOPIC_BYTES_OUT = 1
    ALL_TOPIC_REPLICATION_BYTES_IN = 2
    ALL_TOPIC_REPLICATION_BYTES_OUT = 3
    ALL_TOPIC_MESSAGES_IN_PER_SEC = 4
    ALL_TOPIC_PRODUCE_REQUEST_RATE = 5
    ALL_TOPIC_FETCH_REQUEST_RATE = 6
    BROKER_CPU_UTIL = 7
    BROKER_PRODUCE_LOCAL_TIME_MS_MEAN = 8
    BROKER_PRODUCE_LOCAL_TIME_MS_MAX = 9
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN = 10
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN = 11
    BROKER_LOG_FLUSH_TIME_MS_MEAN = 12
    BROKER_LOG_FLUSH_TIME_MS_MAX = 13
    BROKER_LOG_FLUSH_RATE = 14
    BROKER_REQUEST_QUEUE_SIZE = 15
    BROKER_RESPONSE_QUEUE_SIZE = 16
    UNDER_REPLICATED_PARTITIONS = 17
    OFFLINE_LOG_DIRS = 18
    # topic scope
    TOPIC_BYTES_IN = 30
    TOPIC_BYTES_OUT = 31
    TOPIC_REPLICATION_BYTES_IN = 32
    TOPIC_MESSAGES_IN_PER_SEC = 33
    # partition scope
    PARTITION_SIZE = 40
    PARTITION_BYTES_IN = 41
    PARTITION_BYTES_OUT = 42
    PARTITION_MESSAGES_IN = 43

    @property
    def scope(self) -> str:
        if self < 30:
            return "BROKER"
        if self < 40:
            return "TOPIC"
        return "PARTITION"


@dataclasses.dataclass(frozen=True)
class CruiseControlMetric:
    """One raw observation (ref CruiseControlMetric + subclasses: topic and
    partition are empty/-1 outside their scope)."""

    metric_type: RawMetricType
    time_ms: int
    broker_id: int
    value: float
    topic: str = ""
    partition: int = -1

    @property
    def scope(self) -> str:
        return self.metric_type.scope


_MAGIC = b"CXM"
_VERSION = 1
_HEAD = "<3sBHqqdi H"  # magic, ver, type, time, broker, value, partition, topic-len


def serialize_metric(m: CruiseControlMetric) -> bytes:
    topic_b = m.topic.encode()
    head = struct.pack(
        _HEAD, _MAGIC, _VERSION, int(m.metric_type), m.time_ms, m.broker_id,
        m.value, m.partition, len(topic_b),
    )
    return head + topic_b


def deserialize_metric(buf: bytes) -> CruiseControlMetric:
    magic, version, mtype, t, broker, value, partition, tlen = struct.unpack_from(
        _HEAD, buf
    )
    if magic != _MAGIC:
        raise ValueError(f"bad metric magic {magic!r}")
    if version > _VERSION:
        raise ValueError(f"unsupported metric version {version}")
    off = struct.calcsize(_HEAD)
    topic = buf[off:off + tlen].decode()
    return CruiseControlMetric(
        RawMetricType(mtype), t, broker, value, topic, partition
    )


def serialize_batch(metrics) -> bytes:
    out = bytearray()
    for m in metrics:
        b = serialize_metric(m)
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


def deserialize_batch(buf: bytes) -> list[CruiseControlMetric]:
    out = []
    off = 0
    while off < len(buf):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out.append(deserialize_metric(buf[off:off + n]))
        off += n
    return out
