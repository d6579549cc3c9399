"""Metric sample records + versioned binary serde.

Parity: ``monitor/sampling/holder/{PartitionMetricSample,BrokerMetricSample}
.java`` (SURVEY.md C13) — serializable sample records carried from the
samplers to the aggregators and persisted by the SampleStore — and the
serde role of ``cruise-control-metrics-reporter``'s ``MetricSerde`` for these
holder types. The binary layout is a little-endian versioned header + the
metric vector, so stores stay readable across schema evolution.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF, PARTITION_METRIC_DEF, MetricDef

_MAGIC_PARTITION = b"CXP"
_MAGIC_BROKER = b"CXB"
_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PartitionMetricSample:
    """One sampling interval's loads for one partition (leader-side).

    ``metrics`` is indexed by ``PARTITION_METRIC_DEF`` ids, i.e. the
    ``Resource`` axis order (CPU, NW_IN, NW_OUT, DISK).
    """

    broker_id: int
    partition: int          # dense partition index (topic-partition resolved
                            # by the metadata snapshot, ref ModelGeneration)
    time_ms: int
    metrics: tuple[float, ...]

    def metric(self, metric_id: int) -> float:
        return self.metrics[metric_id]

    def serialize(self) -> bytes:
        head = struct.pack(
            "<3sBqqqH", _MAGIC_PARTITION, _VERSION, self.broker_id,
            self.partition, self.time_ms, len(self.metrics)
        )
        return head + struct.pack(f"<{len(self.metrics)}d", *self.metrics)

    @classmethod
    def deserialize(cls, buf: bytes) -> "PartitionMetricSample":
        magic, version, broker, part, t, n = struct.unpack_from("<3sBqqqH", buf)
        if magic != _MAGIC_PARTITION:
            raise ValueError(f"bad partition-sample magic {magic!r}")
        if version > _VERSION:
            raise ValueError(f"unsupported partition-sample version {version}")
        vals = struct.unpack_from(f"<{n}d", buf, struct.calcsize("<3sBqqqH"))
        return cls(broker, part, t, tuple(vals))


@dataclasses.dataclass(frozen=True)
class BrokerMetricSample:
    """One sampling interval's health metrics for one broker (ref C13)."""

    broker_id: int
    time_ms: int
    metrics: tuple[float, ...]   # indexed by BROKER_METRIC_DEF ids

    def metric(self, metric_id: int) -> float:
        return self.metrics[metric_id]

    def serialize(self) -> bytes:
        head = struct.pack(
            "<3sBqqH", _MAGIC_BROKER, _VERSION, self.broker_id, self.time_ms,
            len(self.metrics)
        )
        return head + struct.pack(f"<{len(self.metrics)}d", *self.metrics)

    @classmethod
    def deserialize(cls, buf: bytes) -> "BrokerMetricSample":
        magic, version, broker, t, n = struct.unpack_from("<3sBqqH", buf)
        if magic != _MAGIC_BROKER:
            raise ValueError(f"bad broker-sample magic {magic!r}")
        if version > _VERSION:
            raise ValueError(f"unsupported broker-sample version {version}")
        vals = struct.unpack_from(f"<{n}d", buf, struct.calcsize("<3sBqqH"))
        return cls(broker, t, tuple(vals))


def metric_vector(values: dict[str, float], metric_def: MetricDef) -> tuple[float, ...]:
    """Build a dense metric tuple from a name->value dict (missing = 0)."""
    out = [0.0] * metric_def.num_metrics
    for name, v in values.items():
        out[metric_def.metric_info(name).id] = float(v)
    return tuple(out)


def partition_sample(broker_id: int, partition: int, time_ms: int,
                     **named: float) -> PartitionMetricSample:
    return PartitionMetricSample(
        broker_id, partition, time_ms, metric_vector(named, PARTITION_METRIC_DEF)
    )


def broker_sample(broker_id: int, time_ms: int, **named: float) -> BrokerMetricSample:
    return BrokerMetricSample(
        broker_id, time_ms, metric_vector(named, BROKER_METRIC_DEF)
    )


def serialize_batch(samples) -> bytes:
    """Length-prefixed concatenation (SampleStore on-disk record format)."""
    out = bytearray()
    for s in samples:
        b = s.serialize()
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


def deserialize_batch(buf: bytes) -> list:
    out = []
    off = 0
    while off < len(buf):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        rec = buf[off:off + n]
        off += n
        if rec[:3] == _MAGIC_PARTITION:
            out.append(PartitionMetricSample.deserialize(rec))
        elif rec[:3] == _MAGIC_BROKER:
            out.append(BrokerMetricSample.deserialize(rec))
        else:
            raise ValueError(f"bad sample magic {rec[:3]!r}")
    return out


def samples_to_arrays(samples: list[PartitionMetricSample]) -> tuple[np.ndarray, ...]:
    """Columnar view (entity_ids, time_ms, metrics[n, M]) for batch ingest."""
    ids = np.fromiter((s.partition for s in samples), np.int64, len(samples))
    times = np.fromiter((s.time_ms for s in samples), np.int64, len(samples))
    metrics = np.asarray([s.metrics for s in samples], np.float64)
    return ids, times, metrics
