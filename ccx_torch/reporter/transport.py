"""Metrics transport — the ``__CruiseControlMetrics`` channel.

Parity: in the reference the reporter *produces to a Kafka topic* and the
sampler *consumes* it (SURVEY.md C37/C10, call stack 3.4). The transport SPI
abstracts that channel: an in-memory ring (same-process deployments, tests,
benchmarks) and a file-backed log (cross-process, survives restarts) —
both time-indexed so consumers fetch ``[start_ms, end_ms)`` ranges the way
the sampler consumes topic offsets by timestamp.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading

from ccx_torch.reporter.metrics import (
    CruiseControlMetric,
    deserialize_batch,
    serialize_batch,
)

DEFAULT_CHANNEL = "__CruiseControlMetrics"


class MetricsTransport:
    """SPI: append a batch; read a time range."""

    def produce(self, metrics: list[CruiseControlMetric]) -> None:
        raise NotImplementedError

    def consume(self, start_ms: int, end_ms: int) -> list[CruiseControlMetric]:
        raise NotImplementedError

    def evict_before(self, time_ms: int) -> None:
        pass


class InMemoryTransport(MetricsTransport):
    """Named in-process channels (the embedded-cluster topic analogue).

    ``InMemoryTransport.channel(name)`` returns the process-wide instance so
    a reporter and a sampler wired independently from config meet on the
    same channel, like producer and consumer meeting on a topic name.
    """

    _registry: dict[str, "InMemoryTransport"] = {}
    _registry_lock = threading.Lock()

    def __init__(self) -> None:
        self._times: list[int] = []   # sorted append times
        self._records: list[CruiseControlMetric] = []
        self._lock = threading.Lock()

    @classmethod
    def channel(cls, name: str = DEFAULT_CHANNEL) -> "InMemoryTransport":
        with cls._registry_lock:
            if name not in cls._registry:
                cls._registry[name] = cls()
            return cls._registry[name]

    @classmethod
    def reset(cls, name: str | None = None) -> None:
        with cls._registry_lock:
            if name is None:
                cls._registry.clear()
            else:
                cls._registry.pop(name, None)

    def produce(self, metrics) -> None:
        with self._lock:
            for m in sorted(metrics, key=lambda m: m.time_ms):
                idx = bisect.bisect_right(self._times, m.time_ms)
                self._times.insert(idx, m.time_ms)
                self._records.insert(idx, m)

    def consume(self, start_ms, end_ms) -> list[CruiseControlMetric]:
        with self._lock:
            lo = bisect.bisect_left(self._times, start_ms)
            hi = bisect.bisect_left(self._times, end_ms)
            return list(self._records[lo:hi])

    def evict_before(self, time_ms) -> None:
        with self._lock:
            lo = bisect.bisect_left(self._times, time_ms)
            del self._times[:lo]
            del self._records[:lo]


class FileTransport(MetricsTransport):
    """Append-only metric log under a directory (cross-process channel)."""

    def __init__(self, dir: str, name: str = DEFAULT_CHANNEL) -> None:
        self.dir = dir
        self.path = os.path.join(dir, f"{name}.log")
        self._lock = threading.Lock()
        os.makedirs(dir, exist_ok=True)

    def produce(self, metrics) -> None:
        with self._lock, open(self.path, "ab") as f:
            f.write(serialize_batch(metrics))

    def _read_all(self) -> list[CruiseControlMetric]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            return deserialize_batch(f.read())

    def consume(self, start_ms, end_ms) -> list[CruiseControlMetric]:
        with self._lock:
            return [
                m for m in self._read_all() if start_ms <= m.time_ms < end_ms
            ]

    def evict_before(self, time_ms) -> None:
        with self._lock:
            keep = [m for m in self._read_all() if m.time_ms >= time_ms]
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(serialize_batch(keep))
            os.replace(tmp, self.path)
