"""SampleStore SPI — sample persistence and warm start.

Parity: ``monitor/sampling/KafkaSampleStore.java`` / ``NoopSampleStore``
(SURVEY.md C11, §5.4): every sample batch is persisted, and on startup
``load_samples`` replays them into the aggregators so the monitor's windows
survive a restart — this is the framework's checkpoint/resume mechanism (the
service itself stays stateless). The default store is file-backed
(segmented append-only logs, the two-topics analogue), with retention by
window span.
"""

from __future__ import annotations

import os
import threading

from ccx_torch.monitor.sampling.holders import (
    BrokerMetricSample,
    PartitionMetricSample,
    deserialize_batch,
    serialize_batch,
)
from ccx_torch.monitor.sampling.sampler import Samples


class SampleStore:
    """SPI (ref C11)."""

    def configure(self, config) -> None:
        pass

    def store_samples(self, samples: Samples) -> None:
        raise NotImplementedError

    def load_samples(self) -> Samples:
        """Replay persisted samples (called once at LoadMonitor startup)."""
        raise NotImplementedError

    def evict_before(self, partition_before_ms: int,
                     broker_before_ms: int | None = None) -> None:
        """Drop expired samples; broker scope may retain a different span."""

    def close(self) -> None:
        pass


class NoopSampleStore(SampleStore):
    def __init__(self, config=None) -> None:
        pass

    def store_samples(self, samples: Samples) -> None:
        pass

    def load_samples(self) -> Samples:
        return Samples([], [])


class FileSampleStore(SampleStore):
    """Append-only segmented files, one per sample scope.

    ``partition-samples.log`` / ``broker-samples.log`` under ``dir``, records
    length-prefixed (holders.serialize_batch framing). ``evict_before``
    rewrites segments dropping expired records — cheap at the monitor's
    sample volumes, and keeps the store a plain directory an operator can
    delete to cold-start (ref: topic retention on the sample-store topics).
    """

    PARTITION_LOG = "partition-samples.log"
    BROKER_LOG = "broker-samples.log"

    def __init__(self, dir: str | None = None, config=None) -> None:
        if dir is None and config is not None:
            dir = config["sample.store.dir"]
        self.dir = dir or "/tmp/ccx-samples"
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)

    def configure(self, config) -> None:
        self.dir = config["sample.store.dir"]
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def store_samples(self, samples: Samples) -> None:
        with self._lock:
            if samples.partition_samples:
                with open(self._path(self.PARTITION_LOG), "ab") as f:
                    f.write(serialize_batch(samples.partition_samples))
            if samples.broker_samples:
                with open(self._path(self.BROKER_LOG), "ab") as f:
                    f.write(serialize_batch(samples.broker_samples))

    def _read(self, name: str) -> list:
        path = self._path(name)
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            return deserialize_batch(f.read())

    def load_samples(self) -> Samples:
        with self._lock:
            return Samples(
                [s for s in self._read(self.PARTITION_LOG)
                 if isinstance(s, PartitionMetricSample)],
                [s for s in self._read(self.BROKER_LOG)
                 if isinstance(s, BrokerMetricSample)],
            )

    def load_broker_samples(self) -> list[BrokerMetricSample]:
        with self._lock:
            return [s for s in self._read(self.BROKER_LOG)
                    if isinstance(s, BrokerMetricSample)]

    def raw_partition_log(self) -> bytes:
        """Raw log bytes for the native columnar decoder (warm-start fast
        path; see ccx.native.decode_partition_samples)."""
        with self._lock:
            path = self._path(self.PARTITION_LOG)
            if not os.path.exists(path):
                return b""
            with open(path, "rb") as f:
                return f.read()

    def evict_before(self, partition_before_ms: int,
                     broker_before_ms: int | None = None) -> None:
        if broker_before_ms is None:
            broker_before_ms = partition_before_ms
        with self._lock:
            for name, cutoff in (
                (self.PARTITION_LOG, partition_before_ms),
                (self.BROKER_LOG, broker_before_ms),
            ):
                path = self._path(name)
                if not os.path.exists(path):
                    continue
                recs = [s for s in self._read(name) if s.time_ms >= cutoff]
                # Atomic rewrite: a crash mid-eviction must not destroy the
                # warm-start checkpoint (write-temp + rename).
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(serialize_batch(recs))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
