"""MetricSampler SPI — pluggable raw-metric sources.

Parity: ``monitor/sampling/MetricSampler.java`` (SURVEY.md C10). A sampler
turns an external metric source into ``PartitionMetricSample`` /
``BrokerMetricSample`` batches for its assigned partitions over a time range.
The default implementation consumes the metrics-reporter transport
(``ccx.reporter``, the ``__CruiseControlMetrics`` analogue); a synthetic
sampler serves tests and benchmarks the way the reference's unit fixtures do.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ccx_torch.common.metadata import ClusterMetadata
from ccx_torch.monitor.sampling.holders import BrokerMetricSample, PartitionMetricSample


@dataclasses.dataclass
class Samples:
    partition_samples: list[PartitionMetricSample]
    broker_samples: list[BrokerMetricSample]


class MetricSampler:
    """SPI (ref C10). ``assigned_partitions`` are dense partition indices of
    the given metadata generation; implementations must only return samples
    for those (fetcher threads shard the partition space)."""

    def configure(self, config) -> None:  # optional
        pass

    def get_samples(self, metadata: ClusterMetadata,
                    assigned_partitions: list[int],
                    start_ms: int, end_ms: int) -> Samples:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyntheticMetricSampler(MetricSampler):
    """Deterministic load generator (test/bench double for C10).

    Each partition gets a stable pseudo-random base load from its index; a
    sinusoidal time component exercises windowing. Broker health metrics are
    derived from hosted leader load so SlowBrokerFinder fixtures can perturb
    individual brokers via ``broker_latency_overrides``.
    """

    def __init__(self, seed: int = 7, interval_ms: int = 1000, config=None) -> None:
        self.seed = seed
        self.interval_ms = interval_ms
        self.broker_latency_overrides: dict[int, float] = {}

    def configure(self, config) -> None:
        self.interval_ms = min(self.interval_ms, config["metric.sampling.interval.ms"])

    def _base_loads(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        base = rng.random((n, 4))
        base[:, 0] = 1.0 + 4.0 * base[:, 0]      # CPU %
        base[:, 1] = 50.0 + 400.0 * base[:, 1]   # NW_IN KB/s
        base[:, 2] = 80.0 + 600.0 * base[:, 2]   # NW_OUT KB/s
        base[:, 3] = 100.0 + 900.0 * base[:, 3]  # DISK MB
        return base

    def get_samples(self, metadata: ClusterMetadata,
                    assigned_partitions: list[int],
                    start_ms: int, end_ms: int) -> Samples:
        base = self._base_loads(len(metadata.partitions))
        psamples: list[PartitionMetricSample] = []
        times = np.arange(start_ms, end_ms, self.interval_ms)
        for p in assigned_partitions:
            info = metadata.partitions[p]
            if info.leader < 0:
                continue
            for t in times:
                wobble = 1.0 + 0.1 * np.sin(2 * np.pi * (t % 3_600_000) / 3_600_000)
                m = base[p] * wobble
                psamples.append(
                    PartitionMetricSample(info.leader, p, int(t), tuple(m))
                )
        # broker samples: aggregate leader load onto brokers
        bsamples: list[BrokerMetricSample] = []
        bidx = metadata.broker_index()
        leader_in = np.zeros(len(metadata.brokers))
        leader_out = np.zeros(len(metadata.brokers))
        cpu = np.zeros(len(metadata.brokers))
        for p, info in enumerate(metadata.partitions):
            if info.leader >= 0 and info.leader in bidx:
                leader_in[bidx[info.leader]] += base[p, 1]
                leader_out[bidx[info.leader]] += base[p, 2]
                cpu[bidx[info.leader]] += base[p, 0]
        from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF
        from ccx_torch.monitor.sampling.holders import metric_vector

        for b in metadata.brokers:
            if not b.alive:
                continue
            i = bidx[b.broker_id]
            flush = self.broker_latency_overrides.get(b.broker_id, 5.0)
            for t in times:
                vec = metric_vector(
                    {
                        "ALL_TOPIC_BYTES_IN": leader_in[i],
                        "ALL_TOPIC_BYTES_OUT": leader_out[i],
                        "BROKER_CPU_UTIL": min(cpu[i] / 100.0, 1.0),
                        "BROKER_LOG_FLUSH_TIME_MS_MEAN": flush,
                        "BROKER_LOG_FLUSH_TIME_MS_MAX": 2.0 * flush,
                        "UNDER_REPLICATED_PARTITIONS": 0.0,
                        "OFFLINE_LOG_DIRS": float(len(b.offline_disks)),
                    },
                    BROKER_METRIC_DEF,
                )
                bsamples.append(BrokerMetricSample(b.broker_id, int(t), vec))
        return Samples(psamples, bsamples)
