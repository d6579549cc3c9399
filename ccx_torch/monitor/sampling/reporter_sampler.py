"""ReporterMetricSampler — the default sampler, fed by the metrics reporter.

Parity: ``monitor/sampling/CruiseControlMetricsReporterSampler.java``
(SURVEY.md C10, call stack 3.4): consumes the raw-metric channel the
in-broker reporters produce to, groups records by partition/broker and time,
derives ``PartitionMetricSample``s — estimating per-partition leader CPU
from the broker's CPU by weighted network share, exactly the
``ModelUtils``/``ModelParameters`` role (C6) — and ``BrokerMetricSample``s
from the broker-scope rows.
"""

from __future__ import annotations

import collections

from ccx_torch.common.metadata import ClusterMetadata
from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF
from ccx_torch.monitor.model_utils import CpuEstimationParams
from ccx_torch.monitor.sampling.holders import (
    BrokerMetricSample,
    PartitionMetricSample,
    metric_vector,
)
from ccx_torch.monitor.sampling.sampler import MetricSampler, Samples
from ccx_torch.reporter.metrics import RawMetricType
from ccx_torch.reporter.transport import DEFAULT_CHANNEL, InMemoryTransport


class ReporterMetricSampler(MetricSampler):
    """Default ``metric.sampler.class`` (ref C10)."""

    def __init__(self, transport=None, config=None) -> None:
        self.transport = transport
        self.cpu_params = CpuEstimationParams()
        self.channel = DEFAULT_CHANNEL
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        self.channel = config["cruise.control.metrics.topic"]
        self.cpu_params = CpuEstimationParams.from_config(config)
        if self.transport is None:
            self.transport = InMemoryTransport.channel(self.channel)

    def get_samples(self, metadata: ClusterMetadata,
                    assigned_partitions: list[int],
                    start_ms: int, end_ms: int) -> Samples:
        if self.transport is None:
            self.transport = InMemoryTransport.channel(self.channel)
        records = self.transport.consume(start_ms, end_ms)
        # Retention: records older than one full sampling interval before
        # this round's start will never be consumed again (fetcher shards of
        # the current round all read >= start_ms) — evict so the channel
        # does not grow for the life of the process.
        self.transport.evict_before(start_ms - max(end_ms - start_ms, 1))
        pidx = metadata.partition_index()
        leader_of = {
            (p.tp.topic, p.tp.partition): p.leader for p in metadata.partitions
        }
        assigned = set(assigned_partitions)

        # ---- broker-scope rows: (broker, time) -> {metric name: value} ----
        broker_rows: dict[tuple[int, int], dict[str, float]] = (
            collections.defaultdict(dict)
        )
        # ---- partition-scope rows: (tp, time) -> {type: (broker, value)} --
        part_rows: dict[tuple, dict[RawMetricType, tuple[int, float]]] = (
            collections.defaultdict(dict)
        )
        for m in records:
            if m.scope == "BROKER":
                broker_rows[(m.broker_id, m.time_ms)][m.metric_type.name] = m.value
            elif m.scope == "PARTITION":
                key = ((m.topic, m.partition), m.time_ms)
                prev = part_rows[key].get(m.metric_type)
                # leader-reported rows win over follower-reported sizes
                if (
                    prev is None
                    or m.metric_type is not RawMetricType.PARTITION_SIZE
                    or prev[0] != leader_of.get((m.topic, m.partition), -1)
                ):
                    part_rows[key][m.metric_type] = (m.broker_id, m.value)

        psamples: list[PartitionMetricSample] = []
        for ((topic, partition), t), row in part_rows.items():
            from ccx_torch.common.metadata import TopicPartition

            dense = pidx.get(TopicPartition(topic, partition))
            if dense is None or dense not in assigned:
                continue
            nw_in = row.get(RawMetricType.PARTITION_BYTES_IN, (0, 0.0))[1]
            nw_out = row.get(RawMetricType.PARTITION_BYTES_OUT, (0, 0.0))[1]
            size = row.get(RawMetricType.PARTITION_SIZE, (0, 0.0))[1]
            leader = leader_of.get((topic, partition), -1)
            if leader < 0:
                continue
            brow = broker_rows.get((leader, t), {})
            broker_cpu = brow.get("BROKER_CPU_UTIL", 0.0) * 100.0
            broker_in = brow.get("ALL_TOPIC_BYTES_IN", 0.0)
            broker_out = brow.get("ALL_TOPIC_BYTES_OUT", 0.0)
            from ccx_torch.monitor.model_utils import estimate_leader_cpu
            import numpy as np

            cpu = float(
                estimate_leader_cpu(
                    self.cpu_params, np.array(broker_cpu), np.array(nw_in),
                    np.array(nw_out), np.array(broker_in), np.array(broker_out),
                )
            )
            psamples.append(
                PartitionMetricSample(
                    leader, dense, t, (cpu, nw_in, nw_out, size)
                )
            )

        bsamples: list[BrokerMetricSample] = []
        known_names = {m.name for m in BROKER_METRIC_DEF.all_metrics()}
        for (broker, t), row in broker_rows.items():
            named = {k: v for k, v in row.items() if k in known_names}
            if named:
                bsamples.append(
                    BrokerMetricSample(
                        broker, t, metric_vector(named, BROKER_METRIC_DEF)
                    )
                )
        return Samples(psamples, bsamples)
