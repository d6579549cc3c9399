"""PrometheusMetricSampler — scrape a Prometheus server for raw metrics.

Parity: ``monitor/sampling/prometheus/PrometheusMetricSampler.java``
(SURVEY.md C10): an alternative ``metric.sampler.class`` for clusters whose
brokers expose metrics through Prometheus instead of the metrics-reporter
topic. Queries the ``query_range`` HTTP API for a configurable mapping of
PromQL expressions to partition/broker metrics; stdlib urllib only.

Config keys (prefix ``prometheus.server.``): the endpoint URL plus optional
query overrides; default queries follow kafka_exporter/jmx-exporter naming.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

import numpy as np

from ccx_torch.common.metadata import ClusterMetadata, TopicPartition
from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF
from ccx_torch.monitor.model_utils import CpuEstimationParams, estimate_leader_cpu
from ccx_torch.monitor.sampling.holders import (
    BrokerMetricSample,
    PartitionMetricSample,
    metric_vector,
)
from ccx_torch.monitor.sampling.sampler import MetricSampler, Samples

#: PromQL per partition metric (labels: topic, partition, instance->broker)
DEFAULT_PARTITION_QUERIES = {
    "NETWORK_IN_RATE": "rate(kafka_server_brokertopicmetrics_bytesin_total[1m])/1024",
    "NETWORK_OUT_RATE": "rate(kafka_server_brokertopicmetrics_bytesout_total[1m])/1024",
    "DISK_USAGE": "kafka_log_log_size/1048576",
}
DEFAULT_BROKER_QUERIES = {
    "ALL_TOPIC_BYTES_IN": "sum by (instance) (rate(kafka_server_brokertopicmetrics_bytesin_total[1m]))/1024",
    "ALL_TOPIC_BYTES_OUT": "sum by (instance) (rate(kafka_server_brokertopicmetrics_bytesout_total[1m]))/1024",
    "BROKER_CPU_UTIL": "1 - avg by (instance) (rate(node_cpu_seconds_total{mode='idle'}[1m]))",
    "BROKER_LOG_FLUSH_TIME_MS_MEAN": "kafka_log_logflushstats_logflushtime_ms{quantile='0.50'}",
}


class PrometheusMetricSampler(MetricSampler):
    def __init__(self, endpoint: str = "http://127.0.0.1:9090",
                 broker_label: str = "instance", config=None) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.broker_label = broker_label
        self.partition_queries = dict(DEFAULT_PARTITION_QUERIES)
        self.broker_queries = dict(DEFAULT_BROKER_QUERIES)
        self.cpu_params = CpuEstimationParams()
        self.step_s = 60

    def configure(self, config) -> None:
        ep = config.get("prometheus.server.endpoint")
        if ep:
            self.endpoint = str(ep).rstrip("/")
        self.cpu_params = CpuEstimationParams.from_config(config)

    # ----- HTTP -------------------------------------------------------------

    def _query_range(self, query: str, start_ms: int, end_ms: int) -> list[dict]:
        params = urllib.parse.urlencode({
            "query": query,
            "start": start_ms / 1000.0,
            "end": max(end_ms - 1, start_ms) / 1000.0,
            "step": self.step_s,
        })
        url = f"{self.endpoint}/api/v1/query_range?{params}"
        with urllib.request.urlopen(url, timeout=30) as resp:
            doc = json.load(resp)
        if doc.get("status") != "success":
            raise RuntimeError(f"prometheus query failed: {doc}")
        return doc["data"]["result"]

    def _broker_id(self, labels: dict) -> int | None:
        raw = labels.get(self.broker_label, "")
        digits = "".join(c for c in raw.split(":")[0] if c.isdigit())
        try:
            return int(labels.get("broker_id", digits))
        except ValueError:
            return None

    # ----- sampling ---------------------------------------------------------

    def get_samples(self, metadata: ClusterMetadata,
                    assigned_partitions: list[int],
                    start_ms: int, end_ms: int) -> Samples:
        pidx = metadata.partition_index()
        assigned = set(assigned_partitions)
        leader_of = {p.tp: p.leader for p in metadata.partitions}

        # (dense partition, t) -> {metric name: value}
        part_rows: dict[tuple[int, int], dict[str, float]] = {}
        for name, q in self.partition_queries.items():
            for series in self._query_range(q, start_ms, end_ms):
                labels = series.get("metric", {})
                tp = TopicPartition(
                    labels.get("topic", ""), int(labels.get("partition", -1))
                )
                dense = pidx.get(tp)
                if dense is None or dense not in assigned:
                    continue
                for ts, value in series.get("values", ()):
                    t = int(float(ts) * 1000)
                    part_rows.setdefault((dense, t), {})[name] = float(value)

        broker_rows: dict[tuple[int, int], dict[str, float]] = {}
        for name, q in self.broker_queries.items():
            for series in self._query_range(q, start_ms, end_ms):
                broker = self._broker_id(series.get("metric", {}))
                if broker is None:
                    continue
                for ts, value in series.get("values", ()):
                    t = int(float(ts) * 1000)
                    broker_rows.setdefault((broker, t), {})[name] = float(value)

        psamples = []
        for (dense, t), row in part_rows.items():
            leader = leader_of.get(metadata.partitions[dense].tp, -1)
            if leader < 0:
                continue
            brow = broker_rows.get((leader, t), {})
            cpu = float(estimate_leader_cpu(
                self.cpu_params,
                np.array(brow.get("BROKER_CPU_UTIL", 0.0) * 100.0),
                np.array(row.get("NETWORK_IN_RATE", 0.0)),
                np.array(row.get("NETWORK_OUT_RATE", 0.0)),
                np.array(brow.get("ALL_TOPIC_BYTES_IN", 0.0)),
                np.array(brow.get("ALL_TOPIC_BYTES_OUT", 0.0)),
            ))
            psamples.append(PartitionMetricSample(
                leader, dense, t,
                (cpu, row.get("NETWORK_IN_RATE", 0.0),
                 row.get("NETWORK_OUT_RATE", 0.0),
                 row.get("DISK_USAGE", 0.0)),
            ))

        known = {m.name for m in BROKER_METRIC_DEF.all_metrics()}
        bsamples = []
        # BROKER_CPU_UTIL passes through as the 0-1 ratio the queries yield
        # (same convention as reporter_sampler).
        for (broker, t), row in broker_rows.items():
            named = {k: v for k, v in row.items() if k in known}
            if named:
                bsamples.append(BrokerMetricSample(
                    broker, t, metric_vector(named, BROKER_METRIC_DEF)
                ))
        return Samples(psamples, bsamples)
