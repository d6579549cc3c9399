"""Metric definitions — canonical metric ids + aggregation functions.

Parity: ``cruise-control-core/.../metricdef/{MetricDef,MetricInfo,
AggregationFunction}.java`` and ``monitor/metricdefinition/KafkaMetricDef.java``
(SURVEY.md C12, M1). A ``MetricDef`` is an ordered registry: each metric has a
dense integer id (tensor column), an aggregation function applied when many
raw samples land in one window, and a group (used by CPU estimation and the
anomaly finders).

Two scopes exist, as in the reference: the **partition** def (the per-replica
loads the ClusterModel is built from — one per ``Resource``) and the
**broker** def (health metrics consumed by SlowBrokerFinder and the
concurrency adjuster).
"""

from __future__ import annotations

import dataclasses
import enum

from ccx_torch.common.resources import Resource


class AggregationFunction(enum.Enum):
    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    name: str
    id: int
    aggregation: AggregationFunction
    group: str = ""


class MetricDef:
    """Ordered metric registry with dense ids (ref MetricDef.define())."""

    def __init__(self) -> None:
        self._by_name: dict[str, MetricInfo] = {}
        self._by_id: list[MetricInfo] = []

    def define(self, name: str, aggregation: AggregationFunction,
               group: str = "") -> "MetricDef":
        if name in self._by_name:
            raise ValueError(f"metric {name} defined twice")
        info = MetricInfo(name, len(self._by_id), aggregation, group)
        self._by_name[name] = info
        self._by_id.append(info)
        return self

    def metric_info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def info_for_id(self, metric_id: int) -> MetricInfo:
        return self._by_id[metric_id]

    @property
    def num_metrics(self) -> int:
        return len(self._by_id)

    def all_metrics(self) -> tuple[MetricInfo, ...]:
        return tuple(self._by_id)

    def ids_in_group(self, group: str) -> tuple[int, ...]:
        return tuple(m.id for m in self._by_id if m.group == group)


def partition_metric_def() -> MetricDef:
    """The four resource loads of a partition (ref KafkaMetricDef common
    metric defs; the ClusterModel's ``Load`` columns, SURVEY.md C3).

    Column order matches ``ccx.common.resources.Resource`` so aggregated
    arrays feed ``build_model`` without reindexing.
    """
    d = MetricDef()
    d.define("CPU_USAGE", AggregationFunction.AVG, group="CPU")
    d.define("NETWORK_IN_RATE", AggregationFunction.AVG, group="NETWORK")
    d.define("NETWORK_OUT_RATE", AggregationFunction.AVG, group="NETWORK")
    d.define("DISK_USAGE", AggregationFunction.LATEST, group="DISK")
    assert [m.id for m in d.all_metrics()] == [
        Resource.CPU, Resource.NW_IN, Resource.NW_OUT, Resource.DISK
    ]
    return d


def broker_metric_def() -> MetricDef:
    """Broker health metrics (ref KafkaMetricDef broker defs / RawMetricType
    broker subset, SURVEY.md C12/C37) — the inputs to SlowBrokerFinder and
    ExecutionConcurrencyManager."""
    d = MetricDef()
    d.define("ALL_TOPIC_BYTES_IN", AggregationFunction.AVG, group="NETWORK")
    d.define("ALL_TOPIC_BYTES_OUT", AggregationFunction.AVG, group="NETWORK")
    d.define("ALL_TOPIC_REPLICATION_BYTES_IN", AggregationFunction.AVG, group="NETWORK")
    d.define("ALL_TOPIC_REPLICATION_BYTES_OUT", AggregationFunction.AVG, group="NETWORK")
    d.define("ALL_TOPIC_MESSAGES_IN_PER_SEC", AggregationFunction.AVG, group="NETWORK")
    d.define("ALL_TOPIC_PRODUCE_REQUEST_RATE", AggregationFunction.AVG, group="REQUEST")
    d.define("ALL_TOPIC_FETCH_REQUEST_RATE", AggregationFunction.AVG, group="REQUEST")
    d.define("BROKER_CPU_UTIL", AggregationFunction.AVG, group="CPU")
    d.define("BROKER_DISK_UTIL", AggregationFunction.LATEST, group="DISK")
    d.define("BROKER_PRODUCE_LOCAL_TIME_MS_MEAN", AggregationFunction.AVG, group="LATENCY")
    d.define("BROKER_PRODUCE_LOCAL_TIME_MS_MAX", AggregationFunction.MAX, group="LATENCY")
    d.define("BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN", AggregationFunction.AVG, group="LATENCY")
    d.define("BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN", AggregationFunction.AVG, group="LATENCY")
    d.define("BROKER_LOG_FLUSH_TIME_MS_MEAN", AggregationFunction.AVG, group="LATENCY")
    d.define("BROKER_LOG_FLUSH_TIME_MS_MAX", AggregationFunction.MAX, group="LATENCY")
    d.define("BROKER_LOG_FLUSH_RATE", AggregationFunction.AVG, group="REQUEST")
    d.define("BROKER_REQUEST_QUEUE_SIZE", AggregationFunction.MAX, group="QUEUE")
    d.define("BROKER_RESPONSE_QUEUE_SIZE", AggregationFunction.MAX, group="QUEUE")
    d.define("UNDER_REPLICATED_PARTITIONS", AggregationFunction.LATEST, group="HEALTH")
    d.define("OFFLINE_LOG_DIRS", AggregationFunction.LATEST, group="HEALTH")
    return d


PARTITION_METRIC_DEF = partition_metric_def()
BROKER_METRIC_DEF = broker_metric_def()
