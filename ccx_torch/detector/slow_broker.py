"""SlowBrokerFinder — latency-percentile broker anomaly detection.

Parity: ``detector/SlowBrokerFinder.java`` (SURVEY.md C29, §5.3): a broker is
*slow* when its log-flush time is high both against its **own history**
(current value above the configured percentile of its window history) and
against the **cluster** (above the cluster-wide mean by a margin), while it
is actually serving traffic (bytes-in above a floor, so idle brokers are not
flagged). Persistent slowness escalates from demotion to removal in the
reference; we carry that via ``fix_by_demotion``.
"""

from __future__ import annotations

import numpy as np

from ccx_torch.detector.anomalies import Anomaly, MetricAnomaly
from ccx_torch.monitor.aggregator import AggregationResult
from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF

_FLUSH = BROKER_METRIC_DEF.metric_info("BROKER_LOG_FLUSH_TIME_MS_MEAN").id
_BYTES_IN = BROKER_METRIC_DEF.metric_info("ALL_TOPIC_BYTES_IN").id


class SlowBrokerFinder:
    """Default `metric.anomaly.finder.class` (ref C29)."""

    def __init__(self, config=None) -> None:
        self.bytes_in_floor_kb_s = 1024.0
        self.flush_threshold_ms = 1000.0
        self.history_percentile = 90.0
        self.cluster_margin = 3.0  # current > margin x cluster mean
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        self.bytes_in_floor_kb_s = config[
            "slow.broker.bytes.in.rate.detection.threshold"
        ]
        self.flush_threshold_ms = config[
            "slow.broker.log.flush.time.threshold.ms"
        ]
        self.history_percentile = config[
            "slow.broker.metric.history.percentile.threshold"
        ]

    def find(self, agg: AggregationResult, metadata, now_ms: int) -> list[Anomaly]:
        if agg.num_windows < 2:
            return []
        flush = agg.values[:, :, _FLUSH]        # [B, W]
        bytes_in = agg.values[:, :, _BYTES_IN]  # [B, W]
        current = flush[:, -1]
        history = flush[:, :-1]
        hist_pct = np.percentile(history, self.history_percentile, axis=1)
        alive = np.array([b.alive for b in metadata.brokers], bool)
        n = min(len(alive), flush.shape[0])
        alive = alive[:n]
        current, hist_pct = current[:n], hist_pct[:n]
        serving = bytes_in[:n, -1] >= self.bytes_in_floor_kb_s
        cluster_mean = float(np.mean(current[alive])) if alive.any() else 0.0
        slow = (
            alive
            & serving
            & (current > self.flush_threshold_ms)
            & (current > hist_pct)
            & (current > self.cluster_margin * max(cluster_mean, 1e-9))
        )
        out: list[Anomaly] = []
        for i in np.nonzero(slow)[0]:
            out.append(
                MetricAnomaly(
                    detection_ms=now_ms,
                    broker_id=metadata.brokers[i].broker_id,
                    metric_name="BROKER_LOG_FLUSH_TIME_MS_MEAN",
                    description=(
                        f"log flush time {current[i]:.1f}ms exceeds "
                        f"p{self.history_percentile:.0f} history "
                        f"{hist_pct[i]:.1f}ms and {self.cluster_margin:.0f}x "
                        f"cluster mean {cluster_mean:.1f}ms"
                    ),
                    fix_by_demotion=True,
                )
            )
        return out
