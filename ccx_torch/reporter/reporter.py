"""CruiseControlMetricsReporter — the in-broker reporting agent.

Parity: ``cruise-control-metrics-reporter/.../CruiseControlMetricsReporter
.java`` (SURVEY.md C37, L0, call stack 3.4): runs INSIDE each broker,
samples the broker's Yammer/KafkaMetrics every
``metric.reporting.interval.ms`` and produces serialized raw metrics to the
metrics channel. Here the broker-side metric source is an SPI
(``BrokerMetricsSource``); ``SimulatedBrokerSource`` synthesizes a stable
workload from the simulated cluster's topology (the role the embedded-broker
harness plays in the reference's integration tests).
"""

from __future__ import annotations

import threading

import numpy as np

from ccx_torch.reporter.metrics import CruiseControlMetric, RawMetricType
from ccx_torch.reporter.transport import MetricsTransport


class BrokerMetricsSource:
    """SPI: one broker's raw observations at a point in time."""

    def metrics_for(self, broker_id: int, time_ms: int) -> list[CruiseControlMetric]:
        raise NotImplementedError


class SimulatedBrokerSource(BrokerMetricsSource):
    """Deterministic workload over a SimulatedCluster.

    Each partition gets a stable pseudo-random base load derived from a
    seed; per-broker rollups follow leadership, so killing a broker or
    moving replicas changes the reported stream exactly as it would on a
    real cluster. ``slow_brokers`` injects latency for SlowBrokerFinder
    scenarios.
    """

    def __init__(self, cluster, seed: int = 7) -> None:
        self.cluster = cluster
        self.seed = seed
        self.slow_brokers: dict[int, float] = {}

    def _base(self, tp) -> np.ndarray:
        rng = np.random.default_rng(
            (hash((tp.topic, tp.partition, self.seed))) & 0x7FFFFFFF
        )
        v = rng.random(4)
        # [bytes_in KB/s, bytes_out KB/s, size MB, messages/s]
        return np.array(
            [50 + 400 * v[0], 80 + 600 * v[1], 100 + 900 * v[2], 10 + 90 * v[3]]
        )

    def metrics_for(self, broker_id: int, time_ms: int) -> list[CruiseControlMetric]:
        c = self.cluster
        with c._lock:
            broker = c._brokers.get(broker_id)
            if broker is None or not broker.alive:
                return []
            parts = {tp: p for tp, p in c._partitions.items()}
        out: list[CruiseControlMetric] = []
        bytes_in = bytes_out = repl_in = repl_out = msgs = 0.0
        topic_in: dict[str, float] = {}
        for tp, p in parts.items():
            if broker_id not in p.replicas:
                continue
            base = self._base(tp)
            if p.leader == broker_id:
                out.append(CruiseControlMetric(
                    RawMetricType.PARTITION_BYTES_IN, time_ms, broker_id,
                    base[0], tp.topic, tp.partition,
                ))
                out.append(CruiseControlMetric(
                    RawMetricType.PARTITION_BYTES_OUT, time_ms, broker_id,
                    base[1], tp.topic, tp.partition,
                ))
                out.append(CruiseControlMetric(
                    RawMetricType.PARTITION_MESSAGES_IN, time_ms, broker_id,
                    base[3], tp.topic, tp.partition,
                ))
                bytes_in += base[0]
                bytes_out += base[1]
                msgs += base[3]
                topic_in[tp.topic] = topic_in.get(tp.topic, 0.0) + base[0]
                repl_out += base[0] * (len(p.replicas) - 1)
            else:
                repl_in += base[0]
            # size is reported by every replica holder (ref PARTITION_SIZE)
            out.append(CruiseControlMetric(
                RawMetricType.PARTITION_SIZE, time_ms, broker_id,
                base[2], tp.topic, tp.partition,
            ))
        cpu = min(0.05 + (bytes_in + bytes_out) / 20000.0, 1.0)
        flush = self.slow_brokers.get(broker_id, 5.0)
        broker_rows = {
            RawMetricType.ALL_TOPIC_BYTES_IN: bytes_in,
            RawMetricType.ALL_TOPIC_BYTES_OUT: bytes_out,
            RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN: repl_in,
            RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT: repl_out,
            RawMetricType.ALL_TOPIC_MESSAGES_IN_PER_SEC: msgs,
            RawMetricType.ALL_TOPIC_PRODUCE_REQUEST_RATE: msgs / 10.0,
            RawMetricType.ALL_TOPIC_FETCH_REQUEST_RATE: msgs / 5.0,
            RawMetricType.BROKER_CPU_UTIL: cpu,
            RawMetricType.BROKER_LOG_FLUSH_TIME_MS_MEAN: flush,
            RawMetricType.BROKER_LOG_FLUSH_TIME_MS_MAX: 2 * flush,
            RawMetricType.UNDER_REPLICATED_PARTITIONS: 0.0,
            RawMetricType.OFFLINE_LOG_DIRS: float(len(broker.offline_disks)),
        }
        for mtype, value in broker_rows.items():
            out.append(CruiseControlMetric(mtype, time_ms, broker_id, value))
        for topic, v in topic_in.items():
            out.append(CruiseControlMetric(
                RawMetricType.TOPIC_BYTES_IN, time_ms, broker_id, v, topic
            ))
        return out


class MetricsReporter:
    """The per-broker agent (ref CruiseControlMetricsReporter.report())."""

    def __init__(self, source: BrokerMetricsSource, transport: MetricsTransport,
                 broker_id: int, interval_ms: int = 60_000, clock=None) -> None:
        import time as _time

        self.source = source
        self.transport = transport
        self.broker_id = broker_id
        self.interval_ms = interval_ms
        self.clock = clock or (lambda: int(_time.time() * 1000))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def report_once(self, time_ms: int | None = None) -> int:
        t = time_ms if time_ms is not None else self.clock()
        batch = self.source.metrics_for(self.broker_id, t)
        if batch:
            self.transport.produce(batch)
        return len(batch)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"metrics-reporter-{self.broker_id}",
            daemon=True,
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.report_once()
            except Exception:
                import logging

                logging.getLogger(__name__).exception("metric report failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class ReporterFleet:
    """One reporter per simulated broker (the embedded-cluster harness)."""

    def __init__(self, cluster, transport: MetricsTransport,
                 interval_ms: int = 60_000, clock=None, seed: int = 7) -> None:
        self.source = SimulatedBrokerSource(cluster, seed)
        self.cluster = cluster
        self.reporters = {
            b: MetricsReporter(self.source, transport, b, interval_ms, clock)
            for b in cluster._brokers
        }

    def report_once(self, time_ms: int) -> int:
        return sum(r.report_once(time_ms) for r in self.reporters.values())

    def start(self) -> None:
        for r in self.reporters.values():
            r.start()

    def stop(self) -> None:
        for r in self.reporters.values():
            r.stop()
