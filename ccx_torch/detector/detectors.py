"""Scheduled detectors — produce anomalies from monitor/admin state.

Parity: ``detector/{GoalViolationDetector,BrokerFailureDetector,
DiskFailureDetector,MetricAnomalyDetector,TopicAnomalyDetector,
MaintenanceEventDetector}.java`` (SURVEY.md C29, call stack 3.5). Each
detector's ``detect(now_ms)`` returns anomalies for the manager's priority
queue; scheduling lives in the manager so tests can drive detectors
synchronously (the reference mocks its scheduled executor the same way).
"""

from __future__ import annotations

import logging

from ccx_torch.common.exceptions import NotEnoughValidWindowsException
from ccx_torch.detector.anomalies import (
    Anomaly,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    MaintenanceEvent,
    TopicAnomaly,
)
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import evaluate_stack
from ccx_torch.monitor.aggregator import ModelCompletenessRequirements

log = logging.getLogger(__name__)


class GoalViolationDetector:
    """Ref GoalViolationDetector: score ``anomaly.detection.goals`` on the
    current model; violated hard goals (or out-of-band soft goals) raise a
    GoalViolations anomaly. No proposals are kept — the fix recomputes."""

    def __init__(self, load_monitor, config) -> None:
        self.load_monitor = load_monitor
        self.goal_names = tuple(
            g for g in config["anomaly.detection.goals"] if g in GOAL_REGISTRY
        )
        self.goal_config = GoalConfig.from_config(config)

    def detect(self, now_ms: int) -> list[Anomaly]:
        try:
            model, _, _ = self.load_monitor.cluster_model(
                ModelCompletenessRequirements(1, 0.5)
            )
        except NotEnoughValidWindowsException:
            return []
        stack = evaluate_stack(
            model, self.goal_config, ("StructuralFeasibility",) + self.goal_names
        )
        violated = [
            name
            for name, (v, _) in stack.by_name().items()
            if v > 0 and name != "StructuralFeasibility"
        ]
        if not violated:
            return []
        # Fixability heuristic (ref: optimization attempt decides): dead
        # brokers/disks make capacity goals unfixable by rebalance alone.
        return [
            GoalViolations(
                detection_ms=now_ms, fixable_violated_goals=tuple(violated)
            )
        ]


class BrokerFailureDetector:
    """Ref BrokerFailureDetector (AdminClient polling mode): a broker present
    in a previous generation but now dead/absent is failed; first-seen times
    persist across detections (and restarts, via the state file the reference
    keeps in ZK / local file)."""

    def __init__(self, admin, config=None, state_path: str | None = None) -> None:
        self.admin = admin
        if state_path is None and config is not None:
            state_path = config["failed.brokers.file.path"]
            if not state_path:
                import os

                os.makedirs(config["sample.store.dir"], exist_ok=True)
                state_path = os.path.join(
                    config["sample.store.dir"], "failed_brokers.json"
                )
        self.state_path = state_path
        self._known: set[int] = set()
        self._failed_since: dict[int, int] = {}
        if state_path:
            self._load_state()

    def _load_state(self) -> None:
        import json
        import os

        if self.state_path and os.path.exists(self.state_path):
            with open(self.state_path, encoding="utf-8") as f:
                self._failed_since = {
                    int(k): int(v) for k, v in json.load(f).items()
                }

    def _save_state(self) -> None:
        import json
        import os

        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._failed_since, f)
        os.replace(tmp, self.state_path)

    def detect(self, now_ms: int) -> list[Anomaly]:
        metadata = self.admin.describe_cluster()
        alive = metadata.alive_broker_ids()
        present = {b.broker_id for b in metadata.brokers}
        self._known |= present
        dead = (self._known - alive) | metadata.dead_broker_ids()
        for b in dead:
            self._failed_since.setdefault(b, now_ms)
        for b in list(self._failed_since):
            if b in alive:
                del self._failed_since[b]
        self._save_state()
        if not self._failed_since:
            return []
        return [
            BrokerFailures(
                detection_ms=now_ms, failed_brokers=dict(self._failed_since)
            )
        ]


class DiskFailureDetector:
    """Ref DiskFailureDetector: offline log dirs via describeLogDirs."""

    def __init__(self, admin, config=None) -> None:
        self.admin = admin

    def detect(self, now_ms: int) -> list[Anomaly]:
        offline: dict[int, tuple[int, ...]] = {}
        for broker, disks in self.admin.describe_log_dirs().items():
            bad = tuple(d for d, online in disks.items() if not online)
            if bad:
                offline[broker] = bad
        if not offline:
            return []
        return [DiskFailures(detection_ms=now_ms, failed_disks=offline)]


class MetricAnomalyDetector:
    """Ref MetricAnomalyDetector: delegates to the MetricAnomalyFinder SPI
    (default SlowBrokerFinder) over broker metric history."""

    def __init__(self, load_monitor, config) -> None:
        self.finder = config.configured_instance("metric.anomaly.finder.class")
        self.load_monitor = load_monitor

    def detect(self, now_ms: int) -> list[Anomaly]:
        metadata = self.load_monitor.admin.describe_cluster()
        agg = self.load_monitor.broker_aggregator.aggregate(
            len(metadata.brokers)
        )
        return self.finder.find(agg, metadata, now_ms)


class TopicAnomalyDetector:
    """Ref TopicAnomalyDetector + TopicReplicationFactorAnomalyFinder."""

    def __init__(self, admin, config) -> None:
        self.finder = config.configured_instance("topic.anomaly.finder.class")
        self.admin = admin

    def detect(self, now_ms: int) -> list[Anomaly]:
        return self.finder.find(self.admin.describe_cluster(), now_ms)


class MaintenanceEventDetector:
    """Ref MaintenanceEventDetector: drains the MaintenanceEventReader SPI."""

    def __init__(self, config) -> None:
        self.reader = config.configured_instance("maintenance.event.reader.class")

    def detect(self, now_ms: int) -> list[Anomaly]:
        return [
            MaintenanceEvent(
                detection_ms=now_ms,
                event_type=e.get("type", "NO_OP"),
                broker_ids=tuple(e.get("brokers", ())),
            )
            for e in self.reader.read_events(now_ms)
        ]


class TopicReplicationFactorAnomalyFinder:
    """Default `topic.anomaly.finder.class` (ref
    TopicReplicationFactorAnomalyFinder): flags topics whose RF deviates
    from `target.topic.replication.factor`."""

    def __init__(self, config=None) -> None:
        self.target_rf = 0
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        self.target_rf = config["target.topic.replication.factor"]

    def find(self, metadata, now_ms: int) -> list[Anomaly]:
        if self.target_rf <= 0:  # opt-in: no configured target, no anomalies
            return []
        bad: dict[str, int] = {}
        for topic in metadata.topics():
            rfs = {len(p.replicas) for p in metadata.partitions_of(topic)}
            for rf in rfs:
                if rf != self.target_rf:
                    bad[topic] = rf
        if not bad:
            return []
        return [
            TopicAnomaly(detection_ms=now_ms, bad_topics=bad,
                         target_rf=self.target_rf)
        ]


class NoopMaintenanceEventReader:
    """Default `maintenance.event.reader.class`."""

    def __init__(self, config=None) -> None:
        pass

    def read_events(self, now_ms: int) -> list[dict]:
        return []


class QueueMaintenanceEventReader:
    """In-memory event queue (the topic-based reader's role in tests)."""

    def __init__(self, config=None) -> None:
        self.events: list[dict] = []

    def add(self, event: dict) -> None:
        self.events.append(event)

    def read_events(self, now_ms: int) -> list[dict]:
        out, self.events = self.events, []
        return out
