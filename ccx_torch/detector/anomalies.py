"""Anomaly types — the self-healing vocabulary.

Parity: ``detector/`` anomaly classes ``{GoalViolations,BrokerFailures,
DiskFailures,KafkaMetricAnomaly,TopicAnomaly,MaintenanceEvent}.java`` and the
``Anomaly``/``AnomalyType`` SPI roots in cruise-control-core (SURVEY.md C29,
M1). Each anomaly knows how to fix itself through the service façade
(``fix(facade)`` → the reference's ``anomaly.fix()`` dispatching to
removeBrokers / fixOfflineReplicas / rebalance — call stack 3.5).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools


class AnomalyType(enum.IntEnum):
    """Priority order (smaller = more urgent), ref AnomalyType."""

    BROKER_FAILURE = 0
    DISK_FAILURE = 1
    METRIC_ANOMALY = 2
    GOAL_VIOLATION = 3
    TOPIC_ANOMALY = 4
    MAINTENANCE_EVENT = 5


_ids = itertools.count()


@dataclasses.dataclass
class Anomaly:
    detection_ms: int
    anomaly_id: str = dataclasses.field(
        default_factory=lambda: f"anomaly-{next(_ids)}"
    )

    @property
    def type(self) -> AnomalyType:
        raise NotImplementedError

    def reason(self) -> str:
        raise NotImplementedError

    def fix(self, facade) -> bool:
        """Apply the self-healing action; returns True if a fix started."""
        raise NotImplementedError

    def __lt__(self, other: "Anomaly") -> bool:  # priority-queue ordering
        return (self.type, self.detection_ms) < (other.type, other.detection_ms)

    def to_json(self) -> dict:
        return {
            "anomalyId": self.anomaly_id,
            "type": self.type.name,
            "detectionMs": self.detection_ms,
            "description": self.reason(),
        }


@dataclasses.dataclass
class GoalViolations(Anomaly):
    """Ref GoalViolations: goals whose hard constraint or balance limit is
    violated on the current model; fixable via a self-healing rebalance."""

    fixable_violated_goals: tuple[str, ...] = ()
    unfixable_violated_goals: tuple[str, ...] = ()

    @property
    def type(self) -> AnomalyType:
        return AnomalyType.GOAL_VIOLATION

    def reason(self) -> str:
        return (
            f"Goal violations: fixable {list(self.fixable_violated_goals)}, "
            f"unfixable {list(self.unfixable_violated_goals)}"
        )

    def fix(self, facade) -> bool:
        if not self.fixable_violated_goals:
            return False
        facade.rebalance(
            dryrun=False,
            reason=f"self-healing: {self.reason()}", self_healing=True
        )
        return True


@dataclasses.dataclass
class BrokerFailures(Anomaly):
    """Ref BrokerFailures: dead brokers with first-observed timestamps."""

    failed_brokers: dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def type(self) -> AnomalyType:
        return AnomalyType.BROKER_FAILURE

    def reason(self) -> str:
        return f"Broker failures detected: {self.failed_brokers}"

    def fix(self, facade) -> bool:
        if not self.failed_brokers:
            return False
        facade.remove_brokers(
            tuple(self.failed_brokers),
            dryrun=False,
            reason=f"self-healing: {self.reason()}", self_healing=True,
        )
        return True


@dataclasses.dataclass
class DiskFailures(Anomaly):
    """Ref DiskFailures: offline log dirs per broker."""

    failed_disks: dict[int, tuple[int, ...]] = dataclasses.field(default_factory=dict)

    @property
    def type(self) -> AnomalyType:
        return AnomalyType.DISK_FAILURE

    def reason(self) -> str:
        return f"Disk failures detected: {self.failed_disks}"

    def fix(self, facade) -> bool:
        if not self.failed_disks:
            return False
        facade.fix_offline_replicas(
            dryrun=False,
            reason=f"self-healing: {self.reason()}", self_healing=True
        )
        return True


@dataclasses.dataclass
class MetricAnomaly(Anomaly):
    """Ref KafkaMetricAnomaly (e.g. a slow broker found by SlowBrokerFinder)."""

    broker_id: int = -1
    metric_name: str = ""
    description: str = ""
    #: suggested remediation: demote (remove leadership) or remove broker
    fix_by_demotion: bool = True

    @property
    def type(self) -> AnomalyType:
        return AnomalyType.METRIC_ANOMALY

    def reason(self) -> str:
        return f"Metric anomaly on broker {self.broker_id}: {self.description}"

    def fix(self, facade) -> bool:
        if self.broker_id < 0:
            return False
        if self.fix_by_demotion:
            facade.demote_brokers(
                (self.broker_id,),
                dryrun=False,
                reason=f"self-healing: {self.reason()}", self_healing=True,
            )
        else:
            facade.remove_brokers(
                (self.broker_id,),
                dryrun=False,
                reason=f"self-healing: {self.reason()}", self_healing=True,
            )
        return True


@dataclasses.dataclass
class TopicAnomaly(Anomaly):
    """Ref TopicAnomaly: topics violating the desired replication factor."""

    bad_topics: dict[str, int] = dataclasses.field(default_factory=dict)
    target_rf: int = 3

    @property
    def type(self) -> AnomalyType:
        return AnomalyType.TOPIC_ANOMALY

    def reason(self) -> str:
        return (
            f"Topics with replication factor != {self.target_rf}: "
            f"{self.bad_topics}"
        )

    def fix(self, facade) -> bool:
        if not self.bad_topics:
            return False
        facade.update_topic_configuration(
            dict.fromkeys(self.bad_topics, self.target_rf),
            dryrun=False,
            reason=f"self-healing: {self.reason()}", self_healing=True,
        )
        return True


@dataclasses.dataclass
class MaintenanceEvent(Anomaly):
    """Ref MaintenanceEvent: operator-scheduled actions read from the
    MaintenanceEventReader SPI."""

    event_type: str = "NO_OP"  # ADD_BROKER/REMOVE_BROKER/DEMOTE_BROKER/REBALANCE/...
    broker_ids: tuple[int, ...] = ()

    @property
    def type(self) -> AnomalyType:
        return AnomalyType.MAINTENANCE_EVENT

    def reason(self) -> str:
        return f"Maintenance event {self.event_type} brokers={list(self.broker_ids)}"

    def fix(self, facade) -> bool:
        reason = f"maintenance: {self.reason()}"
        if self.event_type == "REMOVE_BROKER" and self.broker_ids:
            facade.remove_brokers(self.broker_ids, dryrun=False, reason=reason, self_healing=True)
        elif self.event_type == "ADD_BROKER" and self.broker_ids:
            facade.add_brokers(self.broker_ids, dryrun=False, reason=reason, self_healing=True)
        elif self.event_type == "DEMOTE_BROKER" and self.broker_ids:
            facade.demote_brokers(self.broker_ids, dryrun=False, reason=reason, self_healing=True)
        elif self.event_type == "REBALANCE":
            facade.rebalance(dryrun=False, reason=reason, self_healing=True)
        else:
            return False
        return True
