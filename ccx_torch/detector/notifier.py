"""AnomalyNotifier SPI — decide FIX / CHECK / IGNORE per anomaly.

Parity: ``detector/notifier/{AnomalyNotifier,SelfHealingNotifier}.java``
(SURVEY.md C30): the notifier is the policy layer between detection and
self-healing — per-anomaly-type enable switches, and for broker failures the
two grace thresholds ``broker.failure.alert.threshold.ms`` (alert after) and
``broker.failure.self.healing.threshold.ms`` (auto-fix after). Webhook
flavors (Slack/MS Teams/Alerta in the reference) are modeled by
``WebhookSelfHealingNotifier`` posting JSON to a configurable sink callable —
transport-free so tests and operators can wire anything.
"""

from __future__ import annotations

import dataclasses
import enum

from ccx_torch.detector.anomalies import Anomaly, AnomalyType, BrokerFailures


class Action(enum.Enum):
    IGNORE = "IGNORE"
    CHECK = "CHECK"   # re-evaluate after delay_ms
    FIX = "FIX"


@dataclasses.dataclass(frozen=True)
class NotifierResult:
    action: Action
    delay_ms: int = 0

    @classmethod
    def ignore(cls) -> "NotifierResult":
        return cls(Action.IGNORE)

    @classmethod
    def check(cls, delay_ms: int) -> "NotifierResult":
        return cls(Action.CHECK, delay_ms)

    @classmethod
    def fix(cls) -> "NotifierResult":
        return cls(Action.FIX)


class AnomalyNotifier:
    """SPI (ref C30)."""

    def configure(self, config) -> None:
        pass

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> NotifierResult:
        raise NotImplementedError

    def self_healing_enabled(self) -> dict[AnomalyType, bool]:
        return {t: False for t in AnomalyType}


class SelfHealingNotifier(AnomalyNotifier):
    """Ref SelfHealingNotifier: grace windows for broker failures, a master
    self-healing switch, per-type overrides."""

    def __init__(self, config=None) -> None:
        self.enabled: dict[AnomalyType, bool] = {t: False for t in AnomalyType}
        self.alert_threshold_ms = 900_000
        self.self_healing_threshold_ms = 1_800_000
        self.alerts: list[dict] = []  # alert log (webhooks subclass and send)
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        master = config["self.healing.enabled"]
        self.enabled = {t: master for t in AnomalyType}
        self.alert_threshold_ms = config["broker.failure.alert.threshold.ms"]
        self.self_healing_threshold_ms = config[
            "broker.failure.self.healing.threshold.ms"
        ]

    def self_healing_enabled(self) -> dict[AnomalyType, bool]:
        return dict(self.enabled)

    def alert(self, anomaly: Anomaly, auto_fix_triggered: bool, now_ms: int) -> None:
        self.alerts.append(
            {
                "anomaly": anomaly.to_json(),
                "selfHealingStarted": auto_fix_triggered,
                "timeMs": now_ms,
            }
        )

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> NotifierResult:
        if isinstance(anomaly, BrokerFailures):
            return self._on_broker_failure(anomaly, now_ms)
        if not self.enabled.get(anomaly.type, False):
            self.alert(anomaly, False, now_ms)
            return NotifierResult.ignore()
        self.alert(anomaly, True, now_ms)
        return NotifierResult.fix()

    def _on_broker_failure(self, anomaly: BrokerFailures, now_ms: int) -> NotifierResult:
        """The reference's two-stage grace logic: before the alert threshold
        stay quiet and re-check; between alert and self-healing thresholds
        alert and re-check; past the self-healing threshold auto-fix (if
        enabled for BROKER_FAILURE)."""
        if not anomaly.failed_brokers:
            return NotifierResult.ignore()
        earliest = min(anomaly.failed_brokers.values())
        alert_at = earliest + self.alert_threshold_ms
        heal_at = earliest + self.self_healing_threshold_ms
        if now_ms < alert_at:
            return NotifierResult.check(alert_at - now_ms)
        can_heal = self.enabled.get(AnomalyType.BROKER_FAILURE, False)
        if now_ms < heal_at:
            self.alert(anomaly, False, now_ms)
            return (
                NotifierResult.check(heal_at - now_ms)
                if can_heal
                else NotifierResult.ignore()
            )
        self.alert(anomaly, can_heal, now_ms)
        return NotifierResult.fix() if can_heal else NotifierResult.ignore()


class WebhookSelfHealingNotifier(SelfHealingNotifier):
    """Alert sink over an injected callable (the Slack/MS Teams/Alerta
    notifiers of the reference, transport abstracted)."""

    def __init__(self, sink=None, config=None) -> None:
        super().__init__(config)
        self.sink = sink or (lambda payload: None)

    def alert(self, anomaly, auto_fix_triggered, now_ms) -> None:
        super().alert(anomaly, auto_fix_triggered, now_ms)
        self.sink(self.alerts[-1])
