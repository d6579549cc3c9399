"""AnomalyDetectorManager — scheduling, priority queue, self-healing.

Parity: ``detector/AnomalyDetectorManager.java`` (SURVEY.md C29, call stack
3.5): per-type detection intervals feed a priority queue consumed by the
manager, which asks the ``AnomalyNotifier`` what to do — IGNORE, CHECK
(requeue after a delay), or FIX (invoke the anomaly's self-healing action
through the façade). The manager records anomaly history and self-healing
state for the ``state?substates=anomaly_detector`` response.

Tests (and the façade's synchronous paths) call ``run_once``; production
runs the background thread via ``start_detection``.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time as _time

from ccx_torch.detector.anomalies import Anomaly, AnomalyType
from ccx_torch.detector.detectors import (
    BrokerFailureDetector,
    DiskFailureDetector,
    GoalViolationDetector,
    MaintenanceEventDetector,
    MetricAnomalyDetector,
    TopicAnomalyDetector,
)
from ccx_torch.detector.notifier import Action

log = logging.getLogger(__name__)

HISTORY_LIMIT = 100

#: stream-detector cluster label for the service's own periodic poll
#: rounds — the one live cluster this Cruise Control instance watches
POLL_CLUSTER = "live"


class AnomalyDetectorManager:
    def __init__(self, config, load_monitor, facade=None, clock=None) -> None:
        self.config = config
        self.load_monitor = load_monitor
        self.facade = facade  # set later by the service wiring if needed
        self.clock = clock or (lambda: int(_time.time() * 1000))
        self.notifier = config.configured_instance("anomaly.notifier.class")
        admin = load_monitor.admin
        self.detectors = {
            AnomalyType.GOAL_VIOLATION: GoalViolationDetector(load_monitor, config),
            AnomalyType.BROKER_FAILURE: BrokerFailureDetector(admin, config),
            AnomalyType.DISK_FAILURE: DiskFailureDetector(admin, config),
            AnomalyType.METRIC_ANOMALY: MetricAnomalyDetector(load_monitor, config),
            AnomalyType.TOPIC_ANOMALY: TopicAnomalyDetector(admin, config),
            AnomalyType.MAINTENANCE_EVENT: MaintenanceEventDetector(config),
        }
        self._queue: list[tuple[int, Anomaly]] = []  # (ready_ms, anomaly)
        self._lock = threading.RLock()
        self._drain_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.history: list[dict] = []
        self.metrics = {t: 0 for t in AnomalyType}
        self.num_self_healing_started = 0
        # the live-stream detector: subscribes to the signals
        # already flowing (window outcomes, warm-pressure bands, devmem
        # verdicts) and fires the SAME facade verbs the queue path does,
        # at urgent priority (self_healing=True), one verb per episode
        from ccx_torch.detector.stream import StreamDetector

        self.stream = StreamDetector(
            config, healer=self._stream_heal, clock=clock
        )
        #: latest signals per cluster — the stream healer's verb context
        #: (e.g. which brokers were dead when the episode opened)
        self._stream_signals: dict[str, dict] = {}
        #: True while a periodic poll round is being mirrored onto the
        #: stream — the healer must stay silent there (drain owns verbs)
        self._poll_window = False

    # ----- intervals --------------------------------------------------------

    def interval_ms(self, type_: AnomalyType) -> int:
        key = {
            AnomalyType.GOAL_VIOLATION: "goal.violation.detection.interval.ms",
            AnomalyType.METRIC_ANOMALY: "metric.anomaly.detection.interval.ms",
            AnomalyType.DISK_FAILURE: "disk.failure.detection.interval.ms",
            AnomalyType.TOPIC_ANOMALY: "topic.anomaly.detection.interval.ms",
        }.get(type_)
        if key is not None:
            v = self.config[key]
            if v and v > 0:
                return v
        if type_ is AnomalyType.BROKER_FAILURE:
            return self.config["broker.failure.detection.backoff.ms"]
        return self.config["anomaly.detection.interval.ms"]

    # ----- lifecycle --------------------------------------------------------

    def start_detection(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="AnomalyDetectorManager", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        min_interval = min(self.interval_ms(t) for t in AnomalyType)
        next_run = {t: 0 for t in AnomalyType}
        while not self._stop.wait(min_interval / 1000.0):
            now = self.clock()
            due = [t for t in AnomalyType if now >= next_run[t]]
            for t in due:
                next_run[t] = now + self.interval_ms(t)
            try:
                self.run_once(due)
            except Exception:
                log.exception("anomaly detection round failed")

    # ----- one detection round (synchronous; ref detector schedules) --------

    def run_once(self, types: list[AnomalyType] | None = None) -> list[dict]:
        """Run the given detectors (default: all), drain the queue through
        the notifier, and return the decisions taken this round."""
        now = self.clock()
        # Detection and queue pushes hold the lock briefly; the drain —
        # which may run a full self-healing optimization — must NOT hold it,
        # or state() (the REST thread) blocks for the whole heal.
        round_found: list[Anomaly] = []
        for t in types if types is not None else list(AnomalyType):
            detector = self.detectors[t]
            try:
                found = detector.detect(now)
            except Exception:
                log.exception("detector %s failed", t.name)
                continue
            round_found.extend(found)
            with self._lock:
                for anomaly in found:
                    self.metrics[anomaly.type] += 1
                    heapq.heappush(self._queue, (now, anomaly))
        decisions = self._drain(now)
        try:
            self._observe_poll_round(round_found, decisions, now)
        except Exception:  # noqa: BLE001 — mirroring must never break a round
            log.exception("stream mirror of the poll round failed")
        return decisions

    def _drain(self, now_ms: int) -> list[dict]:
        with self._drain_lock:  # one drain at a time; state() stays unblocked
            with self._lock:
                ready: list[tuple[int, Anomaly]] = []
                later: list[tuple[int, Anomaly]] = []
                while self._queue:
                    item = heapq.heappop(self._queue)
                    (ready if item[0] <= now_ms else later).append(item)
                for item in later:
                    heapq.heappush(self._queue, item)

            decisions: list[dict] = []
            requeue: list[tuple[int, Anomaly]] = []
            for _, anomaly in ready:
                if not self._still_valid(anomaly):
                    decisions.append(
                        {
                            "anomaly": anomaly.to_json(),
                            "action": Action.IGNORE.value,
                            "timeMs": now_ms,
                            "resolved": True,
                        }
                    )
                    continue
                result = self.notifier.on_anomaly(anomaly, now_ms)
                record = {
                    "anomaly": anomaly.to_json(),
                    "action": result.action.value,
                    "timeMs": now_ms,
                }
                if result.action is Action.CHECK:
                    requeue.append((now_ms + result.delay_ms, anomaly))
                elif result.action is Action.FIX and self.facade is not None:
                    try:
                        started = anomaly.fix(self.facade)
                        record["selfHealingStarted"] = started
                        if started:
                            with self._lock:
                                self.num_self_healing_started += 1
                    except Exception as e:
                        log.exception("self-healing fix failed")
                        record["selfHealingStarted"] = False
                        record["fixError"] = str(e)
                decisions.append(record)

            with self._lock:
                for item in requeue:
                    heapq.heappush(self._queue, item)
                self.history.extend(decisions)
                del self.history[:-HISTORY_LIMIT]
            return decisions

    def _still_valid(self, anomaly: Anomaly) -> bool:
        """Re-validate a (possibly requeued) anomaly against current state —
        a broker that came back inside the grace window must not be healed
        (ref: CHECK re-detects before acting)."""
        from ccx_torch.detector.anomalies import BrokerFailures

        if isinstance(anomaly, BrokerFailures):
            current = self.detectors[AnomalyType.BROKER_FAILURE]._failed_since
            anomaly.failed_brokers = {
                b: t for b, t in anomaly.failed_brokers.items() if b in current
            }
            return bool(anomaly.failed_brokers)
        return True

    # ----- the live-stream loop ---------------------------------------------

    def observe_stream(self, cluster: str, signals: dict,
                       t_s: float | None = None) -> dict:
        """Feed one serving window's live signals to the stream detector
        (SLO accounting + classification + one-verb-per-episode healing).
        ``t_s`` defaults to the manager clock, in seconds."""
        if t_s is None:
            t_s = self.clock() / 1000.0
        self._stream_signals[cluster] = dict(signals)
        return self.stream.observe(cluster, signals, t_s)

    def _observe_poll_round(self, found: list, decisions: list,
                            now_ms: int) -> None:
        """Mirror one periodic detection round onto the live-stream
        detector as a single SLO window (service mode's live feed). The
        queue drain owns healing here — notifier grace, alerts, backoff
        — so the stream must NEVER fire a second facade verb: episodes
        open/close from the poll detectors' findings, and an episode is
        marked fired only when this round's drain started the heal."""
        if not self.stream.enabled:
            return
        from ccx_torch.detector.anomalies import BrokerFailures, GoalViolations

        dead: set[int] = set()
        goals = 0
        for a in found:
            if isinstance(a, BrokerFailures):
                dead.update(a.failed_brokers)
            elif isinstance(a, GoalViolations):
                goals += len(a.fixable_violated_goals)
        signals = {
            # a poll round is not a serving window: warm/verified/wall
            # are vacuously good (absent wall_s counts as a latency
            # MISS), only violation_free carries signal here
            "warm": True, "verified": True, "wall_s": 0.0,
            "dead_brokers": tuple(sorted(dead)),
            "goal_violations": goals,
        }
        t_s = now_ms / 1000.0
        self._stream_signals[POLL_CLUSTER] = signals
        self._poll_window = True
        try:
            self.stream.observe(POLL_CLUSTER, signals, t_s)
        finally:
            self._poll_window = False
        healed = [d for d in decisions if d.get("selfHealingStarted")]
        if healed:
            types = {d["anomaly"].get("type") for d in healed}
            verb = ("remove_brokers" if "BROKER_FAILURE" in types
                    else "rebalance")
            self.stream.note_fired(POLL_CLUSTER, verb, t_s)

    def _stream_heal(self, cluster: str, family: str, cause: str) -> str | None:
        """Fire the facade anomaly verb for a stream-classified episode —
        the same dispatch the queue path's ``anomaly.fix`` uses, so the
        verb lands with ``self_healing=True`` (urgent fleet priority)."""
        if self._poll_window:
            # poll-round mirror: the queue drain owns healing (grace /
            # alerts / backoff) — ``note_fired`` mirrors its verb, the
            # stream never dispatches a second one
            return None
        if self.facade is None:
            return None
        from ccx_torch.detector.anomalies import BrokerFailures, GoalViolations

        now = self.clock()
        signals = self._stream_signals.get(cluster) or {}
        dead = tuple(signals.get("dead_brokers") or ())
        if family == "broker_failure" and dead:
            anomaly: Anomaly = BrokerFailures(
                detection_ms=now,
                failed_brokers={int(b): now for b in dead},
            )
            verb = "remove_brokers"
        else:
            anomaly = GoalViolations(
                detection_ms=now,
                fixable_violated_goals=(f"stream:{family}",),
            )
            verb = "rebalance"
        started = anomaly.fix(self.facade)
        if started:
            with self._lock:
                self.num_self_healing_started += 1
        return verb if started else None

    # ----- state ------------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {
                "selfHealingEnabled": {
                    t.name: v
                    for t, v in self.notifier.self_healing_enabled().items()
                },
                "recentAnomalies": self.history[-20:],
                "metrics": {t.name: n for t, n in self.metrics.items()},
                "numSelfHealingStarted": self.num_self_healing_started,
                "pendingChecks": len(self._queue),
                # VIEWER-safe stream-detector + SLO summary
                "slo": self.stream.state(),
            }
