"""Executor — applies proposals to the cluster with throttling + polling.

Parity: ``executor/Executor.java`` (SURVEY.md C23, call stack 3.3): the
movement state machine NO_TASK_IN_PROGRESS → STARTING_EXECUTION →
INTER_BROKER_REPLICA_MOVEMENT → (INTRA_BROKER_REPLICA_MOVEMENT) →
LEADER_MOVEMENT → STOPPING_EXECUTION; a single execution reservation; a
progress-polling loop that marks tasks COMPLETED/DEAD; replication throttles
set before and cleared after; concurrency auto-tuned mid-flight
(``ExecutionConcurrencyManager``, C26) from live broker health.

The cluster side is the ``AdminApi`` SPI (ccx.executor.admin): brokers move
the bytes themselves after ``alter_partition_reassignments`` — the executor
only watches ``list_partition_reassignments`` shrink, exactly like the
reference watching AdminClient reassignment state.

Tests drive the loop synchronously with an injected ``waiter`` that advances
the simulated cluster's clock (the role the reference's mocked ``Time``
plays in ``ExecutorTest``).
"""

from __future__ import annotations

import collections
import enum
import threading
import time as _time

import logging

from ccx_torch.common.exceptions import OngoingExecutionException
from ccx_torch.common.metadata import ClusterMetadata
from ccx_torch.common.metrics import REGISTRY
from ccx_torch.executor.admin import THROTTLE_CONFIG, AdminApi
from ccx_torch.executor.execution_task import TaskState, TaskType
from ccx_torch.executor.strategy import build_strategy_chain
from ccx_torch.executor.task_manager import ExecutionCaps, ExecutionTaskManager

LOG = logging.getLogger(__name__)
from ccx_torch.proposals import ExecutionProposal


class ExecutorState(enum.Enum):
    """Ref Executor.ExecutorState.State (C23)."""

    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    )
    INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = (
        "INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    )
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


class ReplicationThrottleHelper:
    """Ref ``executor/ReplicationThrottleHelper.java`` (C27): set/clear the
    dynamic replication-throttle configs around an execution."""

    def __init__(self, admin: AdminApi, throttle_bytes_per_sec: int) -> None:
        self.admin = admin
        self.rate = throttle_bytes_per_sec

    def set_throttles(self, broker_ids: list[int]) -> None:
        if self.rate is None or self.rate < 0:
            return
        self.admin.incremental_alter_configs(
            {b: {THROTTLE_CONFIG: str(self.rate)} for b in broker_ids}
        )

    def clear_throttles(self, broker_ids: list[int]) -> None:
        if self.rate is None or self.rate < 0:
            return
        self.admin.incremental_alter_configs(
            {b: {THROTTLE_CONFIG: None} for b in broker_ids}
        )


class ExecutionConcurrencyManager:
    """Ref ``executor/ExecutionConcurrencyManager.java`` (C26): raise the
    per-broker movement cap while the cluster is healthy, drop it when
    under-replication or queue pressure appears."""

    def __init__(self, config, broker_metrics_fn=None) -> None:
        self.enabled = config["executor.concurrency.adjuster.enabled"]
        self.cap = config["num.concurrent.partition.movements.per.broker"]
        self.max_cap = config[
            "executor.concurrency.adjuster.max.partition.movements.per.broker"
        ]
        self.min_cap = config[
            "executor.concurrency.adjuster.min.partition.movements.per.broker"
        ]
        #: returns {broker_id: {metric_name: value}} of recent broker health
        self.broker_metrics_fn = broker_metrics_fn
        self.adjustments_up = 0
        self.adjustments_down = 0
        self.last_adjustment = "none"
        REGISTRY.set_gauge(
            "executor.concurrency-cap", self.cap,
            labels={"type": "inter-broker"},
            help="Current per-broker concurrent movement cap "
                 "(auto-tuned by the concurrency adjuster)",
        )

    def adjust(self, metadata: ClusterMetadata) -> int:
        if not self.enabled:
            return self.cap
        unhealthy = bool(metadata.under_replicated()) or bool(
            metadata.dead_broker_ids()
        )
        if not unhealthy and self.broker_metrics_fn is not None:
            metrics = self.broker_metrics_fn() or {}
            for vals in metrics.values():
                if vals.get("UNDER_REPLICATED_PARTITIONS", 0) > 0:
                    unhealthy = True
                    break
        prev = self.cap
        if unhealthy:
            self.cap = max(self.min_cap, self.cap // 2)
        else:
            self.cap = min(self.max_cap, self.cap + 1)
        if self.cap < prev:
            self.adjustments_down += 1
            self.last_adjustment = "down"
            REGISTRY.counter(
                "executor.concurrency-adjust-down",
                "Concurrency-adjuster cap decreases (cluster unhealthy)",
            ).inc()
        elif self.cap > prev:
            self.adjustments_up += 1
            self.last_adjustment = "up"
            REGISTRY.counter(
                "executor.concurrency-adjust-up",
                "Concurrency-adjuster cap increases (cluster healthy)",
            ).inc()
        REGISTRY.set_gauge(
            "executor.concurrency-cap", self.cap,
            labels={"type": "inter-broker"},
            help="Current per-broker concurrent movement cap "
                 "(auto-tuned by the concurrency adjuster)",
        )
        return self.cap

    def observability_json(self) -> dict:
        return {
            "enabled": bool(self.enabled),
            "cap": self.cap,
            "minCap": self.min_cap,
            "maxCap": self.max_cap,
            "adjustmentsUp": self.adjustments_up,
            "adjustmentsDown": self.adjustments_down,
            "lastAdjustment": self.last_adjustment,
        }


class Executor:
    """The L3c layer (ref C23)."""

    def __init__(self, config, admin: AdminApi, clock=None, waiter=None,
                 broker_metrics_fn=None) -> None:
        self.config = config
        self.admin = admin
        self.clock = clock or (lambda: int(_time.time() * 1000))
        #: called between progress polls with the poll interval in ms;
        #: default real sleep, tests advance simulated time instead
        self.waiter = waiter or (lambda ms: _time.sleep(ms / 1000.0))
        self.caps = ExecutionCaps.from_config(config)
        self.strategy = build_strategy_chain(config)
        #: broker_metrics_fn — live broker-health feed (the façade wires the
        #: LoadMonitor's broker aggregator in, ref C26)
        self.concurrency = ExecutionConcurrencyManager(config, broker_metrics_fn)
        self.poll_interval_ms = config["execution.progress.check.interval.ms"]
        self._state = ExecutorState.NO_TASK_IN_PROGRESS
        self._stop_requested = threading.Event()
        self._reservation = threading.Lock()
        self._manager: ExecutionTaskManager | None = None
        self._thread: threading.Thread | None = None
        self._last_uuid: str | None = None
        self._replication_throttle = config["default.replication.throttle"]
        # measured per-wave completion telemetry: real MB/s from finished movement
        # waves, fed back into the fluid wave-pricing model — the
        # facade's re-plans price waves with this instead of the static
        # optimizer.plan.throttle.mbps once a wave has completed
        self._wave_telemetry: collections.deque = collections.deque(maxlen=32)
        self._measured_mbps = 0.0

    # ----- state ------------------------------------------------------------

    @property
    def state(self) -> ExecutorState:
        return self._state

    @property
    def has_ongoing_execution(self) -> bool:
        return self._state is not ExecutorState.NO_TASK_IN_PROGRESS

    def state_json(self) -> dict:
        out = {"state": self._state.value}
        if self._manager is not None:
            out.update(self._manager.tracker.to_json())
            out["triggeredUserTaskId"] = self._last_uuid
        return out

    def observability_json(self) -> dict:
        """The ``executor`` block on GET /observability: live state, the
        concurrency adjuster's auto-tune trail, and whether the current (or
        last) execution is consuming a device-scheduled movement plan."""
        wave_map = (
            self._manager.planner.wave_by_partition
            if self._manager is not None else {}
        )
        return {
            "state": self._state.value,
            "concurrency": self.concurrency.observability_json(),
            "plan": {
                "consuming": bool(wave_map),
                "waves": (max(wave_map.values()) + 1) if wave_map else 0,
                "plannedPartitions": len(wave_map),
                # measured completion telemetry:
                # real per-wave MB/s from finished waves + the EWMA the
                # re-plan pricing consumes (0.0 = nothing measured yet)
                "measuredMbPerSec": round(self._measured_mbps, 3),
                "measuredWaves": list(self._wave_telemetry),
            },
        }

    # ----- entry (ref executeProposals) ------------------------------------

    def execute_proposals(
        self,
        proposals: list[ExecutionProposal],
        metadata: ClusterMetadata,
        uuid: str | None = None,
        replication_throttle: int | None = None,
        background: bool = False,
        plan: object | None = None,
    ) -> ExecutionTaskManager:
        if not self._reservation.acquire(blocking=False):
            raise OngoingExecutionException(
                f"Cannot execute: executor is in state {self._state.value}"
            )
        try:
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested.clear()
            self._last_uuid = uuid
            self._replication_throttle = (
                replication_throttle
                if replication_throttle is not None
                else self.config["default.replication.throttle"]
            )
            self._manager = ExecutionTaskManager(
                proposals, self.strategy, self.caps, metadata, plan=plan
            )
        except BaseException:
            self._state = ExecutorState.NO_TASK_IN_PROGRESS
            self._reservation.release()
            raise
        if background:
            self._thread = threading.Thread(
                target=self._run, name="ProposalExecutionRunnable", daemon=True
            )
            self._thread.start()
        else:
            self._run()
        return self._manager

    def stop_execution(self) -> None:
        """Ref stopProposalExecution: abort pending work, let in-flight
        movements finish (Kafka cannot cancel an in-flight reassignment
        pre-2.4-style; we mirror graceful stop)."""
        if self.has_ongoing_execution:
            self._stop_requested.set()
            self._state = ExecutorState.STOPPING_EXECUTION

    def await_completion(self, timeout_s: float = 30.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    # ----- the execution loop (ref ProposalExecutionRunnable) ---------------

    def _run(self) -> None:
        mgr = self._manager
        assert mgr is not None
        throttle = ReplicationThrottleHelper(self.admin, self._replication_throttle)
        brokers = [b.broker_id for b in mgr.metadata.brokers] if mgr.metadata else []
        try:
            # set_throttles inside the try: if the alter-configs RPC itself
            # fails, the finally still resets state + releases the
            # reservation (ref C27 exception-safety around the execute path).
            throttle.set_throttles(brokers)
            self._state = (
                ExecutorState.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
            )
            self._move_replicas(mgr)
            if not self._stop_requested.is_set():
                self._state = (
                    ExecutorState.INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
                )
                self._move_disks(mgr)
            if not self._stop_requested.is_set():
                self._state = ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS
                self._move_leadership(mgr)
        finally:
            # Throttles come off on success AND error paths; state and
            # reservation recover even when clear_throttles itself raises.
            try:
                throttle.clear_throttles(brokers)
            finally:
                self._state = ExecutorState.NO_TASK_IN_PROGRESS
                self._reservation.release()

    def _abort_pending(self, mgr: ExecutionTaskManager, type_: TaskType) -> None:
        now = self.clock()
        for t in mgr.tracker.tasks_of(type_, TaskState.PENDING):
            t.transition(TaskState.ABORTED, now)

    def _move_replicas(self, mgr: ExecutionTaskManager) -> None:
        type_ = TaskType.INTER_BROKER_REPLICA_ACTION
        # per-wave completion telemetry: group the task set by plan wave
        # (wave 0 = everything when no plan rides the proposal), stamp
        # each wave's first start, and record measured MB/s as waves
        # finish — the feedback the fluid wave-pricing model consumes
        wave_of = {
            id(t): mgr.planner.wave_by_partition.get(
                int(t.proposal.partition), 0
            )
            for t in mgr.tracker.tasks_of(type_)
        }
        wave_started: dict[int, int] = {}
        wave_done: set[int] = set()
        while not mgr.tracker.finished:
            if self._stop_requested.is_set():
                self._abort_pending(mgr, type_)
                break
            metadata = self.admin.describe_cluster()
            cap = self.concurrency.adjust(metadata)
            batch = mgr.planner.inter_broker_batch(mgr.tracker, metadata, cap)
            if batch:
                now = self.clock()
                self.admin.alter_partition_reassignments(
                    {t.tp: tuple(t.proposal.new_replicas) for t in batch}
                )
                for t in batch:
                    t.transition(TaskState.IN_PROGRESS, now)
                    wave_started.setdefault(wave_of[id(t)], now)
            in_progress = mgr.tracker.tasks_of(type_, TaskState.IN_PROGRESS)
            if not in_progress and not mgr.tracker.tasks_of(type_, TaskState.PENDING):
                break
            self.waiter(self.poll_interval_ms)
            self._poll_reassignments(mgr)
            self._settle_waves(mgr, wave_of, wave_started, wave_done)
        self._settle_waves(mgr, wave_of, wave_started, wave_done)

    def _settle_waves(self, mgr: ExecutionTaskManager,
                      wave_of: dict[int, int],
                      wave_started: dict[int, int],
                      wave_done: set[int]) -> None:
        """Record measured MB/s for every started wave whose tasks all
        settled (COMPLETED/DEAD/ABORTED); updates the EWMA rate the
        facade's re-plans consume."""
        terminal = (TaskState.COMPLETED, TaskState.DEAD, TaskState.ABORTED)
        tasks = mgr.tracker.tasks_of(TaskType.INTER_BROKER_REPLICA_ACTION)
        by_wave: dict[int, list] = {}
        for t in tasks:
            by_wave.setdefault(wave_of.get(id(t), 0), []).append(t)
        now = self.clock()
        for w, start in list(wave_started.items()):
            if w in wave_done:
                continue
            ts = by_wave.get(w, [])
            if not ts or not all(t.state in terminal for t in ts):
                continue
            wave_done.add(w)
            moved_mb = sum(
                t.data_to_move_mb for t in ts
                if t.state is TaskState.COMPLETED
            )
            seconds = max((now - start) / 1000.0, 1e-9)
            rate = moved_mb / seconds
            self._wave_telemetry.append({
                "wave": int(w),
                "tasks": len(ts),
                "movedMb": round(float(moved_mb), 3),
                "seconds": round(seconds, 3),
                "mbPerSec": round(rate, 3),
            })
            if moved_mb > 0:
                # EWMA over completed waves: one outlier wave (a stall,
                # an aborted tail) must not whipsaw the re-plan pricing
                self._measured_mbps = (
                    rate if self._measured_mbps <= 0.0
                    else 0.5 * self._measured_mbps + 0.5 * rate
                )
                REGISTRY.set_gauge(
                    "executor-measured-wave-mbps", self._measured_mbps,
                    help="EWMA of measured per-wave inter-broker movement "
                         "rate (MB/s) — the live feedback the movement "
                         "planner prices re-plans with",
                )

    def measured_wave_mb_per_sec(self) -> float:
        """EWMA of measured per-wave movement rate (MB/s); 0.0 until the
        first wave with real data completes."""
        return float(self._measured_mbps)

    def _poll_reassignments(self, mgr: ExecutionTaskManager) -> None:
        in_flight = self.admin.list_partition_reassignments()
        metadata = self.admin.describe_cluster()
        alive = metadata.alive_broker_ids()
        pidx = {p.tp: p for p in metadata.partitions}
        now = self.clock()
        for t in mgr.tracker.tasks_of(
            TaskType.INTER_BROKER_REPLICA_ACTION, TaskState.IN_PROGRESS
        ):
            if t.tp in in_flight:
                # DEAD if every destination broker died mid-flight (ref:
                # tasks whose new replicas are offline are marked dead)
                if t.destination_brokers and all(
                    b not in alive for b in t.destination_brokers
                ):
                    t.transition(TaskState.DEAD, now)
                continue
            current = pidx.get(t.tp)
            if current is not None and set(current.replicas) == set(
                t.proposal.new_replicas
            ):
                t.transition(TaskState.COMPLETED, now)
            else:
                t.transition(TaskState.DEAD, now)

    def _move_disks(self, mgr: ExecutionTaskManager) -> None:
        type_ = TaskType.INTRA_BROKER_REPLICA_ACTION
        while True:
            if self._stop_requested.is_set():
                self._abort_pending(mgr, type_)
                break
            batch = mgr.planner.intra_broker_batch(mgr.tracker)
            if not batch:
                break
            now = self.clock()
            moves: dict[tuple, int] = {}
            for t in batch:
                for b, od, nd in zip(
                    t.proposal.new_replicas, t.proposal.old_disks,
                    t.proposal.new_disks,
                ):
                    if od != nd:
                        moves[(t.tp, b)] = nd
                t.transition(TaskState.IN_PROGRESS, now)
            self.admin.alter_replica_log_dirs(moves)
            # Poll log-dir state until the batch settles (disk moves take
            # real time on real clusters). The alerting threshold only
            # *alerts* (ref: task.execution.alerting.threshold.ms triggers a
            # metric/log, never kills the task — the log-dir move may still
            # complete); DEAD only on real failure signals: partition gone
            # or destination broker dead.
            alert_at = self.clock() + self.config[
                "task.execution.alerting.threshold.ms"
            ]
            alerted: set = set()
            remaining = list(batch)
            while remaining:
                self.waiter(self.poll_interval_ms)
                metadata = self.admin.describe_cluster()
                alive = metadata.alive_broker_ids()
                pidx = {p.tp: p for p in metadata.partitions}
                now = self.clock()
                still = []
                for t in remaining:
                    cur = pidx.get(t.tp)
                    want = {
                        b: nd for b, nd in zip(
                            t.proposal.new_replicas, t.proposal.new_disks
                        )
                    }
                    done = cur is not None and all(
                        want.get(b, d) == d
                        for b, d in zip(cur.replicas, cur.replica_dirs)
                    )
                    broker_dead = any(b not in alive for b in want)
                    if done:
                        t.transition(TaskState.COMPLETED, now)
                    elif cur is None or broker_dead:
                        t.transition(TaskState.DEAD, now)
                    else:
                        if now >= alert_at and t.tp not in alerted:
                            alerted.add(t.tp)
                            REGISTRY.counter("executor.slow-task-alerts").inc()
                            LOG.warning(
                                "intra-broker move %s exceeded alerting "
                                "threshold; still polling", t.tp,
                            )
                        still.append(t)
                remaining = still
                if self._stop_requested.is_set():
                    break

    def _move_leadership(self, mgr: ExecutionTaskManager) -> None:
        type_ = TaskType.LEADER_ACTION
        while True:
            if self._stop_requested.is_set():
                self._abort_pending(mgr, type_)
                break
            batch = mgr.planner.leadership_batch(mgr.tracker)
            if not batch:
                break
            now = self.clock()
            for t in batch:
                t.transition(TaskState.IN_PROGRESS, now)
            # Preferred-leader election elects replicas[0]; first reorder the
            # replica list so the target leader is preferred (a zero-copy
            # reassignment, as the reference's proposals carry the new leader
            # first in the replica list), then elect.
            reorders = {}
            pidx0 = {p.tp: p for p in self.admin.describe_cluster().partitions}
            for t in batch:
                cur = pidx0.get(t.tp)
                if cur is None:
                    continue
                want_leader = t.proposal.new_leader
                if cur.replicas and cur.replicas[0] != want_leader and (
                    want_leader in cur.replicas
                ):
                    reorders[t.tp] = (want_leader,) + tuple(
                        b for b in cur.replicas if b != want_leader
                    )
            if reorders:
                self.admin.alter_partition_reassignments(reorders)
                self.waiter(self.poll_interval_ms)
            self.admin.elect_leaders([t.tp for t in batch])
            metadata = self.admin.describe_cluster()
            pidx = {p.tp: p for p in metadata.partitions}
            now = self.clock()
            for t in batch:
                cur = pidx.get(t.tp)
                if cur is not None and cur.leader == t.proposal.new_leader:
                    t.transition(TaskState.COMPLETED, now)
                else:
                    t.transition(TaskState.DEAD, now)
