"""Async orchestration — operation futures, progress, user tasks.

Parity: ``async/{AsyncKafkaCruiseControl,OperationFuture}.java``,
``async/progress/OperationProgress.java`` and ``servlet/UserTaskManager.java``
(SURVEY.md C31/C32): every expensive request runs on a session executor as an
``OperationFuture`` with step-by-step progress; the ``UserTaskManager`` maps
task UUIDs to futures, replays completed responses, and retains a bounded
history surfaced by the ``user_tasks`` endpoint.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time as _time
import uuid as _uuid


class OperationProgress:
    """Ref OperationProgress: ordered steps with timings, readable while the
    operation runs (surfaced via `state?substates=...` and `user_tasks`)."""

    def __init__(self) -> None:
        self._steps: list[dict] = []
        self._lock = threading.Lock()

    def step(self, description: str) -> None:
        with self._lock:
            now = _time.time()
            if self._steps:
                self._steps[-1]["timeToFinishSec"] = round(
                    now - self._steps[-1]["_start"], 6
                )
            self._steps.append({"step": description, "_start": now})

    def done(self) -> None:
        with self._lock:
            if self._steps and "timeToFinishSec" not in self._steps[-1]:
                self._steps[-1]["timeToFinishSec"] = round(
                    _time.time() - self._steps[-1]["_start"], 6
                )

    def to_json(self) -> list[dict]:
        with self._lock:
            return [
                {k: v for k, v in s.items() if not k.startswith("_")}
                for s in self._steps
            ]


class TaskState:
    ACTIVE = "Active"
    IN_EXECUTION = "InExecution"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"
    KILLED = "Killed"


@dataclasses.dataclass
class UserTaskInfo:
    task_id: str
    endpoint: str
    request_url: str
    start_ms: int
    future: concurrent.futures.Future
    progress: OperationProgress
    client_id: str = ""

    @property
    def state(self) -> str:
        if self.future.cancelled():
            return TaskState.KILLED
        if not self.future.done():
            return TaskState.ACTIVE
        return (
            TaskState.COMPLETED_WITH_ERROR
            if self.future.exception() is not None
            else TaskState.COMPLETED
        )

    def to_json(self) -> dict:
        out = {
            "UserTaskId": self.task_id,
            "RequestURL": self.request_url,
            "Endpoint": self.endpoint,
            "ClientIdentity": self.client_id,
            "StartMs": self.start_ms,
            "Status": self.state,
            "Progress": self.progress.to_json(),
        }
        if self.future.done() and self.future.exception() is not None:
            out["ErrorMessage"] = str(self.future.exception())
        return out


class UserTaskManager:
    """Ref UserTaskManager (C32): bounded async session executor + completed
    task retention for response replay."""

    def __init__(self, max_active_tasks: int = 25,
                 completed_retention_ms: int = 86_400_000,
                 max_cached_completed: int = 100, clock=None) -> None:
        self.max_active_tasks = max_active_tasks
        self.completed_retention_ms = completed_retention_ms
        self.max_cached_completed = max_cached_completed
        self.clock = clock or (lambda: int(_time.time() * 1000))
        # +2 headroom over the admission cap: urgent (self-healing)
        # submissions bypass the cap and must get a worker immediately
        # instead of queueing in the pool behind the very dryruns they
        # outrank (the thread-pool twin of the fleet scheduler's
        # priority bypass)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_active_tasks + 2, thread_name_prefix="user-task"
        )
        self._tasks: dict[str, UserTaskInfo] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config, clock=None) -> "UserTaskManager":
        return cls(
            config["max.active.user.tasks"],
            config["completed.user.task.retention.time.ms"],
            config["max.cached.completed.user.tasks"],
            clock=clock,
        )

    def submit(self, endpoint: str, fn, request_url: str = "",
               client_id: str = "", urgent: bool = False) -> UserTaskInfo:
        """Run ``fn(progress)`` async; raises if at the active-task cap.
        ``urgent`` (self-healing verbs — fix_offline_replicas) bypasses
        the cap: an offline-replica fix must never be 503'd because
        dryruns saturated the task table (the executor keeps headroom so
        it also starts immediately)."""
        with self._lock:
            self._expire()
            active = sum(
                1 for t in self._tasks.values() if t.state == TaskState.ACTIVE
            )
            if active >= self.max_active_tasks and not urgent:
                raise RuntimeError(
                    f"There are already {active} active user tasks "
                    f"(max.active.user.tasks={self.max_active_tasks})"
                )
            progress = OperationProgress()
            task_id = str(_uuid.uuid4())

            def run():
                try:
                    return fn(progress)
                finally:
                    progress.done()

            info = UserTaskInfo(
                task_id=task_id,
                endpoint=endpoint,
                request_url=request_url or f"/{endpoint.lower()}",
                start_ms=self.clock(),
                future=self._executor.submit(run),
                progress=progress,
                client_id=client_id,
            )
            self._tasks[task_id] = info
            return info

    def get(self, task_id: str) -> UserTaskInfo | None:
        with self._lock:
            return self._tasks.get(task_id)

    def tasks(self, states: tuple[str, ...] = ()) -> list[UserTaskInfo]:
        with self._lock:
            self._expire()
            ts = sorted(self._tasks.values(), key=lambda t: -t.start_ms)
            if states:
                ts = [t for t in ts if t.state in states]
            return ts

    def _expire(self) -> None:
        now = self.clock()
        completed = [
            t for t in self._tasks.values()
            if t.state != TaskState.ACTIVE
        ]
        completed.sort(key=lambda t: t.start_ms)
        drop = set()
        for t in completed:
            if now - t.start_ms > self.completed_retention_ms:
                drop.add(t.task_id)
        overflow = len(completed) - len(drop) - self.max_cached_completed
        for t in completed:
            if overflow <= 0:
                break
            if t.task_id not in drop:
                drop.add(t.task_id)
                overflow -= 1
        for tid in drop:
            del self._tasks[tid]

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)
