"""Multi-job chunk scheduler — continuous batching for optimization jobs.

The port's copy of the JAX package's ``search/scheduler.py``. Fleet
serving runs many clusters' proposals on one card; the chunk boundary of
``annealer.drive_chunks`` already yields to the host between device chunks,
and this module turns that boundary into a scheduler:

* every optimization job (one sidecar Propose) registers as a
  :class:`JobHandle` with a **cluster id** and an integer **priority**;
* each chunk *dispatch* must win a grant from the run queue; grants go
  highest-priority-first, round-robin (least recently granted) within a
  priority, so N concurrent jobs interleave chunks on the card instead of
  convoying — and an urgent job submitted mid-run dispatches its first
  chunk within ONE chunk boundary of the currently granted dispatch;
* the grant covers only the **dispatch** (the host-side launches of the
  chunk). The chunk's device execution and the stop-flag read happen
  outside the grant, so job B launches its chunk while job A's chunk is
  still executing;
* up to ``dispatch_width`` grants may be outstanding at once (default
  ``DEFAULT_DISPATCH_WIDTH``, 1: strict alternation). The port's chunks
  are launch-bound Python, and two threads launching at once share one
  interpreter lock; the JAX package's default (the host's core count)
  dispatches a compiled chunk per grant instead. Order stays
  priority/round-robin at any width: a granted job leaves the wait set, so
  the next free grant always goes to the least-recently-served
  highest-priority waiter;
* each job carries its own search state, budget and flight-recorder span
  (they live on the job's thread; the scheduler never touches them), so
  one job early-exiting or failing cannot perturb another's;
* ``max_concurrent`` bounds how many jobs may be RESIDENT at once — a
  residency slot is taken at registration and held for the job's whole
  pipeline; excess normal-priority jobs queue at registration and are
  admitted in (priority, arrival) order as residents finish. Jobs with
  priority > 0 BYPASS the cap: an urgent job must preempt at the next
  chunk boundary, never wait for a dryrun slot.

Single-job behavior is exact vs the unscheduled path by construction: the
scheduler only *orders* chunk dispatches, it never changes what a chunk
computes, and with one registered job every grant is immediate.

Importing this module loads neither torch nor the annealer (the JAX
package's ``search/__init__`` imports its annealer; the port's does not).

Thread-safety: one Condition guards the run queue; jobs block in
``chunk`` releasing the GIL. Occupancy accounting integrates the
time-weighted count of jobs inside a chunk drive: ``occupancy`` is the
fraction of the measurement window during which at least one job had
chunk work in flight, measured host-side with no device syncs added.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ccx_torch.common.faults import FAULTS

#: simultaneous chunk-dispatch grants unless configured (module docstring)
DEFAULT_DISPATCH_WIDTH = 1


class JobCancelled(Exception):
    """The job's cancel event fired (client disconnected mid-Propose):
    raised at the next chunk-boundary grant acquisition so the worker
    unwinds, its ``FLEET.job`` context releases the grant and the
    residency slot, and nothing is left on the run queue. Cancellation is
    cooperative and chunk-granular — an in-flight chunk always finishes;
    the NEXT dispatch raises."""

    def __init__(self, job_id: str) -> None:
        super().__init__(f"job {job_id!r} cancelled at chunk boundary")
        self.job_id = job_id


class JobHandle:
    """One registered optimization job. Mutable scheduling fields are
    guarded by the owning scheduler's lock; stats fields are written under
    the same lock and read without it (stale reads acceptable in stats)."""

    __slots__ = (
        "job_id", "priority", "seq", "resident", "waiting", "granted",
        "chunks", "wait_s", "t_registered", "t_first_chunk", "last_grant",
        "drives", "cancel_event", "admit_wait_s",
    )

    def __init__(self, job_id: str, priority: int, seq: int) -> None:
        self.job_id = str(job_id)
        self.priority = int(priority)
        self.seq = seq
        #: holds a device-residency slot (first chunk granted)
        self.resident = False
        self.waiting = False
        self.granted = False
        self.chunks = 0
        self.wait_s = 0.0
        #: seconds the job waited for admission (``register``)
        self.admit_wait_s = 0.0
        self.t_registered = time.monotonic()
        self.t_first_chunk: float | None = None
        #: grant-order stamp for round-robin within a priority
        self.last_grant = -1
        #: nesting depth of drive_chunks loops currently running this job
        self.drives = 0
        #: optional threading.Event a transport sets on client disconnect
        #: (ccx_torch.sidecar.server wires gRPC context.add_callback to it);
        #: checked at every grant acquisition — see JobCancelled
        self.cancel_event: threading.Event | None = None

    def cancelled(self) -> bool:
        ev = self.cancel_event
        return ev is not None and ev.is_set()

    def to_json(self) -> dict:
        return {
            "job": self.job_id,
            "priority": self.priority,
            "chunks": self.chunks,
            "waitSeconds": round(self.wait_s, 4),
            "resident": self.resident,
        }


class ChunkScheduler:
    """Run queue of active optimization jobs, interleaved at chunk
    boundaries (module docstring). One instance per process (:data:`FLEET`)
    is shared by the sidecar's Propose workers."""

    def __init__(self, max_concurrent: int = 0,
                 dispatch_width: int | None = None) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        #: 0 = unlimited device residency
        self.max_concurrent = int(max_concurrent)
        #: simultaneous chunk-dispatch grants (module docstring)
        self.dispatch_width = int(dispatch_width) if dispatch_width else DEFAULT_DISPATCH_WIDTH
        self._jobs: list[JobHandle] = []
        self._granted: set[JobHandle] = set()
        self._seq = 0
        self._grant_seq = 0
        self._tl = threading.local()
        # ---- stats (reset via reset_stats) --------------------------------
        self._t0 = time.monotonic()
        self._chunks = 0
        self._jobs_done = 0
        self._evictions = 0
        #: time-weighted occupancy integration: number of jobs currently
        #: inside a drive_chunks loop, busy seconds with >=1 such job, and
        #: the job-seconds integral (mean multiplexing depth)
        self._in_drive = 0
        self._occ_last = time.monotonic()
        self._occ_busy_s = 0.0
        self._occ_job_s = 0.0

    # ----- registration -----------------------------------------------------

    def register(self, job_id: str, priority: int = 0,
                 cancel_event: threading.Event | None = None) -> JobHandle:
        """Register a job; BLOCKS while the residency cap is reached (the
        admission queue, highest-priority / earliest-arrival first).
        Priority > 0 jobs bypass the cap — preemption must never wait for
        a dryrun slot to free. A set ``cancel_event`` raises
        :class:`JobCancelled` instead of admitting (and at every later
        grant acquisition) — the job leaves no queue entry behind."""
        with self._cond:
            self._seq += 1
            h = JobHandle(job_id, priority, self._seq)
            h.cancel_event = cancel_event
            self._jobs.append(h)
            try:
                if self.max_concurrent <= 0 or h.priority > 0:
                    h.resident = True
                else:
                    while not h.resident:
                        if h.cancelled():
                            raise JobCancelled(h.job_id)
                        free = self.max_concurrent - sum(
                            1 for j in self._jobs if j.resident
                        )
                        queued = sorted(
                            (j for j in self._jobs if not j.resident),
                            key=lambda j: (-j.priority, j.seq),
                        )
                        if free > 0 and h in queued[:free]:
                            h.resident = True
                            break
                        self._cond.wait()
            except JobCancelled:
                # a cancelled admission must free its queue entry HERE —
                # no FLEET.job finally will ever run for it
                self._jobs.remove(h)
                self._cond.notify_all()
                raise
            self._cond.notify_all()
            return h

    def unregister(self, h: JobHandle) -> None:
        with self._cond:
            if h in self._jobs:
                self._jobs.remove(h)
                self._jobs_done += 1
            self._granted.discard(h)
            h.resident = False
            self._cond.notify_all()

    @contextlib.contextmanager
    def job(self, job_id: str, priority: int = 0,
            cancel_event: threading.Event | None = None):
        """Register a job and make it THIS thread's ambient job for the
        duration: every ``drive_chunks`` loop on the thread routes its
        chunk dispatches through the run queue, and the flight recorder
        labels the thread's spans/heartbeats with ``job=<cluster-id>``
        (ccx_torch.common.tracing). Reentrant registration (a nested pipeline
        running under an outer job) keeps the OUTER job — one Propose is
        one job, however many phases it runs. ``cancel_event`` (set by a
        transport on client disconnect, plus :meth:`kick`) cancels the
        job at the next chunk boundary (:class:`JobCancelled`); exit via
        ANY path — completion, cancellation, engine error — unregisters
        the job and frees its grant/residency. The seconds the
        registration waited are the handle's ``admit_wait_s``."""
        outer = getattr(self._tl, "job", None)
        if outer is not None:
            yield outer
            return
        from ccx_torch.common.devmem import DEVMEM
        from ccx_torch.common.tracing import TRACER

        t0 = time.monotonic()
        h = self.register(job_id, priority, cancel_event=cancel_event)
        h.admit_wait_s = time.monotonic() - t0
        # admission hook of the unified device-memory ledger
        # (ccx_torch.common.devmem): the registering job's priority
        # re-prices every device-resident entry carrying this job/session
        # label (its snapshot model, its warm base) — the moment an urgent
        # job is admitted, its residents are protected from lower-priority
        # packing; a later normal-priority registration demotes them back
        # (the last user wins).
        DEVMEM.touch_job(h.job_id, h.priority)
        self._tl.job = h
        prev_label = TRACER.set_job(h.job_id)
        try:
            yield h
        finally:
            TRACER.set_job(prev_label)
            self._tl.job = None
            self.unregister(h)

    def current(self) -> JobHandle | None:
        """The ambient job of the calling thread (None = unscheduled)."""
        return getattr(self._tl, "job", None)

    # ----- chunk grants -----------------------------------------------------

    def _pick(self) -> JobHandle | None:
        """The next grant among waiting jobs: highest priority first,
        least-recently-granted within a priority (strict round-robin),
        registration order as the final tiebreak. (Residency is settled
        at registration — every waiting job here is already admitted.)"""
        best: JobHandle | None = None
        for j in self._jobs:
            if not j.waiting:
                continue
            if best is None or (
                (-j.priority, j.last_grant, j.seq)
                < (-best.priority, best.last_grant, best.seq)
            ):
                best = j
        return best

    def kick(self) -> None:
        """Wake every waiter so it re-checks its cancel event — the one
        call a canceller (another thread: the gRPC disconnect callback)
        must make after setting a job's cancel_event."""
        with self._cond:
            self._cond.notify_all()

    @contextlib.contextmanager
    def chunk(self, h: JobHandle):
        """One chunk dispatch under a grant. Blocks until ``h`` wins the
        run queue; the caller dispatches its chunk program inside the
        ``with`` and must NOT block on device results there (syncs belong
        outside, so the next job can dispatch meanwhile). Raises
        :class:`JobCancelled` when the job's cancel event is set — BEFORE
        dispatching, so "cancel mid-wave" frees the grant within one
        chunk: the in-flight chunk finishes, the next never starts. The
        wait is added to the caller's open span (``grantWaitSeconds``)."""
        from ccx_torch.common.tracing import TRACER

        t0 = time.monotonic()
        with self._cond:
            h.waiting = True
            try:
                while not (
                    len(self._granted) < self.dispatch_width
                    and self._pick() is h
                ):
                    if h.cancelled():
                        raise JobCancelled(h.job_id)
                    self._cond.wait()
                if h.cancelled():
                    raise JobCancelled(h.job_id)
            finally:
                h.waiting = False
            self._granted.add(h)
            self._grant_seq += 1
            h.last_grant = self._grant_seq
            if h.t_first_chunk is None:
                h.t_first_chunk = time.monotonic()
            waited = time.monotonic() - t0
            h.wait_s += waited
            # re-notify after taking the grant: with dispatch_width > 1
            # another waiter may NOW be the _pick() winner for a still-free
            # slot — without this it sleeps until this chunk completes (a
            # lost wakeup that collapses multi-width dispatch to strict
            # alternation)
            self._cond.notify_all()
        TRACER.note_grant_wait(waited)
        try:
            # chaos seam (ccx_torch.common.faults): an injected grant failure
            # exercises the "engine died mid-wave" path — the finally
            # below releases the grant, FLEET.job's exit unregisters, so
            # no fault here can strand a queue entry
            if FAULTS.armed:
                FAULTS.hit("scheduler.grant")
            yield
        finally:
            with self._cond:
                h.chunks += 1
                self._chunks += 1
                self._granted.discard(h)
                self._cond.notify_all()

    # ----- occupancy accounting --------------------------------------------

    def _occ_tick(self, delta: int) -> None:
        now = time.monotonic()
        dt = now - self._occ_last
        if self._in_drive > 0:
            self._occ_busy_s += dt
            self._occ_job_s += dt * self._in_drive
        self._occ_last = now
        self._in_drive += delta

    @contextlib.contextmanager
    def drive(self, h: JobHandle):
        """Marks ``h`` as having chunk work in flight for the duration of
        one drive_chunks loop — the occupancy integrand. Nested drives of
        the same job count once."""
        with self._cond:
            h.drives += 1
            if h.drives == 1:
                self._occ_tick(+1)
        try:
            yield
        finally:
            with self._cond:
                h.drives -= 1
                if h.drives == 0:
                    self._occ_tick(-1)

    # ----- stats ------------------------------------------------------------

    def reset_stats(self) -> None:
        with self._cond:
            now = time.monotonic()
            self._t0 = now
            self._chunks = 0
            self._jobs_done = 0
            self._occ_last = now
            self._occ_busy_s = 0.0
            self._occ_job_s = 0.0

    def stats(self) -> dict:
        """Scheduler window stats: ``occupancy`` = fraction of the window
        with >=1 job's chunks in flight (device-utilization proxy, no
        device sync); ``meanDepth`` = time-weighted mean number of such
        jobs (multiplexing depth; <=1 means serialized)."""
        with self._cond:
            now = time.monotonic()
            window = max(now - self._t0, 1e-9)
            busy = self._occ_busy_s
            job_s = self._occ_job_s
            if self._in_drive > 0:
                dt = now - self._occ_last
                busy += dt
                job_s += dt * self._in_drive
            return {
                "activeJobs": [j.to_json() for j in self._jobs],
                "maxConcurrent": self.max_concurrent,
                "dispatchWidth": self.dispatch_width,
                "windowSeconds": round(window, 3),
                "chunksGranted": self._chunks,
                "jobsCompleted": self._jobs_done,
                "occupancy": round(min(busy / window, 1.0), 4),
                "meanDepth": round(job_s / window, 3),
            }


#: the process-wide fleet scheduler — the sidecar's Propose workers share
#: one run queue (like the one TRACER / one MetricRegistry)
FLEET = ChunkScheduler()


def configure(max_concurrent: int | None = None,
              dispatch_width: int | None = None) -> None:
    """Bound device residency and simultaneous dispatch grants for
    :data:`FLEET`. None keeps the current value; dispatch_width 0 restores
    ``DEFAULT_DISPATCH_WIDTH``."""
    if max_concurrent is not None:
        FLEET.max_concurrent = max(int(max_concurrent), 0)
    if dispatch_width is not None:
        FLEET.dispatch_width = int(dispatch_width) if dispatch_width > 0 else DEFAULT_DISPATCH_WIDTH
