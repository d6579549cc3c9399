"""Flight-recorder tracing — structured spans, chunk heartbeats, host
syncs, stall watchdog.

The port's copy of the JAX package's ``common/tracing.py``, grown into the
port's one measurement system:

**Spans.** ``TRACER.span(name, kind=..., **attrs)`` wraps a code region:
wall time and caller-supplied shape/config attributes. Spans nest per
thread; a completed root span's tree is exported as ``OptimizerResult.
span_tree`` (and with it the sidecar result) and as per-phase/per-RPC
Prometheus histograms in ``ccx_torch.common.metrics``. Timing is host
wall-clock by default; with ``sync`` on (``CCX_TRACE_SYNC=1``) every span
close that names a CUDA ``device`` first drains it
(``ccx_torch.device.synchronize``), trading the launch queue's overlap for
device-honest per-phase walls. A failing synchronize raises: a lost device
must not be read as a fast phase.

**Ids and the clock.** Every span has a ``spanId`` and its parent's
``parentId``, and carries its request's ``requestId``: a root takes it
from ``request_id=`` or from the link its thread adopted
(``TRACER.link()`` on the launching thread, ``TRACER.adopt(link)`` on the
worker: a request crosses threads explicitly, never by thread-local
nesting); a child takes its parent's. Every span stamps ``startNs`` and
``endNs``, integer nanoseconds of ``CLOCK_REALTIME`` (``time.time_ns``):
the clock ``torch.profiler`` stamps its host events with (kineto converts
its approximate clock to Unix time), so a span window and a profiler's
events share one timeline. The millisecond ``startedAt`` stays. While a
profiler is recording, every span that is not an aggregate also opens a
``torch.profiler.record_function`` range ``ccx:<name>``, so a capture
(``ccx_torch.common.profiling.trace``) shows the spans on its timeline.

**Aggregate spans.** ``TRACER.step(name)`` wraps one iteration of a hot
loop (an SA step, a descent iteration). Repeats under one parent roll up
into ONE node with ``calls`` and the summed wall, syncs and waits, so the
tree keeps its size however many iterations run. A span opened inside an
aggregate rolls up the same way. An aggregate takes no compile or cost
snapshot and has no ``kind`` (no histogram), sends no record to
listeners, and writes one ``step`` line to the recorder only while it is
armed, so a killed loop's last line names its iteration.

**Host syncs.** Every host read of device data on the search's path, and
every blocking copy of a host constant to the device (on a card it waits
for the queue like a read), runs under ``with TRACER.blocked():``, which
counts it and times how long the host blocked in it, on the innermost open
span: ``syncs`` and ``syncWaitSeconds``, rendered with ``self`` and
``total`` (the subtree's sum). A block counts one site's execution, which
may drain the queue more than once (a ``bincount`` sizes its output from
the data); ``tools/torch_trace_audit.py`` holds the counts against
torch's own report (``torch.cuda.set_sync_debug_mode``). ``note_grant_wait`` adds the seconds a fleet job waited in the
scheduler's queues (``grantWaitSeconds``, the same form).

**Flight recorder.** ``arm(path)`` (or env ``CCX_FLIGHT_RECORDER``) streams
every span start/end, every chunk heartbeat (one record per
``drive_chunks`` chunk — phase, chunk index, energy), every aggregate
entry, and watchdog dumps to a JSONL file. Crash-safe by construction:
each record is ONE ``os.write`` to an ``O_APPEND`` fd — atomic for regular
files, and OS-buffered data survives SIGKILL — so a killed run leaves a
file whose last line names the exact phase, chunk and step at death. Parse
it with ``python -m ccx_torch.common.tracing <file>``.

**Stall watchdog.** With ``CCX_WATCHDOG_SECONDS`` > 0 (or
``set_watchdog``) a daemon thread watches the event stream; when no span
event or heartbeat arrives for that long while spans are active, it dumps
all-thread stacks and the active span stacks into the recorder (and
stderr) — one dump per stall episode, re-armed by the next heartbeat.

Every span also carries the kernel builds that ran inside it (a
``compile`` block, ``ccx_torch.common.compilestats`` deltas) and the cost
rollup of the instrumented calls it made (a ``costModel`` block,
``ccx_torch.common.costmodel``: projected device seconds on its device and
the captured allocator peak), computed when the span is rendered, so a
cold run's spans pick up the records its ``cost-capture`` phase banks
after they closed.

Overhead contract: spans, aggregates, heartbeats and the sync helper are
host-side only. With the recorder unarmed and no profiler recording, they
make no profiler call, write no recorder line and touch no tensor (unless
``sync`` is on): a span is a few clock reads and list operations, an
aggregate entry or a sync count a microsecond or two.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
import traceback

from ccx_torch.common import compilestats, costmodel

#: recorder schema version, stamped on every ``arm`` header record
RECORDER_VERSION = 1

#: env knobs (the config keys ``observability.*`` take precedence when a
#: facade is constructed; env covers bench/tools/subprocess paths)
ENV_RECORDER = "CCX_FLIGHT_RECORDER"
ENV_WATCHDOG = "CCX_WATCHDOG_SECONDS"
ENV_SYNC = "CCX_TRACE_SYNC"


#: span ids, process-wide (``next`` on a count is atomic under the GIL)
_IDS = itertools.count(1)

#: the counters a span keeps, by rendered name
_COUNTERS = ("syncs", "syncWaitSeconds", "grantWaitSeconds")


def new_request_id() -> str:
    """A fresh request id: 16 hex digits."""
    return os.urandom(8).hex()


def _profiler_recording() -> bool:
    """Whether a ``torch.profiler`` capture is recording, read from torch's
    own flag without a profiler call (False until torch's profiler module
    is loaded)."""
    mod = sys.modules.get("torch.autograd.profiler")
    return bool(mod is not None and getattr(mod, "_is_profiler_enabled", False))


def _range_enter(name: str):
    """Open a ``record_function`` range for a span (a profiler records)."""
    import torch

    rf = torch.autograd.profiler.record_function("ccx:" + name)
    rf.__enter__()
    return rf


class Span:
    """One traced region, or with ``aggregate`` the roll-up of every
    repeat of one loop iteration under its parent. Mutable fields are
    written by the owning thread only; the watchdog reads paths/attrs
    without a lock (stale reads are acceptable in a stall dump)."""

    __slots__ = (
        "name", "kind", "path", "attrs", "children", "t_wall",
        "t0", "wall_s", "compile0", "compile", "cost0", "cost_delta", "device", "done",
        "span_id", "parent_id", "request_id", "start_ns", "end_ns", "aggregate", "calls",
        "agg", "agg_ns", "enter_ns", "syncs", "sync_ns", "grant_ns", "rf", "stack",
    )

    def __init__(self, name: str, kind: str | None, path: str,
                 attrs: dict, compile0: dict | None, device=None,
                 parent: "Span | None" = None, request_id: str | None = None,
                 parent_id: int | None = None, aggregate: bool = False) -> None:
        self.name = name
        self.kind = kind
        self.path = path
        self.attrs = attrs
        self.children: list[Span] = []
        self.span_id = next(_IDS)
        self.parent_id = parent.span_id if parent is not None else parent_id
        self.request_id = parent.request_id if parent is not None else request_id
        self.start_ns = time.time_ns()
        self.end_ns: int | None = None
        self.t_wall = self.start_ns / 1e9
        self.t0 = time.monotonic()
        self.wall_s: float | None = None
        self.compile0 = compile0
        self.compile: dict | None = None
        self.cost0 = None if aggregate else costmodel.exec_snapshot()
        self.cost_delta: dict | None = None
        #: the device a ``sync`` close drains (None: host-only span)
        self.device = device
        self.done = False
        self.aggregate = aggregate
        #: aggregates: entries, summed ns, the open entry's start, and each
        #: aggregate child by name
        self.calls = 0
        self.agg_ns = 0
        self.enter_ns = 0
        self.agg: dict[str, Span] | None = None
        self.syncs = 0
        self.sync_ns = 0
        self.grant_ns = 0
        #: the open ``record_function`` range (a profiler recorded at start)
        self.rf = None
        #: the owning thread's span stack
        self.stack: list[Span] | None = None

    def add_counts(self, **counts) -> None:
        """Add ``counts`` to the attrs, summed with what earlier calls left
        there (a phase that runs one loop several times reads the totals)."""
        for key, v in counts.items():
            total = self.attrs.get(key, 0) + v
            self.attrs[key] = round(total, 6) if isinstance(total, float) else total

    def counters(self) -> tuple[int, float, float]:
        """(syncs, sync wait s, grant wait s) of this span alone."""
        return self.syncs, self.sync_ns / 1e9, self.grant_ns / 1e9

    def to_json(self) -> dict:
        out: dict = {"name": self.name, "startedAt": round(self.t_wall, 3)}
        if self.kind:
            out["kind"] = self.kind
        out["spanId"] = self.span_id
        if self.parent_id is not None:
            out["parentId"] = self.parent_id
        if self.request_id is not None:
            out["requestId"] = self.request_id
        if self.aggregate:
            out["calls"] = self.calls
        if self.wall_s is not None:
            out["wallSeconds"] = round(self.wall_s, 4)
        out["startNs"] = self.start_ns
        if self.end_ns is not None:
            out["endNs"] = self.end_ns
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.compile:
            out["compile"] = self.compile
        cost = _cost_compact(self.cost_delta, self.device)
        if cost:
            # the projected device seconds and allocator peak of the
            # instrumented calls this span made
            out["costModel"] = cost
        children = [c.to_json() for c in self.children]
        own = self.counters()
        for i, key in enumerate(_COUNTERS):
            total = own[i] + sum(c.get(key, {}).get("total", 0) for c in children)
            if total:
                out[key] = ({"self": own[i], "total": total} if i == 0 else
                            {"self": round(own[i], 6), "total": round(total, 6)})
        if children:
            out["children"] = children
        return out


def _compile_snapshot() -> dict:
    """Live kernel-build counters (``compilestats``)."""
    return compilestats.snapshot()


def _compile_delta(before: dict | None) -> dict | None:
    """The builds since ``before``; None when nothing was built."""
    if before is None:
        return None
    d = compilestats.delta(before, compilestats.snapshot())
    return d if any(d.values()) else None


def _cost_exec_delta(before: dict | None) -> dict | None:
    return None if before is None else costmodel.exec_delta(before) or None


def _cost_compact(delta: dict | None, device=None) -> dict | None:
    """A span's cost rollup, rendered lazily (see the module docstring)."""
    return costmodel.projection_compact(delta, device) if delta else None


class Tracer:
    def __init__(self) -> None:
        self._tl = threading.local()
        self._lock = threading.Lock()
        #: thread ident -> that thread's live span stack (for the watchdog
        #: and the REST observability view)
        self._stacks: dict[int, list[Span]] = {}
        self._fd: int | None = None
        self._path: str | None = None
        self._records = 0
        self.sync = False
        self._last_event = time.monotonic()
        #: per-thread last event time (GIL-atomic dict writes): stall
        #: detection must be per thread, or a healthy Ping span every 60 s
        #: would mask a Propose worker wedged in a 17-minute compile
        self._thread_last: dict[int, float] = {}
        #: threads already dumped for the CURRENT stall episode
        self._stalled_dumped: set[int] = set()
        self._watchdog_s = 0.0
        self._watchdog_stop: threading.Event | None = None
        self._watchdog_thread: threading.Thread | None = None
        self._watchdog_dumps = 0
        self._last_root: dict | None = None
        self._env_checked = False
        #: live record taps (the sidecar's Propose stream relays heartbeats
        #: to the client through one) — called with each record dict
        self._listeners: list = []
        #: per-job convergence timeline: the last N heartbeat
        #: energies per job label ("" = no fleet job), LRU-bounded so a
        #: long fleet run cannot grow it without bound. Feeds the
        #: observability block's per-job section.
        self._energy: collections.OrderedDict = collections.OrderedDict()

    # ----- configuration ----------------------------------------------------

    def _maybe_env(self) -> None:
        """One-shot env arming: lets any proposal path leave a recording
        without code — export CCX_FLIGHT_RECORDER and the first span arms
        it."""
        if self._env_checked:
            return
        self._env_checked = True
        if os.environ.get(ENV_SYNC) == "1":
            self.sync = True
        wd = os.environ.get(ENV_WATCHDOG)
        if wd:
            try:
                self.set_watchdog(float(wd))
            except ValueError:
                pass
        path = os.environ.get(ENV_RECORDER)
        if path and self._fd is None:
            try:
                self.arm(path)
            except OSError:
                pass

    def configure(self, sync: bool | None = None,
                  watchdog_seconds: float | None = None,
                  path: str | None = None) -> None:
        """Config-driven setup (facade construction). ``path``/knobs left
        None keep their current (possibly env-armed) values."""
        self._maybe_env()
        if sync is not None:
            self.sync = bool(sync)
        if watchdog_seconds is not None:
            self.set_watchdog(float(watchdog_seconds))
        if path:
            self.arm(path)

    def arm(self, path: str) -> None:
        """Open (append) the flight-recorder file and write the header
        record. Re-arming on the same path is a no-op; a new path closes
        the old recorder first."""
        with self._lock:
            if self._fd is not None and self._path == path:
                return
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
            self._fd = os.open(
                path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
            )
            self._path = path
            self._records = 0
        self._record({
            "ev": "arm", "v": RECORDER_VERSION, "pid": os.getpid(),
            "argv": sys.argv[:4],
        })

    def disarm(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
            self._fd = None
            self._path = None

    def set_watchdog(self, seconds: float) -> None:
        """(Re)arm the stall watchdog; 0 stops it."""
        self._watchdog_s = max(float(seconds), 0.0)
        if self._watchdog_s <= 0:
            if self._watchdog_stop is not None:
                self._watchdog_stop.set()
                self._watchdog_thread = None
                self._watchdog_stop = None
            return
        if self._watchdog_thread is None or not self._watchdog_thread.is_alive():
            self._watchdog_stop = threading.Event()
            self._watchdog_thread = threading.Thread(
                target=self._watch, name="ccx-stall-watchdog", daemon=True
            )
            self._watchdog_thread.start()

    # ----- per-job labels (fleet serving) -----------------------------------

    def set_job(self, job_id: str | None) -> str | None:
        """Set this thread's job label (the fleet scheduler's cluster id —
        ccx_torch.search.scheduler): every span record, chunk heartbeat and span
        histogram the thread emits while set carries ``job=<cluster-id>``,
        so an interleaved multi-job trace is attributable per job instead
        of landing on one anonymous phase span. Returns the previous label
        (restore it when the job ends)."""
        prev = getattr(self._tl, "job", None)
        self._tl.job = job_id
        return prev

    def job(self) -> str | None:
        return getattr(self._tl, "job", None)

    # ----- spans ------------------------------------------------------------

    def _stack(self) -> list[Span]:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
            with self._lock:
                self._stacks[threading.get_ident()] = st
        return st

    def start(self, name: str, kind: str | None = None, device=None, *,
              request_id: str | None = None, **attrs) -> Span:
        """Open a span on this thread. ``device`` (a ``torch.device``) is
        what a ``sync`` close drains; it is not an attribute.
        ``request_id`` names the request a root span serves (a child
        carries its parent's); a root opened under ``adopt(link)`` takes
        the link's request and parent. Under an aggregate the span rolls
        up into its parent like one (module docstring)."""
        self._maybe_env()
        st = self._stack()
        parent = st[-1] if st else None
        if parent is not None and parent.aggregate:
            return self._enter_aggregate(st, parent, name)
        parent_id = None
        if parent is None:
            link = getattr(self._tl, "link", None)
            if link is not None:
                request_id = request_id or link[0]
                parent_id = link[1]
        path = (parent.path + "/" + name) if parent is not None else name
        job = self.job()
        if job is not None and "job" not in attrs:
            # per-job attribution (fleet serving): the span tree and every
            # recorder line under it name which cluster's job this is
            attrs = {"job": job, **attrs}
        s = Span(name, kind, path, attrs, _compile_snapshot(), device,
                 parent=parent, request_id=request_id, parent_id=parent_id)
        s.stack = st
        if parent is not None:
            parent.children.append(s)
        st.append(s)
        self._record({
            "ev": "start", "span": path, "spanId": s.span_id,
            **({"parentId": s.parent_id} if s.parent_id is not None else {}),
            **({"requestId": s.request_id} if s.request_id is not None else {}),
            **({"kind": kind} if kind else {}),
            **({"attrs": attrs} if attrs else {}),
        })
        if _profiler_recording():
            s.rf = _range_enter(name)
        return s

    def end(self, span: Span) -> None:
        """Close a span. With ``sync`` on, its device is drained first (a
        counted host sync); a failing synchronize still closes the span,
        then propagates."""
        if span.done:
            return
        if span.aggregate:
            self._exit_aggregate(span)
            return
        try:
            if self.sync and getattr(span.device, "type", None) == "cuda":
                from ccx_torch.device import synchronize

                with self.blocked():
                    synchronize(span.device)
        finally:
            self._close(span)

    @staticmethod
    def _finish(span: Span) -> None:
        """Close a span's profiler range, then stamp its end (an aggregate:
        add this entry), so the range lies inside the span's window."""
        if span.rf is not None:
            rf, span.rf = span.rf, None
            rf.__exit__(None, None, None)
        now = time.time_ns()
        span.end_ns = now
        if span.aggregate:
            span.agg_ns += now - span.enter_ns
            span.wall_s = span.agg_ns / 1e9
        else:
            span.wall_s = time.monotonic() - span.t0
        span.done = True

    def _close(self, span: Span) -> None:
        st = span.stack
        root_closed = False
        if st is not None and span in st:
            # pop through to this span — an unwound exception may leave
            # unclosed children above it; close them with honest walls
            while st and st[-1] is not span:
                inner = st.pop()
                if not inner.done:
                    self._finish(inner)
            if st and st[-1] is span:
                st.pop()
            root_closed = not st
        self._finish(span)
        span.compile = _compile_delta(span.compile0)
        span.cost_delta = _cost_exec_delta(span.cost0)
        cost = _cost_compact(span.cost_delta, span.device)
        syncs, sync_s, grant_s = span.counters()
        self._record({
            "ev": "end", "span": span.path, "spanId": span.span_id,
            **({"requestId": span.request_id} if span.request_id is not None else {}),
            "wall_s": round(span.wall_s, 4),
            **({"syncs": syncs, "syncWaitSeconds": round(sync_s, 6)} if syncs else {}),
            **({"grantWaitSeconds": round(grant_s, 6)} if grant_s else {}),
            **({"compile": span.compile} if span.compile else {}),
            # a later stall in the same phase reads its expected cost off
            # this record (summarize() joins them)
            **({"cost": cost} if cost else {}),
        })
        if root_closed:
            # root closed: bank the tree and deregister the owning
            # thread's stack — the sidecar spawns a worker thread per
            # Propose, so keeping dead-thread entries would grow the
            # registry (and every watchdog/REST scan of it) without bound.
            # The next span on this thread re-registers via _stack(). Must
            # run AFTER the end record above — _record re-stamps this
            # thread's liveness entry, which would undo the pop.
            tid = threading.get_ident()
            if getattr(self._tl, "stack", None) is st:
                self._tl.stack = None
            with self._lock:
                self._last_root = span.to_json()
                if self._stacks.get(tid) is st:
                    self._stacks.pop(tid, None)
            self._thread_last.pop(tid, None)
        if span.kind:
            # bucketed per-phase / per-RPC / per-verb latency — the
            # Prometheus face of the span stream. Spans closed under a
            # fleet job get a ``job=<cluster-id>`` label series so an
            # interleaved trace's histograms attribute per cluster.
            from ccx_torch.common.metrics import REGISTRY

            job = self.job()
            REGISTRY.histogram(
                f"{span.kind}-{span.name}-seconds",
                help=f"ccx {span.kind} '{span.name}' wall seconds (span close)",
                labels={"job": job} if job is not None else None,
            ).observe(span.wall_s)

    @contextlib.contextmanager
    def span(self, name: str, kind: str | None = None, **attrs):
        s = self.start(name, kind=kind, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    # ----- aggregate spans ----------------------------------------------------

    def step(self, name: str) -> "_Step":
        """``with TRACER.step(name):`` — one iteration of a hot loop, rolled
        up under the innermost open span (module docstring). Outside any
        span it does nothing."""
        return _Step(self, name)

    def _enter_aggregate(self, st: list[Span], parent: Span, name: str) -> Span:
        agg = parent.agg
        if agg is None:
            agg = parent.agg = {}
        node = agg.get(name)
        if node is None:
            node = Span(name, None, parent.path + "/" + name, {}, None,
                        parent=parent, aggregate=True)
            node.stack = st
            agg[name] = node
            parent.children.append(node)
        node.calls += 1
        node.done = False
        node.enter_ns = time.time_ns()
        st.append(node)
        if self._fd is not None:
            # armed: one line per entry, to the file only, so a killed
            # loop's last line names its iteration
            self._record({"ev": "step", "span": node.path, "call": node.calls},
                         listeners=False)
        return node

    def _exit_aggregate(self, node: Span) -> None:
        st = node.stack
        while st and st[-1] is not node:
            inner = st.pop()
            if not inner.done:
                self._finish(inner)
        if st:
            st.pop()
        self._finish(node)

    # ----- host syncs and queue waits -----------------------------------------

    def blocked(self) -> "_Blocked":
        """``with TRACER.blocked(): value = t.tolist()`` — a host read of
        device data, or a blocking copy to the device: counted and timed on
        the innermost open span (``syncs``, ``syncWaitSeconds``). Blocks
        nest: each counts, and the outermost times the wait."""
        return _Blocked(self._tl)

    def numpy(self, t):
        """``t.cpu().numpy()`` as one counted host read (``blocked``)."""
        with self.blocked():
            return t.cpu().numpy()

    def in_sync(self) -> bool:
        """Whether this thread is inside ``blocked()`` (the sync audit
        tells counted syncs from unrouted ones by it)."""
        return getattr(self._tl, "blocking", 0) > 0

    def note_grant_wait(self, seconds: float) -> None:
        """Add ``seconds`` a fleet job waited in the scheduler's queues to
        the innermost open span (``grantWaitSeconds``)."""
        st = getattr(self._tl, "stack", None)
        if st:
            st[-1].grant_ns += int(seconds * 1e9)

    def add_counts(self, **counts) -> None:
        """``Span.add_counts`` on the innermost open span. Outside any span
        it does nothing."""
        st = getattr(self._tl, "stack", None)
        if st:
            st[-1].add_counts(**counts)

    def set_attrs(self, **attrs) -> None:
        """Set ``attrs`` on the innermost open span (a later call
        overwrites). Outside any span it does nothing."""
        st = getattr(self._tl, "stack", None)
        if st:
            st[-1].attrs.update(attrs)

    # ----- requests across threads ----------------------------------------------

    def link(self) -> tuple[str | None, int] | None:
        """(request id, span id) of this thread's innermost open span, for
        a worker thread to ``adopt``; None with no span open."""
        st = getattr(self._tl, "stack", None)
        if not st:
            return None
        return st[-1].request_id, st[-1].span_id

    def set_request(self, request_id: str) -> None:
        """Name the request this thread's open spans serve, where the id
        arrives inside the request's own payload: the open spans that
        carry none take it, and every span opened after inherits it."""
        for s in getattr(self._tl, "stack", None) or ():
            if s.request_id is None:
                s.request_id = request_id

    @contextlib.contextmanager
    def adopt(self, link: tuple[str | None, int] | None):
        """Roots opened on this thread inside the block carry ``link``'s
        request id and name its span as their parent."""
        prev = getattr(self._tl, "link", None)
        self._tl.link = link
        try:
            yield
        finally:
            self._tl.link = prev

    def heartbeat(self, chunk: int, offset: int | None = None,
                  total: int | None = None,
                  energy: float | None = None) -> None:
        """One record per host↔device chunk sync point (``annealer.
        drive_chunks``). Unarmed cost: two attr writes + a timestamp.

        ``energy`` (the convergence taps' tier-0 lex cost,
        possibly one chunk stale on sync-free SA drives) joins the span
        attrs, the recorder line, the per-job convergence timeline and
        the live ``convergence-energy`` Prometheus gauge — a wedged
        window's last JSONL line then names phase + chunk + QUALITY, not
        just depth."""
        st = getattr(self._tl, "stack", None)
        span = st[-1] if st else None
        if span is not None:
            span.attrs["chunk"] = int(chunk)
            if total is not None:
                span.attrs["chunkTotal"] = int(total)
            if energy is not None:
                span.attrs["energy"] = round(float(energy), 4)
        if energy is not None:
            self._note_energy(
                energy, chunk, span.path if span is not None else None
            )
        if self._fd is None and not self._listeners:
            now = time.monotonic()
            tid = threading.get_ident()
            self._last_event = now
            self._thread_last[tid] = now
            self._stalled_dumped.discard(tid)
            return
        rec = {"ev": "chunk", "chunk": int(chunk)}
        if span is not None:
            rec["span"] = span.path
        if offset is not None:
            rec["offset"] = int(offset)
        if total is not None:
            rec["total"] = int(total)
        if energy is not None:
            rec["energy"] = round(float(energy), 4)
        snap = _compile_snapshot()
        if snap is not None:
            rec["compile"] = snap
        self._record(rec)

    # ----- convergence timeline --------------------------------------------

    #: heartbeat energies retained per job / jobs retained (LRU)
    ENERGY_WINDOW = 64
    ENERGY_JOBS = 32

    def _note_energy(self, energy: float, chunk: int,
                     span: str | None) -> None:
        job = self.job() or ""
        entry = {"chunk": int(chunk), "energy": round(float(energy), 4)}
        if span is not None:
            entry["span"] = span
        with self._lock:
            dq = self._energy.get(job)
            if dq is None:
                dq = self._energy[job] = collections.deque(
                    maxlen=self.ENERGY_WINDOW
                )
            dq.append(entry)
            self._energy.move_to_end(job)
            while len(self._energy) > self.ENERGY_JOBS:
                self._energy.popitem(last=False)
        from ccx_torch.common.metrics import REGISTRY

        REGISTRY.set_gauge(
            "convergence-energy", float(energy),
            labels={"job": job} if job else None,
            help="tier-0 lex energy at the last chunk heartbeat "
                 "(convergence taps, per fleet job)",
        )

    def healing_event(self, phase: str, **attrs) -> None:
        """One structured healing-timeline record: ``phase`` is detected /
        fired / recovered / forecast / fire-failed, attrs carry cluster,
        family, cause, verb and the episode id. Rides the same JSONL stream
        as spans and heartbeats, so a dead run's recording still names the
        episode in progress."""
        if self._fd is None and not self._listeners:
            return
        self._record({"ev": "healing", "phase": str(phase), **attrs})

    def convergence_summary(self) -> dict:
        """VIEWER-safe compact form: last energy + chunk per job, no
        series, no span stacks."""
        with self._lock:
            return {
                job: {**dq[-1], "beats": len(dq)}
                for job, dq in self._energy.items()
                if dq
            }

    def convergence_timeline(self) -> dict:
        """Per-job heartbeat-energy series (last ENERGY_WINDOW chunks per
        job) — the /observability convergence section."""
        with self._lock:
            return {job: list(dq) for job, dq in self._energy.items()}

    # ----- recorder ---------------------------------------------------------

    def add_listener(self, fn) -> None:
        """Tap the record stream (every span start/end, heartbeat, watchdog
        dump — armed or not). Used by the sidecar to relay heartbeats as
        Propose progress frames. ``fn(rec)`` must be fast and non-raising;
        exceptions are swallowed."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _record(self, rec: dict, event: bool = True, listeners: bool = True) -> None:
        # watchdog dumps pass event=False: the dump's own write must not
        # count as liveness, or one stall would re-arm the watchdog into
        # dumping every interval instead of once per episode; aggregate
        # entries pass listeners=False: they reach the file only
        if event:
            now = time.monotonic()
            tid = threading.get_ident()
            self._last_event = now
            self._thread_last[tid] = now
            # a live event re-arms this thread's stall episode HERE, not
            # just in the watchdog poll: a thread that recovers and exits
            # within one poll interval must not leave its (recyclable)
            # ident marked already-dumped forever
            self._stalled_dumped.discard(tid)
        job = self.job()
        if job is not None and "job" not in rec:
            rec = {"job": job, **rec}
        rec = {"t": round(time.time(), 3), "tid": threading.get_ident(), **rec}
        for fn in (list(self._listeners) if listeners else ()):
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — a tap must not break tracing
                pass
        fd = self._fd
        if fd is None:
            return
        try:
            line = json.dumps(rec, default=str) + "\n"
        except (TypeError, ValueError):
            line = json.dumps({"t": rec.get("t"), "ev": "unserializable"}) + "\n"
        try:
            # ONE os.write on an O_APPEND fd: atomic for regular files, and
            # already in the page cache when a SIGKILL lands — the crash
            # contract the kill-test pins
            os.write(fd, line.encode())
            with self._lock:
                self._records += 1
        except OSError:
            pass

    # ----- watchdog ---------------------------------------------------------

    def _active(self) -> dict[int, list[dict]]:
        out: dict[int, list[dict]] = {}
        with self._lock:
            stacks = dict(self._stacks)
        for tid, st in stacks.items():
            entries = []
            for s in list(st):
                # attrs are mutated lock-free by the owning thread (a
                # heartbeat's first insertion resizes the dict); a racing
                # copy may raise — retry once, then settle for the path
                for _ in range(2):
                    try:
                        attrs = dict(s.attrs)
                        break
                    except RuntimeError:
                        attrs = {}
                entries.append(
                    {"span": s.path, **({"attrs": attrs} if attrs else {})}
                )
            if entries:
                out[tid] = entries
        return out

    def _watch(self) -> None:
        stop = self._watchdog_stop
        while stop is not None and not stop.wait(
            min(max(self._watchdog_s / 4.0, 0.05), 1.0)
        ):
            if self._watchdog_s <= 0:
                return
            try:
                # per-thread stall detection: a thread is stalled when ITS
                # last event is old — global liveness would let a healthy
                # Ping span every minute mask a Propose worker wedged in a
                # 17-minute compile (the exact failure this exists for).
                # One dump per thread per stall episode; a thread's next
                # event clears it for re-arming.
                now = time.monotonic()
                active = self._active()
                stalled = {}
                for tid in active:
                    idle = now - self._thread_last.get(
                        tid, self._last_event
                    )
                    if idle >= self._watchdog_s:
                        stalled[tid] = idle
                    else:
                        self._stalled_dumped.discard(tid)
                fresh = {
                    tid: idle for tid, idle in stalled.items()
                    if tid not in self._stalled_dumped
                }
                if not fresh:
                    continue
                self._stalled_dumped.update(fresh)
                self._dump_stall(
                    max(fresh.values()),
                    {tid: active[tid] for tid in stalled},
                )
            except Exception:  # noqa: BLE001 — the watchdog thread must
                # survive anything (an escaped exception would silently
                # kill stall detection for the rest of the process)
                pass

    @staticmethod
    def _thread_stacks() -> dict[str, list[str]]:
        """All-thread stack dump, trimmed to the innermost 12 frames —
        shared by watchdog stall dumps and the REST threads=true view."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        return {
            f"{names.get(tid, '?')}:{tid}": [
                ln.rstrip() for ln in traceback.format_stack(frame)[-12:]
            ]
            for tid, frame in frames.items()
        }

    def _dump_stall(self, idle_s: float, stalled: dict) -> None:
        threads = self._thread_stacks()
        rec = {
            "ev": "watchdog", "stalled_s": round(idle_s, 1),
            "spans": {str(k): v for k, v in stalled.items()},
            "threads": threads,
        }
        with self._lock:
            self._watchdog_dumps += 1
        self._record(rec, event=False)
        print(
            f"[ccx-watchdog] no span event for {idle_s:.0f}s; stalled "
            "spans: "
            + "; ".join(
                s[-1]["span"] for s in stalled.values()
            ),
            file=sys.stderr, flush=True,
        )

    # ----- export -----------------------------------------------------------

    def last_tree(self) -> dict | None:
        """Most recent completed ROOT span tree (any thread)."""
        with self._lock:
            return self._last_root

    def recorder_state(self) -> dict:
        with self._lock:
            return {
                "armed": self._fd is not None,
                "path": self._path,
                "records": self._records,
            }

    def observability_summary(self) -> dict:
        """VIEWER-safe subset for ``AnalyzerState.observability``: arming /
        watchdog / sync state plus the last completed span tree, WITHOUT
        the recorder's file path or live span/thread stacks — those are
        USER-gated on the /observability endpoint."""
        state = self.recorder_state()
        return {
            "flightRecorder": {
                "armed": state["armed"], "records": state["records"],
            },
            "watchdogSeconds": self._watchdog_s,
            "watchdogDumps": self._watchdog_dumps,
            "traceSync": self.sync,
            "lastSpanTree": self.last_tree(),
            "convergence": self.convergence_summary(),
        }

    def observability_json(self, threads: bool = False) -> dict:
        """The observability block: recorder + watchdog state, live span
        stacks, the last completed span tree, live compile counters —
        everything an operator needs to see INTO a wedged run."""
        out = {
            "flightRecorder": self.recorder_state(),
            "watchdogSeconds": self._watchdog_s,
            "watchdogDumps": self._watchdog_dumps,
            "traceSync": self.sync,
            "activeSpans": {
                str(k): v for k, v in self._active().items()
            },
            "lastSpanTree": self.last_tree(),
            # per-job convergence timeline: the last N chunk
            # heartbeat energies per active job — live quality trajectory
            # of every in-flight proposal, readable DURING a wedge
            "convergence": self.convergence_timeline(),
        }
        out["compile"] = compilestats.snapshot()
        out["compileAttribution"] = compilestats.attribution()
        # the cost observatory's ledger: captured records, call counts and
        # the live card's roofline spec
        out["costModel"] = costmodel.summary()
        if threads:
            out["threads"] = self._thread_stacks()
        return out


class _Step:
    """The context manager of ``Tracer.step``."""

    __slots__ = ("tracer", "name", "node")

    def __init__(self, tracer: Tracer, name: str) -> None:
        self.tracer = tracer
        self.name = name
        self.node = None

    def __enter__(self):
        st = getattr(self.tracer._tl, "stack", None)
        if st:
            self.node = self.tracer._enter_aggregate(st, st[-1], self.name)
        return self.node

    def __exit__(self, *exc) -> bool:
        if self.node is not None:
            self.tracer._exit_aggregate(self.node)
        return False


class _Blocked:
    """The context manager of ``Tracer.blocked``."""

    __slots__ = ("tl", "t0")

    def __init__(self, tl) -> None:
        self.tl = tl

    def __enter__(self):
        tl = self.tl
        tl.blocking = getattr(tl, "blocking", 0) + 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        tl = self.tl
        tl.blocking -= 1
        st = getattr(tl, "stack", None)
        if st:
            span = st[-1]
            span.syncs += 1
            if not tl.blocking:
                # a nested read's wait is inside the outer one's
                span.sync_ns += dt
        return False


#: the process-wide tracer (one flight recorder per process, like the one
#: MetricRegistry — sidecar worker threads and the facade share it)
TRACER = Tracer()


def summarize(path: str) -> dict:
    """Parse a flight-recorder JSONL into a dead-window diagnosis: last
    record (phase/chunk/compile at death), open spans never closed,
    watchdog dumps, and — when the convergence taps streamed heartbeat
    energies — the last-known energy + plateau chunk per span open at
    death, so the diagnosis prices QUALITY as well as phase. Tolerates a
    torn final line (truncated write)."""
    records: list[dict] = []
    torn = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                torn += 1
    # segment at "arm" records: a shared campaign JSONL holds several
    # processes' runs back to back, and a later healthy run's end records
    # must not cancel an earlier crashed run's open spans — each segment
    # keeps its own open-span ledger (the crashed rung's diagnosis is the
    # whole point of the file)
    segments: list[tuple[object, dict]] = []
    cur_pid: object = None
    cur_open: dict[str, dict] = {}
    started = False
    last_chunk: dict | None = None
    watchdogs = []
    #: span path -> most recent end record's cost block (any segment): a
    #: completed run of the same phase earlier in the file — the prewarm
    #: or cold pass — prices what an open-at-death span was expected to
    #: cost (device seconds + HBM watermark, ccx.common.costmodel)
    last_cost: dict[str, dict] = {}
    #: episode id -> joined healing arc (detected/fired/recovered spans
    #: from the ``healing`` records) — NOT segment-scoped:
    #: a soak run's episodes are the diagnosis even when a later rung
    #: appended its own segment to the shared campaign file
    healing: dict[object, dict] = {}
    healing_events = 0
    healing_forecasts = 0
    #: span path -> heartbeat-energy series of the CURRENT segment (reset
    #: on arm, like the open-span ledger): the convergence-tap trace the
    #: plateau detection below runs on
    energy_series: dict[str, list] = {}
    energy_last: dict[str, dict] = {}
    #: span path -> wall seconds of its last closed run (every segment):
    #: which phases a run completed, and how long each took
    span_walls: dict[str, float] = {}
    for r in records:
        ev = r.get("ev")
        if ev == "arm":
            if started:
                segments.append((cur_pid, cur_open))
            cur_pid, cur_open, started = r.get("pid"), {}, True
            energy_series, energy_last = {}, dict(energy_last)
        elif ev == "start":
            started = True
            cur_open[r.get("span", "?")] = r
        elif ev == "end":
            cur_open.pop(r.get("span", "?"), None)
            span_walls[r.get("span", "?")] = r.get("wall_s")
            if r.get("cost"):
                last_cost[r.get("span", "?")] = r["cost"]
        elif ev == "chunk":
            last_chunk = r
            if r.get("energy") is not None:
                span = r.get("span", "?")
                energy_series.setdefault(span, []).append(r["energy"])
                energy_last[span] = {
                    "energy": r["energy"], "chunk": r.get("chunk"),
                }
        elif ev == "watchdog":
            watchdogs.append(r)
        elif ev == "healing":
            healing_events += 1
            eid = r.get("episode")
            if eid is None:
                # advisory phases (forecast prewarms) carry no episode
                # id — count them, never join them into an arc that
                # would render as an UNRECOVERED episode
                healing_forecasts += 1
            else:
                arc = healing.setdefault(eid, {"episode": eid})
                phase = r.get("phase", "?")
                arc[phase + "T"] = r.get("t")
                for k in ("cluster", "family", "cause", "verb",
                          "timeToHealS", "error"):
                    if r.get(k) is not None:
                        arc[k] = r[k]
                arc.setdefault("phases", []).append(phase)
    segments.append((cur_pid, cur_open))
    multi = len(segments) > 1
    open_spans = sorted(
        f"pid={pid} {span}" if multi and pid is not None else span
        for pid, opens in segments for span in opens
    )
    expected_cost = {
        span: last_cost[span]
        for pid, opens in segments for span in opens
        if span in last_cost
    }
    # last-known energy + plateau chunk for spans open at death — "the
    # anneal died at chunk 7, energy 212, flat since chunk 4" readout
    from ccx_torch.common.convergence import plateau_chunk as _plateau

    convergence = {}
    for pid, opens in segments:
        for span in opens:
            if span not in energy_last:
                continue
            entry = dict(energy_last[span])
            series = energy_series.get(span) or []
            if len(series) > 1:
                entry["plateauChunk"] = _plateau(series)
                entry["chunksSeen"] = len(series)
            convergence[span] = entry
    return {
        "records": len(records),
        "runs": len(segments),
        "tornLines": torn,
        "last": records[-1] if records else None,
        "lastChunk": last_chunk,
        "openSpans": open_spans,
        "spanWalls": span_walls,
        # expected device time + HBM watermark for spans open at death,
        # priced from the same phase's last completed run in this file
        "expectedCost": expected_cost,
        # last-known heartbeat energy (+ plateau) for spans open at death
        "convergence": convergence,
        "watchdogDumps": len(watchdogs),
        "lastWatchdog": watchdogs[-1] if watchdogs else None,
        # healing-event timeline: detected/fired/recovered
        # spans joined per episode — a dead soak run's recording names
        # the episode in progress (detected or fired, never recovered)
        "healing": {
            "events": healing_events,
            "forecasts": healing_forecasts,
            "episodes": list(healing.values()),
            "openEpisodes": [
                arc for arc in healing.values()
                if "recovered" not in arc.get("phases", ())
            ],
        },
    }


def render_summary(s: dict) -> str:
    """Human-readable diagnosis of a ``summarize()`` dict (the default
    CLI output; ``--json`` keeps the machine form for tooling)."""
    lines = [
        f"flight recording: {s['records']} records, {s['runs']} run(s), "
        f"{s['tornLines']} torn line(s)"
    ]
    last = s.get("last")
    if last:
        lines.append("last record: " + json.dumps(last, default=str))
    lc = s.get("lastChunk")
    if lc:
        extra = (
            f" energy={lc['energy']}" if lc.get("energy") is not None else ""
        )
        lines.append(
            f"last chunk: {lc.get('span', '?')} chunk {lc.get('chunk')}"
            f"/{lc.get('total', '?')}{extra}"
        )
    if s.get("openSpans"):
        lines.append("open spans at death:")
        for span in s["openSpans"]:
            parts = [f"  {span}"]
            conv = (s.get("convergence") or {}).get(span.split(" ")[-1])
            if conv:
                parts.append(
                    f"— last energy {conv['energy']} @ chunk "
                    f"{conv.get('chunk')}"
                )
                if conv.get("plateauChunk") is not None:
                    parts.append(
                        f"(plateau at chunk {conv['plateauChunk']} of "
                        f"{conv['chunksSeen']} seen)"
                    )
            cost = (s.get("expectedCost") or {}).get(span.split(" ")[-1])
            if cost:
                parts.append(f"expected cost {json.dumps(cost)}")
            lines.append(" ".join(parts))
    else:
        lines.append("open spans at death: none (clean exit)")
    lines.append(
        f"watchdog dumps: {s['watchdogDumps']}"
        + (
            f" (last: {json.dumps(s['lastWatchdog'].get('spans', {}))})"
            if s.get("lastWatchdog")
            else ""
        )
    )
    healing = s.get("healing") or {}
    episodes = healing.get("episodes") or []
    if episodes:
        fc = healing.get("forecasts") or 0
        lines.append(
            f"healing timeline: {len(episodes)} episode(s), "
            f"{len(healing.get('openEpisodes') or [])} open at death"
            + (f", {fc} forecast prewarm(s)" if fc else "")
        )
        for arc in episodes:
            phases = arc.get("phases", [])
            parts = [
                f"  episode {arc.get('episode')} "
                f"[{arc.get('family', '?')}] {arc.get('cluster', '?')}:"
            ]
            for ph in ("detected", "fired", "recovered"):
                if ph in phases:
                    t = arc.get(ph + "T")
                    parts.append(
                        f"{ph}@{t}" if t is not None else ph
                    )
            if arc.get("verb"):
                parts.append(f"verb={arc['verb']}")
            if arc.get("timeToHealS") is not None:
                parts.append(f"tth={arc['timeToHealS']}s")
            if arc.get("cause"):
                parts.append(f"cause={arc['cause']!r}")
            if "recovered" not in phases:
                parts.append("UNRECOVERED")
            lines.append(" ".join(parts))
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m ccx_torch.common.tracing recording.jsonl [--json]`` — print
    the diagnosis of a (possibly dead) run's flight recording: human-
    readable by default, ``--json`` for tooling (the budget advisor and
    campaign scripts consume the machine form)."""
    args = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    if len(args) != 1 or args[0] in ("-h", "--help"):
        print(
            "usage: python -m ccx_torch.common.tracing <recording.jsonl> [--json]",
            file=sys.stderr,
        )
        return 2
    if not os.path.exists(args[0]):
        print(f"no such recording: {args[0]}", file=sys.stderr)
        return 2
    s = summarize(args[0])
    print(json.dumps(s, indent=1) if as_json else render_summary(s))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
