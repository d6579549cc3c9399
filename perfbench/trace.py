"""The traced run's device view: ``torch.profiler`` over sampled slices of
the served loop, and the markers that bound the system's aggregates calls.

A B5 proposal launches tens of thousands of kernels a second, so the
profiler never covers the whole window. Slices open and close only in the
thread that launches the work, at the records the system's tracer emits
there (span starts and ends, chunk heartbeats): a slice opens at the first
record at or after its due time and closes at the first record
``slice_s`` or more later, or where the Propose ends. The profiler is never
started or stopped from another thread while the work launches: that
crashes the process at B5 (CUPTI is torn down at every stop). The slices'
results are read only once the window has closed.

The profiler slows the launches it watches several times over, and its
start costs seconds, so a traced run serves its first requests untraced
and arms the sampler after them (``Request.traced`` says which), and takes
at most ``max_slices`` slices: the per-layer times come from the untraced
requests, the device's shares from the slices.

``mark_aggregates`` wraps the system's aggregates entry so that every call
runs between two ``torch.cuda._sleep`` kernels on its stream: a short one
before and a long one after, told apart by their length. The device ops on
that stream between a pair are the call's device time.
"""

from __future__ import annotations

import time

#: spin cycles of the markers before and after an aggregates call, and the
#: duration that tells them apart (about 1 us against about 20 us)
BEGIN_CYCLES, END_CYCLES, END_MIN_NS = 1, 40_000, 8_000
MARKER = "spin_kernel"
#: the root span of one Propose's work
ROOT = "optimize"


def mark_aggregates():
    """Wrap the system's aggregates entry in the two markers. Returns the
    function that undoes it."""
    import torch

    from ccx_torch.ops import broker_aggregates as op

    inner = op.broker_aggregates_cuda

    def marked(*args, **kwargs):
        torch.cuda._sleep(BEGIN_CYCLES)
        try:
            return inner(*args, **kwargs)
        finally:
            torch.cuda._sleep(END_CYCLES)

    op.broker_aggregates_cuda = marked

    def undo():
        op.broker_aggregates_cuda = inner

    return undo


class Sampler:
    """Profiler slices on a schedule, opened and closed at the system's
    tracer records in the launching thread."""

    def __init__(self, every_s: float, slice_s: float, max_slices: int) -> None:
        self.every_s, self.slice_s, self.max_slices = every_s, slice_s, max_slices
        self.slices: list[dict] = []
        self.errors: list[str] = []
        self._prof = None
        self._t0 = 0.0
        self._due = float("inf")

    def arm(self) -> None:
        """Start sampling: the next record opens the first slice."""
        from ccx_torch.common.tracing import TRACER

        self._due = time.monotonic()
        TRACER.add_listener(self._on_record)

    def disarm(self) -> None:
        from ccx_torch.common.tracing import TRACER

        TRACER.remove_listener(self._on_record)
        if self._prof is not None:
            self._close(time.monotonic())

    def _on_record(self, rec: dict) -> None:
        span = rec.get("span") or ""
        if not span.startswith(ROOT):
            return
        now = time.monotonic()
        end_of_propose = rec.get("ev") == "end" and span == ROOT
        try:
            if self._prof is None:
                if (now >= self._due and not end_of_propose
                        and len(self.slices) < self.max_slices):
                    from torch.profiler import ProfilerActivity, profile

                    self._prof = profile(activities=[ProfilerActivity.CUDA])
                    self._prof.start()
                    self._t0 = time.monotonic()
            elif end_of_propose or now - self._t0 >= self.slice_s:
                self._close(now)
        except Exception as e:  # noqa: BLE001 — the tracer swallows a tap's errors; keep them
            self.errors.append(repr(e))
            self._prof = None

    def _close(self, now: float) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        self.slices.append({"prof": prof, "t0": self._t0, "t1": now})
        self._due = time.monotonic() + max(self.every_s - (now - self._t0), 0.0)


def _device_events(prof) -> list[tuple[int, int, str, int]]:
    """(start ns, end ns, name, stream) of every device op a slice
    recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name(), e.device_resource_id()))
    return sorted(out)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _aggregate_calls(events) -> list[int]:
    """Device ns of each complete marked aggregates call of one slice."""
    calls = []
    by_stream: dict[int, list] = {}
    for ev in events:
        by_stream.setdefault(ev[3], []).append(ev)
    for evs in by_stream.values():
        inside, total = False, 0
        for s, e, name, _ in evs:
            if MARKER in name:
                if e - s >= END_MIN_NS:
                    if inside:
                        calls.append(total)
                    inside = False
                else:
                    inside, total = True, 0
            elif inside:
                total += e - s
    return calls


def summarize(slices: list[dict], name_at) -> dict:
    """The slices read: ``window_s`` (their summed length), ``busy_s`` (the
    union of device activity inside them), ``aggregates_ns`` (each marked
    call's device time), ``device_ops`` (seconds by op name) and ``gaps``
    ((seconds, what the host was in) of every idle gap). ``name_at(t)``
    names the harness span at host time ``t``."""
    window_s = busy_s = 0.0
    ops: dict[str, float] = {}
    gaps: list[tuple[float, str]] = []
    agg: list[int] = []
    for sl in slices:
        prof, t0, t1 = sl["prof"], sl["t0"], sl["t1"]
        origin = prof.profiler.kineto_results.trace_start_ns()
        end = origin + int((t1 - t0) * 1e9)
        events = _device_events(prof)
        agg += _aggregate_calls(events)
        clipped = [(max(s, origin), min(e, end)) for s, e, _, _ in events if e > origin and s < end]
        busy = _union(clipped)
        window_s += t1 - t0
        busy_s += sum(e - s for s, e in busy) / 1e9
        for s, e, name, _ in events:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        edges = [origin] + [x for iv in busy for x in iv] + [end]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = t0 + ((a + b) / 2 - origin) / 1e9
                gaps.append(((b - a) / 1e9, name_at(mid)))
    return {"window_s": window_s, "busy_s": busy_s, "aggregates_ns": agg,
            "device_ops": ops, "gaps": gaps, "slices": len(slices)}
