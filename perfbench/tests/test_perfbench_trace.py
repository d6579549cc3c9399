"""The traced run's reading of a trace, on synthetic device events: the
busy union, the idle gaps, the marked aggregates calls, and the sampler's
schedule of slices at the system's tracer records."""

from __future__ import annotations

from perfbench import trace as tr


def test_marked_aggregates_calls_are_read_per_stream():
    short, long_ = 1_000, tr.END_MIN_NS + 1
    ev = [
        (0, 5_000, "other", 7),
        (10_000, 10_000 + long_, tr.MARKER, 7),   # an end with no begin: a cut call
        (30_000, 30_000 + short, tr.MARKER, 7),   # begin
        (32_000, 35_000, "aggregates", 7),
        (36_000, 37_000, "memset", 7),
        (40_000, 41_000, "other stream", 8),
        (50_000, 50_000 + long_, tr.MARKER, 7),   # end
        (60_000, 60_000 + short, tr.MARKER, 7),   # a begin cut by the slice's end
        (61_000, 62_000, "aggregates", 7),
    ]
    assert tr._aggregate_calls(ev) == [4_000]


def test_union_and_gaps():
    assert tr._union([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]


class _FakeProfile:
    def __init__(self, *args, **kwargs):
        self.started = self.stopped = False

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True


def test_slices_open_and_close_at_records(monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    clock = [100.0]
    monkeypatch.setattr(tr.time, "monotonic", lambda: clock[0])
    s = tr.Sampler(every_s=2.0, slice_s=0.5, max_slices=2)
    s._due = 100.0

    def rec(t, ev, span):
        clock[0] = t
        s._on_record({"ev": ev, "span": span})

    rec(100.0, "start", "optimize")            # opens
    rec(100.2, "start", "optimize/anneal")     # too soon to close
    rec(100.7, "chunk", "optimize/anneal")     # closes: 0.7 s
    rec(101.0, "start", "optimize/polish")     # not due before 102.0
    rec(102.1, "chunk", "optimize/polish")     # opens
    rec(102.3, "end", "optimize")              # the Propose ends: closes
    rec(105.0, "start", "other")               # not the system's work
    rec(106.0, "start", "optimize")            # due, but two slices are the most
    assert [(x["t0"], x["t1"]) for x in s.slices] == [(100.0, 100.7), (102.1, 102.3)]
    assert s._prof is None and not s.errors
