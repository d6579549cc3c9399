"""One CUDA graph helper for the search's hot loops: a descent's iteration
(``greedy._drive_descent``) and an SA step (``annealer.anneal``).

``GraphedLoop`` runs a loop body through ``step_graph``'s graph: the first
call eagerly (its caches and shapes warm), the second captured and
replayed, every later one replayed, the draws advancing the run's Philox
stream as eager launches would. Without a graph (off a card) every call is
eager. ``close`` retires the graph and adds ``graphCaptures``,
``graphReplays`` and ``graphCaptureSeconds`` to the innermost open span.
"""

from __future__ import annotations

import threading
import time

import torch

from ccx_torch.common.tracing import TRACER
from ccx_torch.device import CAPTURE_LOCK

#: retired graphs by card index, each with its capture stream and the event
#: that marks its last replay: a capture takes one, captures on its stream
#: into its memory pool (``pool=retired.pool()``; the allocator reuses a
#: freed block on the stream that freed it) and only then drops it, so a
#: card holds as many pools as loops ever captured at once and nothing grows
#: from run to run (a pool whose last graph is gone cannot be named again)
_RETIRED: dict[int, list] = {}
_RETIRED_LOCK = threading.Lock()


class CudaStepGraph:
    """One loop body captured as a CUDA graph and replayed. The capture
    runs on a side stream in thread-local mode (fleet jobs launch from other
    threads), on the stream and in the memory pool of a retired graph where
    the card has one, holding ``CAPTURE_LOCK`` (a device-wide synchronize
    from another thread would invalidate it); ``gen`` is registered, so
    each replay advances its Philox stream as the eager launches would.
    ``release`` retires the graph: it is never replayed again. A capture
    error raises, and the failed graph is not retired."""

    def __init__(self, dev: torch.device, gen: torch.Generator) -> None:
        self.gen = gen
        self.index = dev.index if dev.index is not None else torch.cuda.current_device()
        self.graph = None
        self.side = None

    def capture(self, fn) -> None:
        # no other thread synchronizes the device meanwhile
        # (``ccx_torch.device.synchronize``)
        with CAPTURE_LOCK, torch.cuda.device(self.index):
            with _RETIRED_LOCK:
                free = _RETIRED.get(self.index)
                retired = free.pop() if free else None
            cur = torch.cuda.current_stream()
            pool = None
            if retired is None:
                self.side = torch.cuda.Stream()
            else:
                old, self.side, done = retired
                cur.wait_event(done)
                pool = old.pool()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.gen)
            self.side.wait_stream(cur)
            try:
                with torch.cuda.stream(self.side):
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        fn()
                    finally:
                        graph.capture_end()
                cur.wait_stream(self.side)
                # a failed capture has no pool to hand on: it is never retired
                self.graph = graph
            finally:
                if retired is not None:
                    old.reset()

    def replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        if self.graph is None:
            return
        with torch.cuda.device(self.index):
            done = torch.cuda.Event()
            done.record()
        with _RETIRED_LOCK:
            _RETIRED.setdefault(self.index, []).append((self.graph, self.side, done))
        self.graph = None


def step_graph(dev: torch.device, gen: torch.Generator):
    """The graph that replays a loop body on ``dev`` (draws from ``gen``): a
    CUDA graph on a card; None elsewhere, where every call runs eagerly."""
    return CudaStepGraph(dev, gen) if dev.type == "cuda" else None


class GraphedLoop:
    """Calls ``body`` through ``graph`` (``step_graph``'s, or None): the
    first call eagerly, the second captured and replayed, every later one
    replayed; with no graph every call is eager."""

    def __init__(self, graph, body) -> None:
        self.graph, self.body = graph, body
        self.calls = 0
        self.counts = {"graphCaptures": 0, "graphReplays": 0, "graphCaptureSeconds": 0.0}

    def __call__(self) -> None:
        self.calls += 1
        if self.graph is None or self.calls == 1:
            self.body()
            return
        if self.calls == 2:
            t0 = time.perf_counter()
            self.graph.capture(self.body)
            self.counts["graphCaptureSeconds"] = time.perf_counter() - t0
            self.counts["graphCaptures"] = 1
        self.graph.replay()
        self.counts["graphReplays"] += 1

    def close(self) -> None:
        """Retire the graph and add the counts to the open span."""
        if self.graph is not None:
            self.graph.release()
        TRACER.add_counts(**self.counts)
