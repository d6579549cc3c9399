"""Compile-work counters — the port's own builds, counted as they happen.

The port's counterpart of the JAX package's ``common/compilestats.py``. The
JAX package counts XLA compiles and persistent-cache hits from
``jax.monitoring`` events; the port compiles no programs at run time, only
its hand-written kernels, so it counts those builds. The counters keep the
JAX package's names (and ``export_gauges`` its gauge names,
``compile-backend-compiles`` and so on), so one dashboard scrapes either
sidecar. On the port they mean:

* ``backend_compiles`` / ``backend_compile_secs`` — ``nvcc`` builds of a
  kernel library (``ccx_torch.ops.broker_aggregates.build``) in this
  process, and their wall seconds. A CUDA-graph capture, once the port has
  one, counts here too;
* ``persistent_hits`` — builds served by the build cache
  (``ccx_torch/_build/``, keyed on a hash of the sources and flags): the
  library was there, nothing was compiled;
* ``persistent_misses`` — builds the cache could not serve: each wrote a
  fresh library into it (one per ``backend_compiles`` that succeeded).

``attributed(label)`` charges every build inside a region, count and wall
seconds, to ``label``; ``attribution()`` returns the ledger. Deltas are
snapshot-based, so nested or concurrent regions double-charge: attribute
from one thread at a time.

Thread-safe: builds may run in any thread (the sidecar's workers), so the
counters take a lock. Standard library only.
"""

from __future__ import annotations

import contextlib
import threading
import time

_COUNTS = {
    "backend_compiles": 0,
    "backend_compile_secs": 0.0,
    "persistent_hits": 0,
    "persistent_misses": 0,
}
_ATTR: dict = {}
_LOCK = threading.Lock()


def note_build(seconds: float) -> None:
    """One kernel build that compiled and wrote a fresh library into the
    build cache, taking ``seconds`` of wall time."""
    with _LOCK:
        _COUNTS["backend_compiles"] += 1
        _COUNTS["backend_compile_secs"] += float(seconds)
        _COUNTS["persistent_misses"] += 1


def note_cache_hit() -> None:
    """One kernel build served by the build cache (nothing compiled)."""
    with _LOCK:
        _COUNTS["persistent_hits"] += 1


def snapshot() -> dict:
    """Cumulative counters so far."""
    with _LOCK:
        return dict(_COUNTS)


def delta(before: dict, after: dict) -> dict:
    """Counter difference between two snapshots, rounded for JSON."""
    d = {k: after[k] - before[k] for k in _COUNTS}
    d["backend_compile_secs"] = round(d["backend_compile_secs"], 2)
    return d


@contextlib.contextmanager
def attributed(label: str):
    """Charge every build inside the region to ``label`` (summed across
    re-entries), plus the region's wall seconds."""
    before = snapshot()
    t0 = time.monotonic()
    try:
        yield
    finally:
        d = delta(before, snapshot())
        wall = time.monotonic() - t0
        with _LOCK:
            slot = _ATTR.setdefault(
                label, {**{k: 0 for k in _COUNTS}, "backend_compile_secs": 0.0, "wall_secs": 0.0}
            )
            for k in _COUNTS:
                slot[k] += d[k]
            slot["backend_compile_secs"] = round(slot["backend_compile_secs"], 2)
            slot["wall_secs"] = round(slot["wall_secs"] + wall, 2)


def attribution() -> dict:
    """The per-label build ledger accumulated so far (label -> counter dict
    + wall_secs)."""
    with _LOCK:
        return {k: dict(v) for k, v in _ATTR.items()}


def export_gauges(registry=None) -> None:
    """Register the live counters as gauges on the metrics registry (the
    JAX package's names). Idempotent: re-registration replaces the gauge
    callables."""
    if registry is None:
        from ccx_torch.common.metrics import REGISTRY as registry  # noqa: N811
    docs = {
        "backend_compiles": "kernel builds (nvcc) in this process",
        "backend_compile_secs": "wall seconds spent in kernel builds",
        "persistent_hits": "kernel builds served by the build cache",
        "persistent_misses": "kernel builds that wrote a fresh library to the build cache",
    }
    for key in _COUNTS:
        registry.gauge(
            f"compile-{key.replace('_', '-')}",
            (lambda k=key: snapshot()[k]),
            help=docs[key],
        )
