"""Readers of the system's span tree on a Propose result (``spanTree``):
the counters its tracer keeps on each span and the sidecar's edge spans of
the request. A tree that lacks a counter or the request entry (a system
that does not keep them) reads 0: a span with no sync renders no
counter."""

from __future__ import annotations


def total(node: dict, key: str) -> float:
    """The subtree total of counter ``key`` (``syncs``,
    ``syncWaitSeconds``) of a rendered span; 0 where it is absent."""
    return (node.get(key) or {}).get("total", 0)


def phases_total(result: dict, phases: tuple[str, ...], key: str) -> float:
    """Counter ``key`` summed over the root's phase spans named in
    ``phases``."""
    tree = result.get("spanTree") or {}
    return sum(total(c, key) for c in tree.get("children", ()) if c.get("name") in phases)


def tree_total(result: dict, key: str) -> float:
    """Counter ``key`` of the whole ``optimize`` tree."""
    return total(result.get("spanTree") or {}, key)


def edge_seconds(result: dict) -> float:
    """The summed wall of the request's edge spans (decode, registry,
    warm-base, bank, assembly, pack), from their nanosecond stamps."""
    spans = ((result.get("spanTree") or {}).get("request") or {}).get("spans", ())
    return sum(s["endNs"] - s["startNs"] for s in spans) / 1e9


def mean_untraced(run, kind: str, read) -> float | None:
    """The mean of ``read(result)`` over the requests of ``kind`` served
    before the profiler started; None when there is none."""
    vals = [read(r.result) for r in run.requests
            if r.kind == kind and r.result is not None and not r.traced]
    return sum(vals) / len(vals) if vals else None
