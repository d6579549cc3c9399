#!/usr/bin/env python3
"""Check the port's tracer on the card, through the benchmark's own B5 cells
(``perfbench``: the cold target cell and the warm drift cell, served by the
sidecar over loopback gRPC), and print one JSON line per check:

1. ``walls``: cold proposals and warm windows with the recorder off, the
   same with the flight recorder armed, and each result's span counts
   (spans, aggregate entries, syncs);
2. ``syncs``: one cold proposal and one warm window under
   ``torch.cuda.set_sync_debug_mode("warn")``: every sync torch reports, by
   the first site in the repository on its stack, split into those inside
   ``TRACER.blocked`` (counted by the tracer) and the rest, beside the
   counts on the result's span tree;
3. ``costs``: the host cost of one span, one aggregate entry and one
   counted sync, with the recorder off, armed, and under a profiler, and
   what they add to a cold proposal and a warm window at the counts of 1;
4. ``capture``: one cold proposal and one warm window under
   ``ccx_torch.common.profiling.capture``: per phase, edge span and
   aggregate, the wall, the device's busy seconds inside the span's window
   (``startNs``/``endNs`` on the profiler's clock), and the host's seconds
   blocked in syncs and working;
5. ``clock``: which clock the profiler stamps host events with: a
   ``torch.cuda._sleep`` launched inside a span, its ``cudaLaunchKernel``
   against the span's ``[startNs, endNs]`` and against ``time.monotonic_ns``
   stamps taken around it, in a CUDA-activity profile (the benchmark
   sampler's set) and a CPU and CUDA one (``profiling.capture``'s).

The profiler runs last: once it has traced the card, later launches are
slower. The whole record goes to ``--out`` (``smoke_out/trace_audit.json``).

    python3 tools/torch_trace_audit.py [--seed N] [--cold 2] [--warm 3]

``--device cpu`` runs the flow on the host at a cut size (10 brokers, 1000
partitions, a short search), without the sync audit and the clock check,
to try the script itself.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def say(obj: dict, record: dict) -> None:
    record[obj["check"]] = obj
    print(json.dumps(obj, default=str), flush=True)


def walk(node: dict):
    yield node
    for c in node.get("children", ()):
        yield from walk(c)


def tree_counts(res: dict) -> dict:
    """Spans, aggregate entries and syncs on a result's span tree and its
    request's edge spans."""
    tree = res["spanTree"]
    edges = (tree.get("request") or {}).get("spans", [])
    nodes = list(walk(tree)) + [n for e in edges for n in walk(e)]
    return {
        "spans": sum(1 for n in nodes if "calls" not in n),
        "aggregateEntries": sum(n["calls"] for n in nodes if "calls" in n),
        "aggregateNodes": sum(1 for n in nodes if "calls" in n),
        "syncs": sum((n.get("syncs") or {}).get("self", 0) for n in nodes),
        "syncWaitSeconds": sum((n.get("syncWaitSeconds") or {}).get("self", 0.0) for n in nodes),
        "grantWaitSeconds": sum((n.get("grantWaitSeconds") or {}).get("self", 0.0)
                                for n in nodes),
    }


# ----- the sync audit ---------------------------------------------------------------


class SyncAudit:
    """Every synchronizing CUDA operation torch reports while armed, by the
    innermost frame in the repository, counted or not (``in_sync``)."""

    def __init__(self) -> None:
        self.counted: collections.Counter = collections.Counter()
        self.unrouted: collections.Counter = collections.Counter()
        self.other = 0

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        from ccx_torch.common.tracing import TRACER

        if "synchroniz" not in str(message):
            self.other += 1
            return
        site = f"{filename}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if str(REPO) in fr.filename and "warnings" not in fr.filename:
                site = f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno} {fr.name}"
                break
        (self.counted if TRACER.in_sync() else self.unrouted)[site] += 1

    def run(self, fn):
        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            prev = warnings.showwarning
            warnings.showwarning = self._hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
                warnings.showwarning = prev

    def to_json(self) -> dict:
        return {"counted": sum(self.counted.values()), "unrouted": sum(self.unrouted.values()),
                "countedSites": dict(self.counted.most_common()),
                "unroutedSites": dict(self.unrouted.most_common()), "otherWarnings": self.other}


# ----- host costs ----------------------------------------------------------------------


def per_call_ns(n: int) -> dict:
    """ns per call of a span, an aggregate entry and a counted sync (an
    empty body), net of the empty loop, inside an open root span."""
    from ccx_torch.common.tracing import TRACER

    def loop(body) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            body()
        return (time.perf_counter_ns() - t0) / n

    def empty():
        pass

    def span():
        with TRACER.span("bench-span"):
            pass

    def step():
        with TRACER.step("bench-step"):
            pass

    def blocked():
        with TRACER.blocked():
            pass

    out = {}
    with TRACER.span("bench-root"):
        for _ in range(2):
            base = loop(empty)
            out = {name: loop(fn) - base for name, fn in
                   (("span", span), ("step", step), ("blocked", blocked))}
    return out


def added_ms(costs: dict, counts: dict) -> float:
    return (costs["span"] * counts["spans"] + costs["step"] * counts["aggregateEntries"]
            + costs["blocked"] * counts["syncs"]) / 1e6


# ----- the capture -------------------------------------------------------------------


def device_busy(prof) -> list[tuple[int, int]]:
    """The union of device activity of a capture, sorted."""
    ivs = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            ivs.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    merged: list[list[int]] = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_in(busy, starts, lo: int, hi: int) -> float:
    """Device-busy seconds of ``busy`` inside ``[lo, hi]``."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    tot = 0
    while i < len(busy) and busy[i][0] < hi:
        s, e = busy[i]
        tot += max(0, min(e, hi) - max(s, lo))
        i += 1
    return tot / 1e9


def split(res: dict, busy) -> dict:
    """Per phase (with its aggregates), per edge span and for the whole
    tree: wall, device busy in the span's window, host blocked in syncs and
    host working."""
    starts = [s for s, _ in busy]
    tree = res["spanTree"]

    def row(n: dict) -> dict:
        wall = n.get("wallSeconds", 0.0)
        blocked = (n.get("syncWaitSeconds") or {}).get("total", 0.0)
        out = {"wall_s": wall, "syncs": (n.get("syncs") or {}).get("total", 0),
               "blocked_s": blocked, "host_s": wall - blocked}
        if "calls" in n:
            out["calls"] = n["calls"]
        else:
            out["busy_s"] = busy_in(busy, starts, n["startNs"], n["endNs"])
        # the descents' and the anneal's graph counters (PERF.md §3)
        out.update({k: v for k, v in (n.get("attrs") or {}).items() if k.startswith("graph")})
        return out

    phases = {}
    for c in tree.get("children", ()):
        phases[c["name"]] = {**row(c), "aggregates": {
            a["name"]: row(a) for a in c.get("children", ()) if "calls" in a}}
    edges = [{"name": e["name"], **row(e)} for e in (tree.get("request") or {}).get("spans", [])]
    whole = row(tree)
    return {"optimize": whole, "phases": phases, "edges": edges,
            "busy_share": whole["busy_s"] / max(whole["wall_s"], 1e-9)}


# ----- the clock -----------------------------------------------------------------------


def clock_check(activities) -> dict:
    import torch
    from torch.profiler import profile

    from ccx_torch.common.tracing import TRACER

    with profile(activities=activities) as prof:
        with TRACER.span("clock-root"):
            m0 = time.monotonic_ns()
            with TRACER.span("clock-probe") as s:
                torch.cuda._sleep(100_000)
            m1 = time.monotonic_ns()
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if "LaunchKernel" in e.name()]
    kernels = [e for e in events if str(e.device_type()).endswith("CUDA")]
    rng = [e for e in events if e.name() == "ccx:clock-probe"]
    out = {"span": [s.start_ns, s.end_ns], "monotonic": [m0, m1],
           "deviceTypes": sorted({str(e.device_type()) for e in events}),
           "launches": [[e.name(), e.start_ns(), e.start_ns() + e.duration_ns()]
                        for e in launches],
           "kernels": [[e.name(), e.start_ns(), e.start_ns() + e.duration_ns()] for e in kernels]}
    if launches:
        a = launches[-1].start_ns()
        b = a + launches[-1].duration_ns()
        out["launchInSpan"] = s.start_ns <= a <= b <= s.end_ns
        out["launchInMonotonicWindow"] = m0 <= a <= b <= m1
        out["launchOffsetFromSpanStartNs"] = a - s.start_ns
    if kernels and launches:
        out["kernelAfterLaunch"] = kernels[-1].start_ns() >= launches[-1].start_ns()
        out["kernelStartAfterLaunchNs"] = kernels[-1].start_ns() - launches[-1].start_ns()
    if rng:
        a, b = rng[-1].start_ns(), rng[-1].start_ns() + rng[-1].duration_ns()
        out["rangeInSpan"] = s.start_ns <= a <= b <= s.end_ns
    return out


# ----- main ----------------------------------------------------------------------------


def cut(cell) -> None:
    """The host trial's size: 10 brokers, 1000 partitions, a short search."""
    cell.config = {**cell.config, "spec": {**cell.config["spec"], "n_brokers": 10, "n_racks": 3,
                                           "n_topics": 10, "n_partitions": 1000}}
    short = {"chains": 4, "steps": 10, "chunk_steps": 10, "polish_max_iters": 6,
             "polish_chunk_iters": 3, "leader_pass_max_iters": 3, "polish_candidates": 32}
    t = dict(cell.traffic)
    for key in ("options", "cold_options"):
        if key in t:
            t[key] = {**t[key], **short}
    if "warm_options" in t:
        t["warm_options"] = {**t["warm_options"], "warm_swap_iters": 2,
                             "warm_swap_candidates": 8}
    cell.traffic = t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2_147_486_911)
    ap.add_argument("--cold", type=int, default=2, help="cold proposals with the recorder off")
    ap.add_argument("--warm", type=int, default=3, help="warm windows with the recorder off")
    ap.add_argument("--out", default=str(REPO / "smoke_out" / "trace_audit.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity

    from ccx_torch.common import profiling
    from ccx_torch.common.tracing import TRACER
    from perfbench import harness
    from perfbench.drivers import cold, warm

    on_card = args.device == "cuda"
    device = harness.require_card(1) if on_card else torch.device("cpu")
    record: dict = {"card": harness.device_line(device), "torch": torch.__version__}
    print(json.dumps(record), flush=True)
    tmp = tempfile.mkdtemp(prefix="trace-audit-")
    cruns = {}
    for label, cell_name, drv, n in (("cold", "b5-cold-target", cold, args.cold),
                                     ("warm", "b5-warm-drift", warm, args.warm)):
        cell = harness.Cell.load(cell_name)
        if not on_card:
            cut(cell)
        run = harness.Run(cell, args.seed, device)
        run.start_sidecar()
        t0 = time.monotonic()
        drv.setup(run)
        setup_s = time.monotonic() - t0
        plain = [drv.request(run, i) for i in range(n)]
        TRACER.arm(os.path.join(tmp, f"{label}.jsonl"))
        armed = drv.request(run, n)
        TRACER.disarm()
        audit = SyncAudit()
        debug = (audit.run if on_card else lambda fn: fn())(lambda: drv.request(run, n + 1))
        for r in plain + [armed, debug]:
            if r.result is None:
                raise RuntimeError(f"{label} request {r.index} failed: {r.error}")
        say({"check": f"walls.{label}", "setup_s": setup_s,
             "plain_s": [r.wall_s for r in plain],
             "plain_optimizer_s": [r.result["wallSeconds"] for r in plain],
             "armed_s": armed.wall_s, "armed_optimizer_s": armed.result["wallSeconds"],
             "counts": tree_counts(plain[-1].result),
             "recorder_lines": sum(1 for _ in open(os.path.join(tmp, f"{label}.jsonl")))},
            record)
        say({"check": f"syncs.{label}", **audit.to_json(), "tree": tree_counts(debug.result),
             "wall_s": debug.wall_s}, record)
        cruns[label] = (run, drv, n + 2)
    try:
        costs = {"off": per_call_ns(20_000)}
        TRACER.arm(os.path.join(tmp, "costs.jsonl"))
        costs["armed"] = per_call_ns(20_000)
        TRACER.disarm()
        for label, (run, drv, i) in cruns.items():
            with profiling.capture() as prof:
                r = drv.request(run, i)
            if r.result is None:
                raise RuntimeError(f"captured {label} request failed: {r.error}")
            busy = device_busy(prof)
            plain_wall = record[f"walls.{label}"]["plain_optimizer_s"]
            sp = split(r.result, busy)
            del prof
            say({"check": f"capture.{label}", "wall_s": r.wall_s,
                 "device_busy_s": sp["optimize"]["busy_s"],
                 "untraced_idle_estimate": 1 - sp["optimize"]["busy_s"]
                 / (sum(plain_wall) / len(plain_wall)),
                 **sp}, record)
        with profiling.capture():
            costs["capture"] = per_call_ns(5_000)
        counts = {label: record[f"walls.{label}"]["counts"] for label in cruns}
        say({"check": "costs", "ns_per_call": costs, "added_ms": {
            mode: {label: added_ms(c, counts[label]) for label in counts}
            for mode, c in costs.items()}}, record)
        if on_card:
            say({"check": "clock", "cuda": clock_check([ProfilerActivity.CUDA]),
                 "cpu_cuda": clock_check([ProfilerActivity.CPU, ProfilerActivity.CUDA])},
                record)
    finally:
        for run, _, _ in cruns.values():
            run.stop_sidecar()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"ok": True, "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
