"""One run of one cell: the system's sidecar brought up in process, the
cell's driver in a closed loop for the window, the reference's verdict, the
metrics and the result line.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:
the configuration file it names, ``traffic/<traffic>.json``, the driver
``drivers/<driver>.py`` the traffic names, the limits of its comparison in
``limits/<workload>.json`` and a reader ``metrics/<metric>.py`` for every
metric it reports. Adding a cell, a traffic mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from perfbench import trace as tr
from perfbench.reference import compare

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ccx")


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot against the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        """The cell ``name`` of the checkout at ``root``."""
        bench = load_json(root / "BENCHMARK.json")
        pkg = root / PKG.name
        workload = next((w for w in bench["workloads"] if w["name"] == name), None)
        if workload is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = next(c for c in bench["configs"] if c["name"] == workload["config"])

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(
            name=name, workload=workload, config=load_json(root / entry["file"]),
            traffic=load_json(pkg / "traffic" / f"{workload['traffic']}.json"),
            limits=load_json(pkg / "limits" / f"{name}.json"),
            end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]),
        )


def reader(metric: str, pkg: Path = PKG):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = pkg / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


@dataclasses.dataclass
class Request:
    """One timed request: the snapshot its answer is judged on, the client's
    walls, the result and, after the window, the reference's readings."""

    kind: str
    index: int
    snap: dict
    t0: float = 0.0
    t1: float = 0.0
    put_s: float = 0.0
    rtt_s: float = 0.0
    result: dict | None = None
    error: str | None = None
    readings: dict | None = None
    #: served after the profiler started (its host times are the
    #: profiler's as much as the system's)
    traced: bool = False
    #: CPU seconds of the whole process and seconds in the cycle collector
    #: over the request's turn of the loop
    cpu_s: float = 0.0
    gc_s: float = 0.0

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


class Run:
    """The state of one run that drivers and metric readers share; a
    driver keeps its own state (layout, generation, drift stream) on it."""

    def __init__(self, cell: Cell, seed: int, device) -> None:
        self.seed, self.device = seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.requests: list[Request] = []
        #: (host time, span name) marks, in time order: what the host is in
        self.marks: list[tuple[float, str]] = [(0.0, "set-up")]
        self.setup_s = self.window_s = 0.0
        self.trace: dict | None = None
        self.notes: dict = {}
        self.client = self.server = None

    # ----- spans -------------------------------------------------------------

    def mark(self, name: str) -> None:
        self.marks.append((time.monotonic(), name))

    def name_at(self, t: float) -> str:
        i = np.searchsorted([m[0] for m in self.marks], t, side="right") - 1
        return self.marks[max(int(i), 0)][1]

    def on_progress(self, text: str) -> None:
        """Progress frames of a Propose name the pipeline phase it is in."""
        self.mark("propose:" + text.split(" chunk ")[0])

    # ----- the system --------------------------------------------------------

    def start_sidecar(self) -> None:
        from ccx_torch.sidecar.client import SidecarClient
        from ccx_torch.sidecar.server import (
            OptimizerSidecar, freeze_gc_steady_state, make_grpc_server,
        )

        self.server, port = make_grpc_server(OptimizerSidecar(device=self.device),
                                             address="127.0.0.1:0")
        self.server.start()
        freeze_gc_steady_state()
        self.client = SidecarClient(f"127.0.0.1:{port}")

    def stop_sidecar(self) -> None:
        if self.client is not None:
            self.client.close()
        if self.server is not None:
            self.server.stop(0).wait(30)
        self.client = self.server = None

    def propose(self, session: str, options: dict, **kwargs) -> tuple[dict, float]:
        t0 = time.monotonic()
        self.mark("propose")
        res = self.client.propose(session=session, goals=self.goal_names(), columnar=True,
                                  on_progress=self.on_progress, **kwargs, **options)
        return res, time.monotonic() - t0

    def put(self, session: str, generation: int, arrays: dict, base: dict | None = None,
            **kwargs) -> float:
        """A full put of ``arrays``, or with ``base`` a delta put of the
        fields that differ from it; the client's encoding is timed."""
        from ccx_torch.model.snapshot import delta_encode, pack_arrays

        t0 = time.monotonic()
        self.mark("put")
        if base is not None:
            arrays = delta_encode(base, arrays)
            kwargs["is_delta"] = True
        self.client.put_snapshot(None, session=session, generation=generation,
                                 packed=pack_arrays(arrays), **kwargs)
        return time.monotonic() - t0

    def goal_names(self) -> tuple[str, ...]:
        return tuple(g["name"] for g in self.config["goals"])

    def rng(self, *stream: int) -> np.random.Generator:
        """The generator of one stream of this run's inputs."""
        return np.random.default_rng([self.seed % 2**64, *stream])


class HostMeter:
    """What the host gives the process: seconds in the cycle collector
    (``gc.callbacks``), CPU seconds of every thread, and the share of the
    machine's CPU time its hypervisor stole (``/proc/stat``)."""

    def __init__(self) -> None:
        self.gc_s = 0.0
        self._t = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t

    def close(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    @staticmethod
    def cpu_ticks() -> tuple[int, int]:
        """(steal, total) clock ticks of every CPU of the machine."""
        try:
            with open("/proc/stat") as f:
                fields = [int(x) for x in f.readline().split()[1:]]
        except (OSError, ValueError):
            return 0, 0
        return (fields[7] if len(fields) > 7 else 0), sum(fields[:8])


def host_probe_s(repeats: int = 5) -> float:
    """Median seconds of a fixed piece of pure-Python work (200,000 turns
    of a loop): the host's speed for the interpreter, read beside a run's
    walls so that a slower host shows as such."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i % 7
        times.append(time.perf_counter() - t0)
    return sorted(times)[repeats // 2]


def launch_probe_s(device, n: int = 2000) -> float | None:
    """Seconds per launch of ``n`` back-to-back one-element kernels and a
    synchronize: the host's and the driver's launch rate."""
    import torch

    if device.type != "cuda":
        return None
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / n


def device_line(device) -> dict:
    """The result's ``device`` block: the card, the count and the peak of
    device memory, with the card's power limit beside them."""
    import torch

    if device.type != "cuda":
        line = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        line = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
        try:
            line["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                 f"--id={device.index or 0}"],
                capture_output=True, text=True, check=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            line["power_limit"] = None
    return line


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["gaps"], key=lambda g: -g[0])[:10]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name, s] for s, name in gaps]}


def _say(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device) -> tuple[int, dict | None]:
    """Run ``cell`` once; returns (exit code, the result line or None)."""
    import torch

    run = Run(cell, seed, device)
    drv = driver(cell.traffic["driver"])
    undo = None
    sampler = None
    sched = cell.traffic["trace"]
    meter = HostMeter()
    host: dict = {}
    try:
        run.start_sidecar()
        if traced and device.type == "cuda":
            undo = tr.mark_aggregates()
            sampler = tr.Sampler(sched["every_s"], sched["slice_s"], sched["max_slices"])
        drv.setup(run)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gc.collect()
        run.setup_s = process_age_s()
        host["before"] = {"host_probe_s": host_probe_s(), "launch_probe_s": launch_probe_s(device)}
        steal0, total0 = meter.cpu_ticks()
        t_start = time.monotonic()
        t_end = t_start + seconds
        while time.monotonic() < t_end:
            if sampler is not None and len(run.requests) == sched["clean_requests"]:
                sampler.arm()
            cpu0, gc0 = time.process_time(), meter.gc_s
            r = drv.request(run, len(run.requests))
            r.cpu_s, r.gc_s = time.process_time() - cpu0, meter.gc_s - gc0
            r.traced = sampler is not None and len(run.requests) >= sched["clean_requests"]
            run.requests.append(r)
        run.window_s = time.monotonic() - t_start
        run.mark("after the window")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steal1, total1 = meter.cpu_ticks()
        host["steal_share"] = (steal1 - steal0) / max(total1 - total0, 1)
        line_device = device_line(device)
    finally:
        meter.close()
        if sampler is not None:
            sampler.disarm()
        if undo is not None:
            undo()
        run.stop_sidecar()
    host["after"] = {"host_probe_s": host_probe_s(), "launch_probe_s": launch_probe_s(device)}
    # the system's state is freed before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if sampler is not None:
        run.trace = tr.summarize(sampler.slices, run.name_at)
        sampler.slices = []

    for r in run.requests:
        if r.result is not None:
            r.readings = compare.judge(r.snap, r.result, cell.config)
    judged = [r.readings for r in run.requests if r.readings is not None]
    checks = compare.summarize(judged, cell.limits)
    failed = sum(1 for r in run.requests if r.result is None or r.readings["unverified"]
                 or r.readings["hard_violations"] > 0)
    correct = bool(run.requests) and failed == 0 and compare.passes(checks)

    metrics, unread = {}, []
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif device.type == "cuda" or m["source"] != "device_trace":
            # only the test entry on the CPU has no device trace to read
            unread.append(m["name"])

    bad = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if bad:
        print(f"perfbench: the process holds {bad} after the window", file=sys.stderr)
        return 3, None

    if run.trace is not None:
        line_device["busy_s"] = run.trace["busy_s"]
        line_device["window_s"] = run.trace["window_s"]
    _say({"requests": [
        {"kind": r.kind, "index": r.index, "wall_s": r.wall_s, "put_s": r.put_s,
         "rtt_s": r.rtt_s, "error": r.error,
         "optimizer_s": (r.result or {}).get("wallSeconds"),
         "phases": (r.result or {}).get("phaseSeconds"),
         "incremental": ((r.result or {}).get("incremental") or {}).get("warmStart"),
         "proposals": (r.result or {}).get("numProposals"),
         "soft_violations": (r.readings or {}).get("soft_violations"),
         "per_goal_violations": (r.readings or {}).get("per_goal"),
         "violation_gap_at": (r.readings or {}).get("violation_gap_at"),
         "cpu_s": r.cpu_s, "gc_s": r.gc_s}
        for r in run.requests]})
    kinds = {r.kind for r in run.requests}
    _say({"cell": cell.name, "seed": seed, "traced": traced, "setup_s": run.setup_s,
          "window_s": run.window_s, "attempted": len(run.requests), "failed": failed,
          # requests of each kind, and how many lie beyond a 90th percentile
          "requests_by_kind": {k: (n := sum(r.kind == k for r in run.requests),
                                   n - math.ceil(0.9 * n)) for k in sorted(kinds)},
          "host": host, **run.notes})
    if run.trace is not None:
        _say({"sampled_s": run.trace["window_s"],
              "sampled_share": run.trace["window_s"] / max(run.window_s, 1e-9),
              "slices": run.trace["slices"],
              "untraced_requests": sum(not r.traced for r in run.requests),
              "aggregates_calls_sampled": len(run.trace["aggregates_ns"]),
              "sampler_errors": sampler.errors})
    if unread:
        # a metric the cell lists that reads nothing is a fault of the run,
        # such as a kernel called out of its reader's sight
        print(f"perfbench: no reading of {unread}, which {cell.name} reports", file=sys.stderr)
        return 4, None
    line = {"correct": correct, "attempted": len(run.requests), "failed": failed,
            "metrics": metrics, "device": line_device}
    if run.trace is not None:
        line["breakdown"] = breakdown(run.trace)
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0, line


def require_card(chips: int):
    """The CUDA device of a run, or exit: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: this cell needs {chips} CUDA device(s); {n} found", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def nearest_rank(values: list[float], q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]
