"""The fleet, the steady-state loop and the wire split, through the port's
gRPC sidecar.

Ports of the JAX bench's ``run_fleet``, ``run_steady`` and ``run_wire``
(``bench.py``, ``--fleet``, ``--steady`` and ``--wire``). Each drives a
real loopback gRPC sidecar (``ccx_torch.sidecar.server``) with the port's
client and returns its JSON line: every key of the JAX bench's
``FLEET_r*.json``, ``STEADY_r*.json`` or ``WIRE_r*.json``, plus the device,
the backend and the ``broker_aggregates`` launches of each phase. Every
"fresh compiles" key counts ``nvcc`` builds (``ccx_torch.common.
compilestats``). ``verified`` is the JAX run's own conjunction.

* ``run_fleet``: N cold Propose jobs of one config's clusters (other seeds
  of one spec) on the fleet scheduler: a prewarm job, the N jobs one after
  another, the N at once, then a second wave of N with a priority-10 job
  sent halfway through the concurrent phase's p50. Gates: every
  serialized and concurrent result verified, no kernel build in either.
* ``run_steady``: one session's warm loop from a cold result that the
  cluster applied: two un-timed warm windows, then N windows of the drift
  rule, each a metric-only delta put and a ``warm_start`` Propose. Gates:
  every window verified and warm-started, no kernel build in the measured
  loop.
* ``run_wire``: the cold leg (a streamed columnar cold Propose, its repeat
  and ``cold_down_s``: round trip minus ``wallSeconds`` minus the bank),
  then the warm windows split into snapshot-up, optimize, diff, assembly,
  frame-pack, bank, client-decode and the transport residual. The
  headline is the p50 of put + round trip - optimizer, in ms. Gates: as
  the steady loop's, and both cold results verified.

Deliberate differences from the JAX bench:

1. The fleet's prewarm runs cluster 0 alone. The JAX run proposes one
   cluster per shape bucket and then cluster 0 again, so that XLA compiles
   every bucket's programs outside the measured phases; the port compiles
   nothing per shape (its search is eager PyTorch and its one kernel is
   built once per process). The zero-compile gates stay, as zero ``nvcc``
   builds.
2. The fleet keeps the port's dispatch width, 1, when
   ``CCX_FLEET_DISPATCH_WIDTH`` is unset (JAX: the host's core count):
   launching threads of one process contend for the interpreter lock, and
   on the card two jobs at once take longer than the two in turn, so its
   ``speedup`` is reported, never gated. The residency cap is JAX's
   (``CCX_FLEET_MAX_CONCURRENT``, else the host's core count). Both are
   restored when the run ends.
3. The steady loop and the wire split start from a ``Served`` cold result
   (``runs.serve_cold``) and run on sessions of their own, seeded as the
   cold Propose would have seeded them: the applied placement put in full
   at generation 2 over the cold result banked at generation 1. So one cold
   Propose can seed both. The wire's cold repeat re-proposes the served
   cold session; ``repeat_cold=False`` reads the cold leg off the served
   Propose instead (the port pays no compile on the first one).

All run on the CUDA device unless the caller asks for another
(``device="cpu"``: the tests).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import statistics
import time

import numpy as np

from ccx_torch.bench.runs import Served, _capture, _p99, device_line, serve_cold
from ccx_torch.common import compilestats
from ccx_torch.device import resolve_device
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx_torch.model.snapshot import delta_encode, pack_arrays, to_msgpack
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import OptimizeOptions
from ccx_torch.rungs import drift_metrics, fleet_wire_options
from ccx_torch.search import incremental as incr
from ccx_torch.search.scheduler import FLEET
from ccx_torch.sidecar.server import OptimizerSidecar, freeze_gc_steady_state, make_grpc_server

log = logging.getLogger(__name__)

#: the drift rule's seeds of the steady loop and of the wire split (the
#: bench's)
STEADY_DRIFT_SEED, WIRE_DRIFT_SEED = 123, 321
#: un-timed warm windows before the measured ones: the first delta put
#: after a full one cannot graft (the registry builds the model on the
#: next Propose), so only the second exercises the graft
PREWARM_WINDOWS = 2
#: the fleet's spec seeds: ``spec.seed + FLEET_SEED_OFFSET + i`` (the bench's)
FLEET_SEED_OFFSET = 100
#: the preemption probe's priority
URGENT_PRIORITY = 10


def _served(name: str, device, served: Served | None, spec, goals, opts, warm_wire):
    """(served, own): the given cold result, or a fresh one that the caller
    must close."""
    if served is not None:
        return served, False
    return serve_cold(name, device, spec=spec, goals=goals, opts=opts, warm_wire=warm_wire), True


class _WarmSession:
    """A session seeded from a served cold result, as the JAX runs seed
    theirs: the cold result banked as the warm base at generation 1 and the
    applied placement put in full at generation 2; then drift windows, each
    a metric-only delta put and a ``warm_start`` Propose on the last base."""

    def __init__(self, served: Served, session: str, client, drift: float, seed: int) -> None:
        self.served, self.session, self.client = served, session, client
        self.warm_wire = {**served.cold_wire, **served.warm_wire}
        incr.remember(session, 1, served.m_applied, served.sidecar.goal_config)
        self.arrays = dict(served.applied)
        client.put_snapshot(None, session=session, generation=2,
                            packed=pack_arrays(self.arrays))
        self.gen, self.base_gen = 2, 1
        self.rng = np.random.default_rng(seed)
        self.p_real = int(served.m_applied.partition_valid.sum())
        self.n_drift = max(int(self.p_real * drift), 1)

    def put_drift(self) -> float:
        new = drift_metrics(self.arrays, self.rng, self.p_real, self.n_drift)
        packed = pack_arrays(delta_encode(self.arrays, new))
        t0 = time.monotonic()
        self.client.put_snapshot(None, session=self.session, generation=self.gen + 1,
                                 packed=packed, is_delta=True, base_generation=self.gen)
        put_s = time.monotonic() - t0
        self.gen += 1
        self.arrays = new
        return put_s

    def propose(self, timings: dict | None = None) -> tuple[dict, float]:
        t0 = time.monotonic()
        res = self.client.propose(session=self.session, goals=self.served.goal_names,
                                  columnar=True, warm_start=True, base_generation=self.base_gen,
                                  timings=timings, **self.warm_wire)
        rtt = time.monotonic() - t0
        self.base_gen = self.gen
        return res, rtt


def run_steady(name: str = "B5", n_iters: int = 20, drift: float = 0.01, *, device=None,
               served: Served | None = None, spec: RandomClusterSpec | None = None,
               goals: tuple[str, ...] | None = None, opts: OptimizeOptions | None = None,
               warm_wire: dict | None = None) -> dict:
    """The steady-state warm loop through the sidecar (module docstring).
    With ``served`` the loop starts from that cold result; else it makes its
    own (``spec``, ``goals``, ``opts`` and ``warm_wire`` as
    ``runs.serve_cold`` takes them) and stops its sidecar at the end."""
    with _capture():
        served, own = _served(name, device, served, spec, goals, opts, warm_wire)
        try:
            return _steady(served, max(int(n_iters), 1), drift)
        finally:
            if own:
                served.close()


def _steady(served: Served, n_iters: int, drift: float) -> dict:
    from ccx_torch.sidecar.client import SidecarClient

    name, sidecar = served.name, served.sidecar
    session = f"steady-{name}"
    client = SidecarClient(served.address)
    launches: dict = {"cold": served.cold_launches}
    try:
        s = _WarmSession(served, session, client, drift, STEADY_DRIFT_SEED)

        def window() -> dict:
            n0 = agg_op.LAUNCHES
            put_s = s.put_drift()
            res, rtt = s.propose()
            return {"wall": rtt, "put_s": put_s, "verified": bool(res["verified"]),
                    "proposals": int(res["numProposals"]),
                    "incremental": res.get("incremental"),
                    "convergence": res.get("convergence"),
                    "launches": agg_op.LAUNCHES - n0}

        n0 = agg_op.LAUNCHES
        for _ in range(PREWARM_WINDOWS):
            r = window()
        launches["prewarm"] = agg_op.LAUNCHES - n0
        log.info("steady: prewarm window %.2fs inc=%s", r["wall"], r["incremental"])

        freeze_gc_steady_state()
        cs0 = compilestats.snapshot()
        n0 = agg_op.LAUNCHES
        windows = []
        for i in range(n_iters):
            r = window()
            windows.append(r)
            log.info("steady: window %d/%d put=%.0fms warm=%.0fms verified=%s diff=%d",
                     i + 1, n_iters, r["put_s"] * 1e3, r["wall"] * 1e3, r["verified"],
                     r["proposals"])
        launches["measured"] = agg_op.LAUNCHES - n0
        warm_compiles = compilestats.delta(cs0, compilestats.snapshot())
        reg, store = sidecar.registry.stats(), incr.STORE.stats()
    finally:
        client.close()
        incr.STORE.drop(session)
    zero_warm = warm_compiles["backend_compiles"] == 0
    walls = sorted(r["wall"] for r in windows)
    p50 = statistics.median(walls)
    p99 = _p99(walls)
    all_verified = all(r["verified"] for r in windows)
    all_warm = all((r["incremental"] or {}).get("warmStart") for r in windows)
    return {
        "metric": (
            f"{name} steady-state warm re-proposal wall through the sidecar "
            f"({drift:.0%} metrics drift per window, p99)"
        ),
        "value": round(p99, 3),
        "unit": "s",
        "vs_baseline": round(served.cold_s / max(p50, 1e-9), 1),
        "steady": True,
        "config": name,
        "n_iters": len(windows),
        "drift_fraction": drift,
        "backend": served.device.type,
        "device": device_line(served.device),
        "host_cores": os.cpu_count(),
        "verified": bool(all_verified and all_warm and zero_warm),
        "cold_s": round(served.cold_s, 2),
        "warm": {
            "p50_s": round(p50, 3),
            "p99_s": round(p99, 3),
            "mean_s": round(statistics.mean(walls), 3),
            "walls": [round(w, 3) for w in walls],
        },
        "put_delta_s": round(statistics.median(r["put_s"] for r in windows), 3),
        "diff_rows": int(statistics.median(r["proposals"] for r in windows)),
        "all_warm_started": all_warm,
        "zero_warm_fresh_compiles": zero_warm,
        "compile_cache": {"measured": warm_compiles},
        "incremental": windows[-1]["incremental"],
        "convergence": windows[-1]["convergence"],
        "registry": reg,
        "store": store,
        "launches": {"broker_aggregates": launches},
        "launches_per_window": [r["launches"] for r in windows],
        "effort": {**served.warm_wire, "cold": served.cold_effort, "n_iters": len(windows),
                   "drift": drift},
    }


def run_wire(name: str = "B5", n_iters: int = 20, drift: float = 0.01, *, device=None,
             served: Served | None = None, repeat_cold: bool = True,
             spec: RandomClusterSpec | None = None, goals: tuple[str, ...] | None = None,
             opts: OptimizeOptions | None = None, warm_wire: dict | None = None) -> dict:
    """The sidecar's result-path split (module docstring). ``served`` and
    the size overrides as ``run_steady`` takes them; ``repeat_cold=False``
    takes the cold leg from the served cold Propose instead of a repeat."""
    with _capture():
        served, own = _served(name, device, served, spec, goals, opts, warm_wire)
        try:
            return _wire(served, max(int(n_iters), 1), drift, repeat_cold)
        finally:
            if own:
                served.close()


def _wire(served: Served, n_iters: int, drift: float, repeat_cold: bool) -> dict:
    from ccx_torch.sidecar.client import SidecarClient

    name, sidecar = served.name, served.sidecar
    session = f"wire-{name}"
    client = SidecarClient(served.address)
    launches: dict = {"cold": served.cold_launches}
    try:
        # the cold leg: the served cold Propose, then its repeat on the same
        # generation (the comparable proposals-down number)
        if repeat_cold:
            cold_t: dict = {}
            n0 = agg_op.LAUNCHES
            t0 = time.monotonic()
            cold2 = client.propose(session=served.ref, goals=served.goal_names, columnar=True,
                                   timings=cold_t, **served.cold_wire)
            cold_rtt = time.monotonic() - t0
            launches["cold_repeat"] = agg_op.LAUNCHES - n0
        else:
            cold2, cold_t, cold_rtt = served.cold_res, served.cold_timings, served.cold_s
        cold_ws = cold2.get("wireSeconds") or {}
        cold_down_s = cold_rtt - float(cold2["wallSeconds"]) - float(cold_ws.get("bank", 0.0))
        log.info("wire: cold %.1fs, repeat %.1fs, down %.0fms, rows %d, segments %s",
                 served.cold_s, cold_rtt, cold_down_s * 1e3, cold2["numProposals"],
                 cold_t.get("segments"))

        s = _WarmSession(served, session, client, drift, WIRE_DRIFT_SEED)

        def window() -> dict:
            n0 = agg_op.LAUNCHES
            put_s = s.put_drift()
            t: dict = {}
            res, rtt = s.propose(timings=t)
            phases = res.get("phaseSeconds") or {}
            ws = res.get("wireSeconds") or {}
            diff_s = float(phases.get("diff", 0.0))
            wall = float(res["wallSeconds"])
            optimizer_s = wall - diff_s
            assembly_s = float(ws.get("assembly", 0.0))
            pack_s = float(ws.get("pack", 0.0))
            bank_s = float(ws.get("bank", 0.0))
            decode_s = float(t.get("decode_s", 0.0))
            return {
                "wire_s": put_s + rtt - optimizer_s,
                "rtt_s": rtt,
                "put_s": put_s,
                "diff_s": diff_s,
                "assembly_s": assembly_s,
                "pack_s": pack_s,
                "bank_s": bank_s,
                "decode_s": decode_s,
                # gRPC, the frame relay and queueing: what is left of the
                # hop once the in-server result work is accounted
                "transport_s": max(rtt - wall - assembly_s - pack_s - bank_s - decode_s, 0.0),
                "optimizer_s": optimizer_s,
                "verified": bool(res["verified"]),
                "warm": bool((res.get("incremental") or {}).get("warmStart")),
                "rows": int(res["numProposals"]),
                "segments": int(t.get("segments", 0)),
                "launches": agg_op.LAUNCHES - n0,
            }

        n0 = agg_op.LAUNCHES
        for _ in range(PREWARM_WINDOWS):
            r = window()
        launches["prewarm"] = agg_op.LAUNCHES - n0
        log.info("wire: prewarm window %.0fms", r["wire_s"] * 1e3)

        freeze_gc_steady_state()
        cs0 = compilestats.snapshot()
        n0 = agg_op.LAUNCHES
        windows = []
        for i in range(n_iters):
            r = window()
            windows.append(r)
            log.info("wire: window %d/%d wire=%.1fms put=%.1f diff=%.1f asm=%.1f pack=%.1f "
                     "dec=%.1f tspt=%.1f rows=%d", i + 1, n_iters, r["wire_s"] * 1e3,
                     r["put_s"] * 1e3, r["diff_s"] * 1e3, r["assembly_s"] * 1e3,
                     r["pack_s"] * 1e3, r["decode_s"] * 1e3, r["transport_s"] * 1e3, r["rows"])
        launches["measured"] = agg_op.LAUNCHES - n0
        warm_compiles = compilestats.delta(cs0, compilestats.snapshot())
        reg = sidecar.registry.stats()
    finally:
        client.close()
        incr.STORE.drop(session)
    zero_warm = warm_compiles["backend_compiles"] == 0
    wires = sorted(w["wire_s"] for w in windows)
    p50 = statistics.median(wires)
    p99 = _p99(wires)
    all_verified = all(w["verified"] for w in windows)
    all_warm = all(w["warm"] for w in windows)

    def med(key: str) -> float:
        return round(statistics.median(w[key] for w in windows) * 1e3, 2)

    return {
        "metric": (
            f"{name} warm end-to-end sidecar round-trip, optimizer excluded "
            f"({drift:.0%} drift windows, streamed columnar, p50)"
        ),
        "value": round(p50 * 1e3, 2),
        "unit": "ms",
        "vs_baseline": round(cold_down_s / max(p50, 1e-9), 1),
        "wire": True,
        "config": name,
        "n_iters": len(windows),
        "drift_fraction": drift,
        "backend": served.device.type,
        "device": device_line(served.device),
        "host_cores": os.cpu_count(),
        "verified": bool(all_verified and all_warm and zero_warm
                         and bool(served.cold_res["verified"]) and bool(cold2["verified"])),
        "warm_ms": {
            "p50": round(p50 * 1e3, 2),
            "p99": round(p99 * 1e3, 2),
            "values": [round(w * 1e3, 2) for w in wires],
        },
        "split_ms": {
            "put": med("put_s"),
            "optimize": med("optimizer_s"),
            "diff": med("diff_s"),
            "assembly": med("assembly_s"),
            "pack": med("pack_s"),
            "bank": med("bank_s"),
            "decode": med("decode_s"),
            "transport": med("transport_s"),
        },
        "cold": {
            "encode_s": round(served.encode_s, 3),
            "put_full_s": round(served.put_full_s, 3),
            "first_rtt_s": round(served.cold_s, 2),
            "rtt_s": round(cold_rtt, 2),
            "down_s": round(cold_down_s, 3),
            "rows": int(cold2["numProposals"]),
            "segments": int(cold_t.get("segments", 0)),
            "snapshot_mb": round(served.snapshot_bytes / 1e6, 2),
            "assembly_s": round(float(cold_ws.get("assembly", 0.0)), 4),
            "pack_s": round(float(cold_ws.get("pack", 0.0)), 4),
            "bank_s": round(float(cold_ws.get("bank", 0.0)), 4),
            "decode_s": round(float(cold_t.get("decode_s", 0.0)), 4),
            "repeated": repeat_cold,
        },
        "cold_down_s": round(cold_down_s, 3),
        "diff_rows": int(statistics.median(w["rows"] for w in windows)),
        "segments": int(windows[-1]["segments"]),
        "all_warm_started": all_warm,
        "zero_warm_fresh_compiles": zero_warm,
        "compile_cache": {"measured": warm_compiles},
        "registry": reg,
        "launches": {"broker_aggregates": launches},
        "launches_per_window": [w["launches"] for w in windows],
        "effort": {**served.warm_wire, "cold": served.cold_effort, "n_iters": len(windows),
                   "drift": drift},
    }


def run_fleet(name: str = "B3", n_jobs: int = 16, *, device=None,
              options: dict | None = None, spec: RandomClusterSpec | None = None,
              goals: tuple[str, ...] | None = None) -> dict:
    """N concurrent cold Propose jobs on the fleet scheduler (module
    docstring). ``options`` (default ``rungs.fleet_wire_options()``) are the
    jobs' Propose keys; ``spec`` and ``goals`` replace the config's fixture
    and the server's default stack (the tests' small sizes).
    ``CCX_FLEET_MAX_CONCURRENT`` caps resident jobs (default: the host's
    core count, as the JAX bench) and ``CCX_FLEET_DISPATCH_WIDTH`` sets the
    dispatch width (default the port's, 1); both are restored when the run
    ends."""
    from ccx_torch.search import scheduler

    env_conc = os.environ.get("CCX_FLEET_MAX_CONCURRENT")
    max_conc = int(env_conc) if env_conc else (os.cpu_count() or 2)
    prev = FLEET.max_concurrent, FLEET.dispatch_width
    scheduler.configure(max_concurrent=max_conc,
                        dispatch_width=int(os.environ.get("CCX_FLEET_DISPATCH_WIDTH", "0")))
    try:
        with _capture():
            return _fleet(name, max(int(n_jobs), 1), resolve_device(device),
                          fleet_wire_options() if options is None else dict(options),
                          spec or bench_spec(name), goals or (), max_conc)
    finally:
        FLEET.max_concurrent, FLEET.dispatch_width = prev


def _fleet(name: str, n_jobs: int, dev, options: dict, spec: RandomClusterSpec,
           goal_names: tuple[str, ...], max_conc: int) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from ccx_torch.search.state import max_partitions_per_topic
    from ccx_torch.sidecar.client import SidecarClient

    models = [random_cluster(dataclasses.replace(spec, seed=spec.seed + FLEET_SEED_OFFSET + i),
                             device=dev) for i in range(n_jobs)]
    buckets: dict = {}
    for i, m in enumerate(models):
        buckets.setdefault((int(m.P), int(m.B), max_partitions_per_topic(m)), []).append(i)
    log.info("fleet: %d %s clusters in %d shape bucket(s)", n_jobs, name, len(buckets))

    sidecar = OptimizerSidecar(device=dev)
    server, port = make_grpc_server(sidecar, address="127.0.0.1:0", max_workers=n_jobs + 8)
    server.start()
    client = SidecarClient(f"127.0.0.1:{port}")
    launches: dict = {}

    def propose(i: int, priority: int = 0) -> dict:
        t0 = time.monotonic()
        res = client.propose(session=f"fleet-{i}", goals=goal_names, columnar=True,
                             cluster_id=f"fleet-{i}", priority=priority, **options)
        return {"wall": time.monotonic() - t0, "verified": bool(res["verified"]),
                "proposals": int(res["numProposals"])}

    def phase(key: str, fn):
        """``fn()`` and its seconds; the kernel launches of every handler
        thread while it ran are counted under ``key`` (the jobs have
        returned when it does)."""
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        out = fn()
        seconds = time.monotonic() - t0
        launches[key] = agg_op.LAUNCHES - n0
        return out, seconds

    try:
        for i, m in enumerate(models):
            client.put_snapshot(None, session=f"fleet-{i}", generation=1, packed=to_msgpack(m),
                                cluster_id=f"fleet-{i}")

        # prewarm: cluster 0 alone (module docstring)
        prewarm, cold_s = phase("prewarm", lambda: propose(0))
        log.info("fleet: prewarm %.1fs verified=%s", cold_s, prewarm["verified"])

        # the serialized baseline: one job at a time
        cs0 = compilestats.snapshot()
        serial, serialized_s = phase("serialized", lambda: [propose(i) for i in range(n_jobs)])
        cs1 = compilestats.snapshot()
        serial_compiles = compilestats.delta(cs0, cs1)
        log.info("fleet: serialized %d jobs %.1fs", n_jobs, serialized_s)

        # concurrent: every job at once on the scheduler
        FLEET.reset_stats()

        def wave() -> list:
            with ThreadPoolExecutor(n_jobs) as ex:
                return list(ex.map(propose, range(n_jobs)))

        conc, concurrent_s = phase("concurrent", wave)
        sched = FLEET.stats()
        conc_compiles = compilestats.delta(cs1, compilestats.snapshot())
        walls = sorted(r["wall"] for r in conc)
        p50 = statistics.median(walls)
        p99 = _p99(walls)
        log.info("fleet: concurrent %d jobs %.1fs p50=%.2fs p99=%.2fs occupancy=%s depth=%s",
                 n_jobs, concurrent_s, p50, p99, sched["occupancy"], sched["meanDepth"])

        # preemption probe: an urgent job sent while a second wave runs
        def preempt() -> tuple[dict, list]:
            with ThreadPoolExecutor(n_jobs + 1) as ex:
                pending = [ex.submit(propose, i) for i in range(n_jobs)]
                time.sleep(max(p50 * 0.5, 0.2))
                t0 = time.monotonic()
                urgent = propose(0, priority=URGENT_PRIORITY)
                urgent["submitted_mid_wave_s"] = round(time.monotonic() - t0, 3)
                return urgent, [f.result() for f in pending]

        (urgent, wave2), _ = phase("preempt", preempt)
        wave_walls = [r["wall"] for r in wave2]
        log.info("fleet: urgent mid-wave %.2fs against the wave's p50 %.2fs", urgent["wall"],
                 statistics.median(wave_walls))
        reg = sidecar.registry.stats()
    finally:
        client.close()
        server.stop(0).wait(30)
        for i in range(n_jobs):
            incr.STORE.drop(f"fleet-{i}")
    zero_warm = (serial_compiles["backend_compiles"] == 0
                 and conc_compiles["backend_compiles"] == 0)
    all_verified = all(r["verified"] for r in serial + conc)
    speedup = serialized_s / max(concurrent_s, 1e-9)
    return {
        "metric": (
            f"{name} fleet serving: {n_jobs} concurrent Propose streams through the sidecar "
            "(p99 latency)"
        ),
        "value": round(p99, 3),
        "unit": "s",
        "vs_baseline": round(speedup, 3),
        "fleet": True,
        "config": name,
        "n_jobs": n_jobs,
        "backend": dev.type,
        "device": device_line(dev),
        "host_cores": os.cpu_count(),
        "verified": bool(all_verified and zero_warm),
        "latency": {
            "p50_s": round(p50, 3),
            "p99_s": round(p99, 3),
            "mean_s": round(statistics.mean(walls), 3),
            "walls": [round(w, 3) for w in walls],
        },
        "throughput_per_min": round(n_jobs / concurrent_s * 60.0, 2),
        "serialized_throughput_per_min": round(n_jobs / serialized_s * 60.0, 2),
        "serialized_s": round(serialized_s, 2),
        "concurrent_s": round(concurrent_s, 2),
        "speedup": round(speedup, 3),
        "occupancy": sched["occupancy"],
        "mean_depth": sched["meanDepth"],
        "chunks_granted": sched["chunksGranted"],
        "urgent": {
            "wall_s": round(urgent["wall"], 3),
            "wave_p50_s": round(statistics.median(wave_walls), 3),
            "verified": urgent["verified"],
            "submitted_mid_wave_s": urgent["submitted_mid_wave_s"],
            "wave_verified": all(r["verified"] for r in wave2),
        },
        "cold_s": round(cold_s, 2),
        "compile_cache": {"serialized": serial_compiles, "concurrent": conc_compiles},
        "zero_warm_fresh_compiles": zero_warm,
        "registry": reg,
        "shape_buckets": len(buckets),
        "launches": {"broker_aggregates": launches},
        "effort": {**options, "n_jobs": n_jobs, "max_concurrent": max_conc,
                   "dispatch_width": FLEET.dispatch_width},
        "proposals_per_job": int(statistics.median(r["proposals"] for r in conc)),
    }
