"""The scenario corpus, the chaos run, the soak and the steady fleet, through
the port's gRPC sidecar.

Ports of the JAX bench's ``run_scenario``, ``run_chaos``, ``run_soak`` and
``run_steady_fleet`` (``bench.py``, ``--scenario``, ``--chaos``, ``--soak``
and ``--steady-fleet``). Each drives a real loopback gRPC sidecar
(``ccx_torch.sidecar.server``) with the port's client and returns its JSON
line (every key of the JAX bench's ``SCENARIO_r*.json``, ``CHAOS_r*.json``,
``SOAK_r*.json`` or ``STEADYFLEET_r*.json``, plus the device, the backend
and the ``broker_aggregates`` launches of the run). ``verified`` is the
conjunction of the run's gates.

* ``run_scenario``: every family of ``ccx_torch.bench.scenarios`` runs as
  cumulative delta-snapshot windows against the applied cold result, each
  answered by a warm Propose. Gates: every window verified and warm-started,
  every family inside its envelope, a clean steady baseline that is ok, at
  least one anomaly-verb family recovering warm within 2x the clean p50,
  and zero kernel builds in the measured loops.
* ``run_chaos``: the steady drift loop with one seam class of
  ``ccx_torch.common.faults`` killed per window (``CHAOS_SCENARIOS``,
  cycled). Gates: every window recovered, no stuck scheduler job, no leaked
  registry or store session, recovery walls within their bounds, and a
  disarmed epilogue that is warm, verified and builds no kernel.
* ``run_soak``: the closed loop. N clusters seeded from one applied cold
  result drift on a simulated fleet clock (``observability.slo.window.seconds``
  a tick); every served window's signals (warm and verified outcome, wall,
  dead brokers, banked pressure band, the ledger's verdict, fault
  attribution) feed ``ccx_torch.detector.stream.StreamDetector``, which
  opens healing episodes and fires the healer (an urgent warm re-Propose)
  once each. The run only injects (``SOAK_INJECTIONS`` on
  ``soak_schedule``: a broker killed for two ticks, a killed warm-base
  bank). Gates: at least 30 simulated fleet-minutes, every episode fired
  and recovered, the episode census equal to the injection census,
  time-to-heal p99 within ``(inject_dur + 2)`` windows, the SLOs met, flat
  device memory (budget kept in every sample, second-half peak within 5%
  + 1 MB of the first half's), zero kernel builds in the measured loop,
  every window served, no stuck job, no leaked session.
* ``run_steady_fleet``: N warm clusters on one sidecar under the
  device-memory ledger: cold converges at the fleet rung, the results
  applied, two prewarm windows each, a serialized single-session baseline,
  then every cluster's windows at once. Gates: every window verified and
  warm-started, zero kernel builds in the measured loop, the ledger's
  budget kept in every per-window sample.

Deliberate differences from the JAX bench:

1. Its scenario and soak runs replay windows on throwaway sessions before
   they measure (the scenario run the whole family x window matrix, the
   soak every injection kind), only so that XLA compiles every program
   outside the measured loop. The port compiles nothing per shape (its
   search is eager PyTorch and its one kernel is built once per process),
   so the replays are dropped; the two metric prewarm windows stay. The
   zero-compile gates stay, as zero ``nvcc`` builds (``compilestats``).
   The soak's leak gate then counts exactly the sessions the port's run
   opens: the registry and the store each hold what they held before plus
   the clusters (on a fresh sidecar: the cold ref and the clusters, and
   the clusters alone), an equality as in the JAX bench.
2. The steady fleet keeps the port's dispatch width, 1, when
   ``CCX_FLEET_DISPATCH_WIDTH`` is unset, where the JAX default is the
   host's core count: launching threads of one process contend for the
   interpreter lock, and a wider dispatch measured slower on the card.
   The line records the width used.

``serve_cold`` brings up the sidecar and runs the cold Propose; the
scenario, chaos and soak runs take its ``Served`` so that one cold Propose
can seed several (each run then seeds its own sessions from the applied
result). Every run restores the process-wide state it changes (armed
faults, the cost capture, the fleet scheduler's settings); the soak and the
steady fleet also drop the warm bases of the sessions they opened. All run
on the CUDA device unless the caller asks for another (``device="cpu"``:
the tests).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from ccx_torch.bench import scenarios as sc
from ccx_torch.common import compilestats, costmodel, faults
from ccx_torch.device import resolve_device
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx_torch.model.snapshot import delta_encode, model_to_arrays, pack_arrays, to_msgpack
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import OptimizeOptions
from ccx_torch.rungs import (
    build_opts, drift_metrics, effort_of, fleet_wire_options, steady_wire_options, wire_options,
)
from ccx_torch.search import incremental as incr
from ccx_torch.search.scheduler import FLEET
from ccx_torch.sidecar.server import OptimizerSidecar, freeze_gc_steady_state, make_grpc_server

log = logging.getLogger(__name__)

#: the chaos run's per-window fault scenarios (``ccx_torch.common.faults``
#: spec grammar), cycled in order — every seam CLASS of the warm serving path
#: is killed/severed/corrupted at least once per cycle. Ordering is load-
#: bearing in one place: ``placement.bank`` sits immediately before
#: ``compile`` so the window after a killed bank (which must COLD-start —
#: the store no longer has its base) exercises the cold-pipeline kill +
#: client retry on the very next window.
CHAOS_SCENARIOS = (
    ("rpc.frame:sever@3", "sever the stream mid-flight"),
    ("rpc.frame:corrupt@2", "corrupt a stream frame"),
    ("scheduler.grant:raise@1", "kill the engine mid-wave"),
    ("registry.graft:raise@1;snapshot.transfer:exhaust@1",
     "kill the delta graft, then HBM-pressure the rebuild"),
    ("device.diff:raise@1", "kill the compiled device diff"),
    ("placement.bank:raise@1", "kill the warm-base bank"),
    ("compile:raise@1", "kill the cold pipeline entry"),
)

#: the drift rule's seed for the scenario run's metric windows (the bench's)
SCENARIO_DRIFT_SEED = 123


@dataclasses.dataclass
class Served:
    """A sidecar on loopback gRPC and one converged cold result: what a run
    starts from. ``applied`` and ``m_applied`` are the cold model with the
    result's placement written back (the cluster after the proposal was
    executed); ``cold_wire`` and ``warm_wire`` are the Propose options of a
    cold and a warm request; ``ref`` is the cold Propose's session."""

    name: str
    device: torch.device
    sidecar: OptimizerSidecar
    server: object
    address: str
    goal_names: tuple[str, ...]
    cold_wire: dict
    warm_wire: dict
    cold_effort: dict
    cold_res: dict
    cold_s: float
    cold_launches: int
    m_applied: TensorClusterModel
    applied: dict
    ref: str
    #: the full put of the cold fixture: msgpack seconds, put seconds and
    #: bytes, and the cold Propose's client-side timings (decode seconds,
    #: frames, segments)
    encode_s: float = 0.0
    put_full_s: float = 0.0
    snapshot_bytes: int = 0
    cold_timings: dict = dataclasses.field(default_factory=dict)

    def close(self) -> None:
        self.server.stop(0).wait(30)


def serve_cold(name: str, device=None, *, spec: RandomClusterSpec | None = None,
               goals: tuple[str, ...] | None = None, opts: OptimizeOptions | None = None,
               warm_wire: dict | None = None) -> Served:
    """Start the sidecar, put config ``name``'s fixture and run one cold
    Propose at its target rung. ``spec``, ``goals`` and ``opts`` replace the
    config's fixture, goal stack and rung (the tests' small sizes);
    ``warm_wire`` (default: the steady rung's keys) is what the runs' warm
    Proposes send over the cold options."""
    from ccx_torch.sidecar.client import SidecarClient

    dev = resolve_device(device)
    m0 = random_cluster(spec or bench_spec(name), device=dev)
    goal_names, cold_opts, _ = build_opts(name, "target")
    goal_names = goals or goal_names
    cold_opts = opts or cold_opts
    cold_effort = effort_of(cold_opts)
    cold_wire = wire_options(cold_opts)
    sidecar = OptimizerSidecar(device=dev)
    server, port = make_grpc_server(sidecar, address="127.0.0.1:0")
    server.start()
    address = f"127.0.0.1:{port}"
    ref = f"runs-{name}-ref"
    cold_timings: dict = {}
    try:
        with SidecarClient(address) as client:
            t0 = time.monotonic()
            packed = to_msgpack(m0)
            encode_s = time.monotonic() - t0
            t0 = time.monotonic()
            client.put_snapshot(None, session=ref, generation=1, packed=packed)
            put_full_s = time.monotonic() - t0
            n0 = agg_op.LAUNCHES
            t0 = time.monotonic()
            cold_res = client.propose(session=ref, goals=goal_names, columnar=True,
                                      timings=cold_timings, **cold_wire)
            cold_s = time.monotonic() - t0
            cold_launches = agg_op.LAUNCHES - n0
        warm_base = incr.STORE.get(ref)
        if warm_base is None:
            raise RuntimeError("the sidecar banked no warm base: is CCX_INCREMENTAL=0 set?")
        m_applied = m0.replace(
            assignment=warm_base.assignment, leader_slot=warm_base.leader_slot,
            replica_disk=warm_base.replica_disk,
        )
    except BaseException:
        server.stop(0).wait(30)
        raise
    log.info("cold propose %.1fs verified=%s", cold_s, cold_res["verified"])
    return Served(
        name=name, device=dev, sidecar=sidecar, server=server, address=address,
        goal_names=goal_names, cold_wire=cold_wire,
        warm_wire=steady_wire_options() if warm_wire is None else dict(warm_wire),
        cold_effort=cold_effort, cold_res=cold_res, cold_s=cold_s,
        cold_launches=cold_launches, m_applied=m_applied,
        applied=model_to_arrays(m_applied), ref=ref, encode_s=encode_s,
        put_full_s=put_full_s, snapshot_bytes=len(packed), cold_timings=cold_timings,
    )


def device_line(dev: torch.device) -> dict:
    """The card a run used: torch's name for it and ``nvidia-smi``'s name and
    power limit (None where the tool is missing); ``{"kind": "cpu"}`` on
    the host."""
    if dev.type != "cuda":
        return {"kind": dev.type}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"kind": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def _p99(walls: list) -> float:
    walls = sorted(walls)
    return walls[min(int(round(0.99 * (len(walls) - 1))), len(walls) - 1)]


@contextlib.contextmanager
def _capture():
    """The cost ledger's first-call capture armed for a run (as the JAX
    bench arms it; ``CCX_COST_CAPTURE=0`` opts out), restored after."""
    prev = costmodel.capture_enabled()
    if os.environ.get(costmodel.ENV_CAPTURE) != "0":
        costmodel.set_capture(True)
    try:
        yield
    finally:
        costmodel.set_capture(prev)


def _captures() -> int:
    """First-call captures taken so far (recorded and pending)."""
    return len(costmodel.records()) + costmodel.pending_count()


def run_scenario(name: str = "B5", windows: int | None = None, seed: int | None = None,
                 families: tuple[str, ...] = (), *, device=None,
                 served: Served | None = None) -> dict:
    """The scenario corpus through the sidecar's warm path (module
    docstring). The corpus knobs resolve through the ``optimizer.scenario.*``
    config keys, so a bad family fails before the cold solve. With
    ``served`` the run starts from that cold result; else it makes its own
    and stops its sidecar at the end."""
    from ccx_torch.config import CruiseControlConfig

    props: dict = {}
    if windows is not None:
        props["optimizer.scenario.windows"] = int(windows)
    if seed is not None:
        props["optimizer.scenario.seed"] = int(seed)
    if families:
        props["optimizer.scenario.families"] = ",".join(families)
    sopts = sc.ScenarioOptions.from_config(CruiseControlConfig(props))
    with _capture():
        own = served is None
        if own:
            served = serve_cold(name, device)
        try:
            return _scenario(served, sopts)
        finally:
            if own:
                served.close()


def _scenario(served: Served, sopts: sc.ScenarioOptions) -> dict:
    from ccx_torch.sidecar.client import SidecarClient

    name, sidecar = served.name, served.sidecar
    goal_names, warm_wire = served.goal_names, {**served.cold_wire, **served.warm_wire}
    applied, m_applied = served.applied, served.m_applied
    clean_after = sc.goals_after(served.cold_res.get("goalSummary"))
    base_key = sc.shape_key(applied)
    client = SidecarClient(served.address)

    def session(fam: str) -> str:
        return f"scenario-{name}-{fam}"

    # every family session starts from the applied clean state; its warm
    # base is banked directly in the store (the entry a cold Propose would
    # bank), and every measured window goes through the gRPC hop
    for fam in sopts.families:
        client.put_snapshot(None, session=session(fam), generation=1,
                            packed=pack_arrays(applied), cluster_id=session(fam))
        incr.remember(session(fam), 1, m_applied, sidecar.goal_config)

    rng = np.random.default_rng(SCENARIO_DRIFT_SEED)
    p_real = int(served.m_applied.partition_valid.sum())
    n_drift = max(int(p_real * 0.01), 1)

    def drive(sess: str, prev: dict, new: dict, gen: int, base_gen: int) -> dict:
        """One window end to end: delta put and warm Propose; the wall is
        the recovery latency."""
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        client.put_snapshot(None, session=sess, generation=gen, base_generation=gen - 1,
                            packed=pack_arrays(delta_encode(prev, new)), is_delta=True)
        res = client.propose(session=sess, goals=goal_names, columnar=True, warm_start=True,
                             base_generation=base_gen, cluster_id=sess, **warm_wire)
        inc = res.get("incremental") or {}
        return {
            "wall_s": round(time.monotonic() - t0, 3),
            "verified": bool(res["verified"]),
            "warm": bool(inc.get("warmStart")),
            "cold_fallback": bool(inc.get("coldStart")),
            "rows": int(res["numProposals"]),
            "goals_after": sc.goals_after(res.get("goalSummary")),
            "verification_failures": list(res.get("verificationFailures") or ()),
            "launches": agg_op.LAUNCHES - n0,
        }

    try:
        # prewarm: two metric windows on a throwaway session (no matrix
        # replay: module docstring)
        pw = f"scenario-{name}-prewarm"
        client.put_snapshot(None, session=pw, generation=1, packed=pack_arrays(applied),
                            cluster_id=pw)
        incr.remember(pw, 1, m_applied, sidecar.goal_config)
        pw_arrays, pw_base = dict(applied), 1
        for pw_gen in (2, 3):
            new = drift_metrics(pw_arrays, rng, p_real, n_drift)
            drive(pw, pw_arrays, new, pw_gen, pw_base)
            pw_arrays, pw_base = new, pw_gen

        # clean steady baseline on a session of its own, seeded as the
        # families are: 2 windows that graft, then 3 measured
        freeze_gc_steady_state()
        ref = f"scenario-{name}-clean"
        client.put_snapshot(None, session=ref, generation=1, packed=pack_arrays(applied),
                            cluster_id=ref)
        incr.remember(ref, 1, m_applied, sidecar.goal_config)
        ref_arrays, ref_gen, ref_base = dict(applied), 1, 1
        clean_walls, clean_ok = [], True
        for i in range(5):
            new = drift_metrics(ref_arrays, rng, p_real, n_drift)
            ref_gen += 1
            w = drive(ref, ref_arrays, new, ref_gen, ref_base)
            ref_arrays = new
            # the base advances only on a verified window (the server banks
            # nothing otherwise); an unverified clean window fails the run
            if w["verified"]:
                ref_base = ref_gen
            if i >= 2:
                clean_walls.append(w["wall_s"])
                clean_ok = clean_ok and w["verified"] and w["warm"]
        clean_p50 = statistics.median(clean_walls)
        log.info("clean steady p50 %.0fms ok=%s", clean_p50 * 1e3, clean_ok)

        # the measured family x window matrix
        cs0, cap0 = compilestats.snapshot(), _captures()
        fam_out: dict = {}
        for fam in sopts.families:
            sess = session(fam)
            arrays, gen, base_gen = dict(applied), 1, 1
            windows_out = []
            t_gen = time.monotonic()
            family_windows = sc.generate(fam, applied, sopts)
            gen_s = time.monotonic() - t_gen
            for w in family_windows:
                gen += 1
                r = drive(sess, arrays, w.arrays, gen, base_gen)
                arrays = w.arrays
                # the server banks the next base only on a verified result;
                # an unverified window must not advance base_gen
                if r["verified"]:
                    base_gen = gen
                env_fail = sc.check_envelope(fam, clean_after, r.pop("goals_after"))
                r.update(label=w.label, structural=w.structural, envelope_failures=env_fail)
                windows_out.append(r)
                log.info("%s [%s]: wall=%ss verified=%s warm=%s rows=%s env=%s", fam, w.label,
                         r["wall_s"], r["verified"], r["warm"], r["rows"],
                         "ok" if not env_fail else env_fail)
            walls = sorted(x["wall_s"] for x in windows_out)
            fam_out[fam] = {
                "verb": sc.ANOMALY_VERB[fam],
                "windows": len(windows_out),
                "p50_s": round(statistics.median(walls), 3),
                "p99_s": round(_p99(walls), 3),
                "walls": walls,
                "all_verified": all(x["verified"] for x in windows_out),
                "all_warm": all(x["warm"] for x in windows_out),
                "envelope_ok": all(not x["envelope_failures"] for x in windows_out),
                "generate_s": gen_s,
                "launches": {"broker_aggregates": sum(x["launches"] for x in windows_out)},
                "window_detail": windows_out,
            }
        warm_compiles = compilestats.delta(cs0, compilestats.snapshot())
        captures = _captures() - cap0
    finally:
        client.close()
    zero_measured = warm_compiles["backend_compiles"] == 0

    all_verified = all(f["all_verified"] for f in fam_out.values())
    all_warm = all(f["all_warm"] for f in fam_out.values())
    all_env = all(f["envelope_ok"] for f in fam_out.values())
    # the headline gate: at least one anomaly-verb family recovering warm
    # within 2x the clean steady p50; not applicable when the family subset
    # holds no verb-mapped family
    warm_limit = 2.0 * clean_p50
    warm_recovered = sorted(
        fam for fam, f in fam_out.items()
        if f["verb"] and f["all_warm"] and f["all_verified"] and f["p50_s"] <= warm_limit
    )
    warm_gate_applicable = any(f["verb"] for f in fam_out.values())
    all_walls = sorted(w for f in fam_out.values() for w in f["walls"])
    p50_all = statistics.median(all_walls)
    p99_all = _p99(all_walls)
    return {
        "metric": (
            f"{name} scenario-corpus recovery: adversarial structural/elasticity windows "
            f"through the sidecar warm path ({len(fam_out)} families x {sopts.windows} "
            "windows, p99 recovery wall)"
        ),
        "value": round(p99_all, 3),
        "unit": "s",
        "vs_baseline": round(served.cold_s / max(p50_all, 1e-9), 1),
        "scenario": True,
        "config": name,
        "n_windows": sopts.windows,
        "seed": sopts.seed,
        "backend": served.device.type,
        "device": device_line(served.device),
        "host_cores": os.cpu_count(),
        "verified": bool(
            all_verified and all_warm and all_env and zero_measured and clean_ok
            and (bool(warm_recovered) or not warm_gate_applicable)
            and bool(served.cold_res["verified"])
        ),
        "cold_s": round(served.cold_s, 2),
        "clean": {"p50_s": round(clean_p50, 3), "walls": clean_walls, "ok": clean_ok},
        "recovery": {"p50_s": round(p50_all, 3), "p99_s": round(p99_all, 3), "walls": all_walls},
        "warm_recovered_families": warm_recovered,
        "warm_gate_applicable": warm_gate_applicable,
        "warm_limit_s": round(warm_limit, 3),
        "all_windows_verified": all_verified,
        "all_windows_warm": all_warm,
        "all_envelopes_ok": all_env,
        "zero_measured_loop_compiles": zero_measured,
        "compile_cache": {"measured": warm_compiles},
        "cost_captures_in_measured": captures,
        "shape_key": list(base_key),
        "families": fam_out,
        "clean_goals_after": clean_after,
        "registry": sidecar.registry.stats(),
        "store": incr.STORE.stats(),
        "launches": {"broker_aggregates": {
            "cold": served.cold_launches,
            **{fam: f["launches"]["broker_aggregates"] for fam, f in fam_out.items()}}},
        "effort": {**served.warm_wire, "cold": served.cold_effort, "windows": sopts.windows,
                   "seed": sopts.seed, "families": list(sopts.families)},
    }


def run_chaos(name: str = "B5", n_iters: int = 14, drift: float = 0.01, *, device=None,
              served: Served | None = None, seed: int | None = None) -> dict:
    """The steady drift loop under a seeded fault schedule, through the
    sidecar (module docstring). ``seed`` (default ``CCX_FAULTS_SEED``, else
    42) seeds the faults, the client's retry jitter and the drift. With
    ``served`` the run starts from that cold result; else it makes its own
    and stops its sidecar at the end."""
    if seed is None:
        seed = int(os.environ.get(faults.ENV_FAULTS_SEED, "42"))
    with _capture():
        own = served is None
        if own:
            served = serve_cold(name, device)
        try:
            return _chaos(served, max(int(n_iters), 1), drift, seed)
        finally:
            faults.FAULTS.disarm()
            if own:
                served.close()


def _chaos(served: Served, n_iters: int, drift: float, seed: int) -> dict:
    from ccx_torch.sidecar.client import SidecarClient

    name, sidecar = served.name, served.sidecar
    goal_names, warm_wire = served.goal_names, {**served.cold_wire, **served.warm_wire}
    session = f"chaos-{name}"
    client = SidecarClient(served.address, retries=4, backoff_s=0.05, backoff_max_s=1.0,
                           deadline_s=120.0, retry_seed=seed)
    # the session starts from the applied cold result, banked as the warm
    # base at generation 1
    arrays = dict(served.applied)
    client.put_snapshot(None, session=session, generation=1, packed=pack_arrays(arrays))
    incr.remember(session, 1, served.m_applied, sidecar.goal_config)
    base_gen = gen = 1
    rng = np.random.default_rng(seed)
    p_real = int(served.m_applied.partition_valid.sum())
    n_drift = max(int(p_real * drift), 1)

    def put_drift() -> None:
        nonlocal arrays, gen
        new = drift_metrics(arrays, rng, p_real, n_drift)
        client.put_snapshot(None, session=session, generation=gen + 1,
                            packed=pack_arrays(delta_encode(arrays, new)), is_delta=True,
                            base_generation=gen)
        gen += 1
        arrays = new

    def window() -> dict:
        """One drift window end to end through the retrying client: the wall
        holds every retry and backoff (the recovery latency)."""
        nonlocal base_gen
        r0 = dict(client.stats)
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        put_drift()
        res = client.propose(session=session, goals=goal_names, columnar=True, warm_start=True,
                             base_generation=base_gen, **warm_wire)
        wall = time.monotonic() - t0
        base_gen = gen
        inc = res.get("incremental") or {}
        return {
            "wall_s": round(wall, 3),
            "verified": bool(res["verified"]),
            "warm": bool(inc.get("warmStart")),
            "cold_fallback": bool(inc.get("coldStart")),
            "rows": int(res["numProposals"]),
            "retries": client.stats["retries"] - r0["retries"],
            "restarts": client.stats["stream_restarts"] - r0["stream_restarts"],
            "launches": agg_op.LAUNCHES - n0,
        }

    try:
        # prewarm: the steady rung's two windows
        for _ in range(2):
            window()
        freeze_gc_steady_state()
        clean = [window() for _ in range(3)]
        clean_p50 = statistics.median(w["wall_s"] for w in clean)
        log.info("clean steady p50 %.0fms", clean_p50 * 1e3)

        reg0, store0 = sidecar.registry.stats(), incr.STORE.stats()
        cs0, cap0 = compilestats.snapshot(), _captures()
        windows: list = []
        fired: dict = {}
        for i in range(n_iters):
            spec_s, what = CHAOS_SCENARIOS[i % len(CHAOS_SCENARIOS)]
            n0 = agg_op.LAUNCHES
            faults.FAULTS.arm(spec_s, seed=seed + i)
            try:
                w = window()
                w["recovered"] = w["verified"]
            except Exception as e:  # noqa: BLE001 — an unrecovered window is a
                # failed gate, not a dead run: record it and go on
                w = {"wall_s": None, "verified": False, "warm": False, "cold_fallback": False,
                     "rows": 0, "recovered": False, "error": f"{type(e).__name__}: {e}",
                     "retries": 0, "restarts": 0, "launches": agg_op.LAUNCHES - n0}
                # the failed window may have left the client's and the
                # server's generations out of step: resync with a full put
                try:
                    client.put_snapshot(None, session=session, generation=gen + 1,
                                        packed=pack_arrays(arrays))
                    gen += 1
                    base_gen = gen
                except Exception:  # noqa: BLE001 — the next window will show it
                    log.exception("resync after an unrecovered window failed")
            st = faults.FAULTS.stats()
            for k, v in st["fired"].items():
                fired[k] = fired.get(k, 0) + v
            faults.FAULTS.disarm()
            w["scenario"] = spec_s
            w["injected"] = what
            w["fired"] = st["fired"]
            windows.append(w)
            log.info("window %d/%d [%s]: wall=%ss recovered=%s warm=%s retries=%s fired=%s",
                     i + 1, n_iters, what, w["wall_s"], w["recovered"], w["warm"], w["retries"],
                     st["fired"])
        faulted_compiles = compilestats.delta(cs0, compilestats.snapshot())
        captures = _captures() - cap0

        # settle: cancelled workers unwind at their next chunk boundary
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and FLEET.stats()["activeJobs"]:
            time.sleep(0.1)
        stuck = FLEET.stats()["activeJobs"]

        # disarmed epilogue: one re-warm window first (after a bank kill it
        # cold-starts and re-banks), then three that must be warm, verified
        # and build nothing
        window()
        cs1 = compilestats.snapshot()
        disarmed = [window() for _ in range(3)]
        warm_compiles = compilestats.delta(cs1, compilestats.snapshot())
    finally:
        client.close()
    zero_disarmed = warm_compiles["backend_compiles"] == 0
    disarmed_ok = all(w["verified"] and w["warm"] for w in disarmed) and zero_disarmed

    recovered = [w for w in windows if w["recovered"]]
    walls = sorted(w["wall_s"] for w in recovered if w["wall_s"] is not None)
    p50 = statistics.median(walls) if walls else None
    p99 = _p99(walls) if walls else None
    # bounded recovery: warm within 10x the clean steady p50 (at least
    # 5 s), a cold fallback (a lost bank) within 2x the cold wall + 10 s
    warm_limit = max(10.0 * clean_p50, 5.0)
    cold_limit = 2.0 * served.cold_s + 10.0
    bounded = all(
        w["wall_s"] is not None
        and w["wall_s"] <= (cold_limit if w["cold_fallback"] else warm_limit)
        for w in recovered
    )
    reg, store = sidecar.registry.stats(), incr.STORE.stats()
    # no session the faulted windows added, and no device model beyond the
    # sessions the run started with
    no_leaks = (
        reg["sessions"] == reg0["sessions"]
        and reg["deviceResident"] <= reg0["sessions"]
        and store["sessions"] == store0["sessions"]
    )
    all_recovered = len(recovered) == len(windows)
    return {
        "metric": (
            f"{name} chaos recovery: fault-injected drift windows through the sidecar "
            f"({drift:.0%} drift, one seam class killed per window, p99 recovery wall)"
        ),
        "value": round(p99, 3) if p99 is not None else None,
        "unit": "s",
        "vs_baseline": round(p50 / max(clean_p50, 1e-9), 2) if p50 is not None else None,
        "chaos": True,
        "config": name,
        "n_iters": len(windows),
        "drift_fraction": drift,
        "backend": served.device.type,
        "device": device_line(served.device),
        "host_cores": os.cpu_count(),
        "fault_seed": seed,
        "verified": bool(all_recovered and not stuck and no_leaks and bounded and disarmed_ok
                         and bool(served.cold_res["verified"])),
        "cold_s": round(served.cold_s, 2),
        "clean": {"p50_s": round(clean_p50, 3), "walls": [w["wall_s"] for w in clean]},
        "recovery": {
            "p50_s": round(p50, 3) if p50 is not None else None,
            "p99_s": round(p99, 3) if p99 is not None else None,
            "max_s": max(walls) if walls else None,
            "walls": walls,
            "bounded": bounded,
            "warm_limit_s": round(warm_limit, 2),
            "cold_limit_s": round(cold_limit, 2),
        },
        "recovered": {
            "windows": len(windows),
            "recovered": len(recovered),
            "warm": sum(1 for w in recovered if w["warm"]),
            "cold_fallback": sum(1 for w in recovered if w["cold_fallback"]),
        },
        "windows": windows,
        "faults_fired": fired,
        "client": dict(client.stats),
        "scheduler": {"stuckJobs": len(stuck), "activeJobs": stuck},
        "registry": reg,
        "store": store,
        "leaks_ok": no_leaks,
        "disarmed": {
            "ok": disarmed_ok,
            "zero_fresh_compiles": zero_disarmed,
            "walls": [w["wall_s"] for w in disarmed],
            "compile_cache": warm_compiles,
        },
        "compile_cache": {"faulted": faulted_compiles},
        "cost_captures_in_measured": captures,
        "launches": {"broker_aggregates": {
            "cold": served.cold_launches, "faulted": sum(w["launches"] for w in windows)}},
        "effort": {**served.warm_wire, "cold": served.cold_effort, "n_iters": len(windows),
                   "drift": drift, "scenarios": len(CHAOS_SCENARIOS)},
    }


#: the soak's injection kinds, cycled on the seeded schedule: a scenario
#: family's structural anomaly (a broker kill the detector classifies from
#: the live ``broker_alive`` signal) and a chaos fault (a killed warm-base
#: bank, seen as the NEXT window's cold fallback). Both have deterministic
#: observables, so the detector-initiated census is exact.
SOAK_INJECTIONS = (
    ("broker-kill", "broker_failure",
     "scenario-family broker failure (dead broker on the live stream)"),
    ("bank-kill", "cold_serve",
     "chaos fault placement.bank:raise@1 (warm base lost -> cold "
     "fallback)"),
)

#: the soak's violating ticks per injection (a broker kill is restored after)
SOAK_INJECT_DUR = 2


def soak_schedule(n_ticks: int, n_clusters: int, inject_start: int, inject_every: int,
                  inject_dur: int, clean_windows: int) -> dict:
    """The soak's injection plan: tick -> (``SOAK_INJECTIONS`` entry, target
    cluster index). Kinds cycle and targets go round-robin every
    ``inject_every`` ticks from ``inject_start``; an injection is planned
    only where the horizon leaves it room to dwell, re-baseline and stamp
    recovery (``inject_dur + clean_windows + 2`` ticks)."""
    tail = inject_dur + clean_windows + 2
    n_injections = max((n_ticks - inject_start + inject_every - 1) // inject_every, 0)
    return {
        tick: (SOAK_INJECTIONS[k % len(SOAK_INJECTIONS)], k % n_clusters)
        for k in range(n_injections)
        if (tick := inject_start + k * inject_every) <= n_ticks - tail
    }


def _ledger_sample() -> dict:
    from ccx_torch.common.devmem import DEVMEM

    s = DEVMEM.stats()
    return {"evictableBytes": s["evictableBytes"], "budgetBytes": s["budgetBytes"],
            "withinBudget": s["withinBudget"]}


class _SoakCluster:
    """One soak cluster: a session seeded from the applied clean state, its
    drift stream and its signals."""

    def __init__(self, i: int, run: dict) -> None:
        self.run = run
        self.sess = f"soak-{run['name']}-c{i}"
        applied = run["applied"]
        self.arrays = dict(applied)
        self.gen = self.base_gen = 1
        self.rng = np.random.default_rng(run["seed"] * 1000 + i)
        self._dead0 = {int(b) for b in np.nonzero(~np.asarray(applied["broker_alive"], bool))[0]}
        self._p0 = None
        run["client"].put_snapshot(None, session=self.sess, generation=1,
                                   packed=pack_arrays(applied), cluster_id=self.sess)
        incr.remember(self.sess, 1, run["m_applied"], run["goal_config"])

    def put(self, new: dict) -> None:
        self.run["client"].put_snapshot(
            None, session=self.sess, generation=self.gen + 1,
            packed=pack_arrays(delta_encode(self.arrays, new)), is_delta=True,
            base_generation=self.gen)
        self.gen += 1
        self.arrays = new

    def propose(self) -> dict:
        run = self.run
        t0 = time.monotonic()
        res = run["client"].propose(
            session=self.sess, goals=run["goal_names"], columnar=True, warm_start=True,
            base_generation=self.base_gen, cluster_id=self.sess, **run["warm_wire"])
        inc = res.get("incremental") or {}
        w = {
            "wall_s": round(time.monotonic() - t0, 3),
            "verified": bool(res["verified"]),
            "warm": bool(inc.get("warmStart")),
            "cold_fallback": bool(inc.get("coldStart")),
            "rows": int(res["numProposals"]),
            "repair_retries": int(inc.get("repairRetries") or 0),
            "reverted": inc.get("reverted"),
        }
        if w["verified"]:
            self.base_gen = self.gen
        return w

    def window(self, new: dict | None = None) -> dict:
        """One serving window end to end; ``new`` replaces the metric drift
        (the injection seam)."""
        run = self.run
        if new is None:
            new = drift_metrics(self.arrays, self.rng, run["p_real"], run["n_drift"])
        try:
            self.put(new)
            return self.propose()
        except Exception as e:  # noqa: BLE001 — an unserved window is an SLO
            # miss and an open episode, not a dead soak: resync like a real
            # client that exhausted its retries
            try:
                run["client"].put_snapshot(None, session=self.sess, generation=self.gen + 1,
                                           packed=pack_arrays(self.arrays))
                self.gen += 1
                self.base_gen = self.gen
            except Exception:  # noqa: BLE001 — the next window will show it
                log.exception("resync after an unserved soak window failed")
            return {"wall_s": None, "verified": False, "warm": False, "cold_fallback": False,
                    "rows": 0, "repair_retries": 0, "reverted": None,
                    "error": f"{type(e).__name__}: {e}"}

    def dead_brokers(self) -> tuple:
        """Brokers dead now that were alive at the converged baseline: the
        fixtures carry a standing dead set, and monitoring alarms on the
        deviation, not the baseline."""
        alive = np.asarray(self.arrays["broker_alive"], bool)
        return tuple(int(b) for b in np.nonzero(~alive)[0] if int(b) not in self._dead0)

    def pressure_band(self) -> float | None:
        """Mean of the banked warm-pressure stack over an adaptive baseline
        (the band the forecaster fits). A structural heal re-banks a
        differently scaled stack, so a step beyond 3x re-baselines at once
        after alarming once, while in-regime drift adapts slowly. One host
        read of the device stack, taken after the window's wall."""
        entry = incr.STORE.get(self.sess)
        if entry is None or entry.pressure is None:
            return None
        cur = abs(float(entry.pressure.float().mean()))
        if self._p0 is None:
            self._p0 = max(cur, 1e-9)
        band = round(0.5 * cur / self._p0, 4)
        if cur > 3.0 * self._p0 or cur < self._p0 / 3.0:
            self._p0 = max(cur, 1e-9)  # regime change
        else:
            self._p0 = max(0.95 * self._p0 + 0.05 * cur, 1e-9)
        return band


def run_soak(name: str = "B3", n_clusters: int = 2, n_ticks: int = 96, seed: int = 1729,
             drift: float = 0.01, *, device=None, served: Served | None = None) -> dict:
    """The closed-loop soak through the sidecar (module docstring): the
    stream detector, not the run, starts every heal. ``CCX_SOAK_INJECT_START``
    and ``CCX_SOAK_INJECT_EVERY`` (10, 12) place the injections,
    ``CCX_SOAK_LATENCY_BUDGET`` pins the SLO latency budget and
    ``CCX_SOAK_DWELL_TARGET`` (0.85) the dwell target. With ``served`` the
    run starts from that cold result; else it makes its own and stops its
    sidecar at the end."""
    with _capture():
        own = served is None
        if own:
            served = serve_cold(name, device)
        try:
            return _soak(served, max(int(n_clusters), 1), int(n_ticks), int(seed), drift)
        finally:
            faults.FAULTS.disarm()
            if own:
                served.close()


def _soak(served: Served, n_clusters: int, n_ticks: int, seed: int, drift: float) -> dict:
    from ccx_torch.common.devmem import DEVMEM
    from ccx_torch.config import CruiseControlConfig
    from ccx_torch.detector.stream import FAMILY_VERB, StreamDetector
    from ccx_torch.sidecar.client import SidecarClient

    name, sidecar = served.name, served.sidecar
    inject_start = int(os.environ.get("CCX_SOAK_INJECT_START", "10"))
    inject_every = int(os.environ.get("CCX_SOAK_INJECT_EVERY", "12"))
    inject_dur = SOAK_INJECT_DUR
    client = SidecarClient(served.address, retries=4, backoff_s=0.05, backoff_max_s=1.0,
                           deadline_s=120.0, retry_seed=seed)
    # the cold ref's warm base is not a cluster of the soak
    incr.STORE.drop(served.ref)
    p_real = int(served.m_applied.partition_valid.sum())
    run = {
        "name": name, "seed": seed, "client": client, "applied": served.applied,
        "m_applied": served.m_applied, "goal_config": sidecar.goal_config,
        "goal_names": served.goal_names, "warm_wire": {**served.cold_wire, **served.warm_wire},
        "p_real": p_real, "n_drift": max(int(p_real * drift), 1),
    }
    launches: dict = {}
    windows: list = []
    heals: list = []
    clusters: list = []

    def counted(phase: str, fn):
        n0 = agg_op.LAUNCHES
        try:
            return fn()
        finally:
            launches[phase] = launches.get(phase, 0) + agg_op.LAUNCHES - n0

    try:
        reg0, store0 = sidecar.registry.stats()["sessions"], incr.STORE.stats()["sessions"]
        t0 = time.monotonic()
        clusters.extend(counted("seed", lambda: [_SoakCluster(i, run) for i in range(n_clusters)]))
        # prewarm: two drift windows per cluster (the second grafts onto the
        # resident model); no injection replay (module docstring)
        counted("prewarm", lambda: [c.window() for c in clusters for _ in range(2)])
        prewarm_s = time.monotonic() - t0

        freeze_gc_steady_state()
        clean = counted("clean", lambda: [clusters[0].window() for _ in range(3)])
        clean_p50 = statistics.median(w["wall_s"] for w in clean)
        log.info("soak clean steady p50 %.0fms", clean_p50 * 1e3)

        # the closed loop: the latency budget prices itself against this
        # host unless pinned (a cold fallback, the bank kill's documented
        # degradation, must not be a latency miss)
        lat_budget = float(os.environ.get("CCX_SOAK_LATENCY_BUDGET", "0")) \
            or max(60.0, 2.0 * served.cold_s, 20.0 * clean_p50)
        cfg = CruiseControlConfig({
            "observability.slo.latency.budget.seconds": lat_budget,
            # the schedule spends ~6% of windows violating by design
            "observability.slo.dwell.target": float(
                os.environ.get("CCX_SOAK_DWELL_TARGET", "0.85")),
            "detector.stream.seed": seed,
        })
        window_s = cfg["observability.slo.window.seconds"]

        def healer(cluster: str, family: str, cause: str) -> str | None:
            """The detector's verb: one urgent warm re-Propose of the
            afflicted cluster (what the façade's verbs reduce to here)."""
            c = next(x for x in clusters if x.sess == cluster)
            n0 = agg_op.LAUNCHES
            r = c.propose()
            heals.append({"cluster": cluster, "family": family, "cause": cause,
                          "wall_s": r["wall_s"], "verified": r["verified"], "warm": r["warm"],
                          "repair_retries": r["repair_retries"],
                          "launches": agg_op.LAUNCHES - n0})
            return FAMILY_VERB.get(family, "rebalance")

        det = StreamDetector(cfg, healer=healer, clock=lambda: 0)
        schedule = soak_schedule(n_ticks, n_clusters, inject_start, inject_every, inject_dur,
                                 det.clean_windows)

        def observe(c: _SoakCluster, w: dict, t_s: float, *, drain: bool = False,
                    fault: str | None = None) -> dict:
            """Feed one served window to the detector: the horizon's windows
            carry the fault attribution and the pressure band, the drain's
            only the serving outcome (as the JAX bench's)."""
            signals = {
                "warm": w["warm"], "verified": w["verified"], "wall_s": w["wall_s"],
                "cold_fallback": w["cold_fallback"], "dead_brokers": c.dead_brokers(),
                "devmem_within_budget": DEVMEM.stats()["withinBudget"],
            }
            if not drain:
                signals["fault"] = fault
                p = c.pressure_band()
                if p is not None:
                    signals["pressure"] = p
            n0 = agg_op.LAUNCHES
            d = det.observe(c.sess, signals, t_s)
            launches["heals"] = launches.get("heals", 0) + agg_op.LAUNCHES - n0
            return d

        # the measured horizon on the simulated fleet clock
        cs0 = compilestats.snapshot()
        t_measured = time.monotonic()
        injections: list = []
        ledger: list = []
        active: dict = {}
        rng_inject = np.random.default_rng(seed + 99)
        for tick in range(n_ticks):
            t_s = tick * window_s
            if tick in schedule:
                (kind, family, what), ci = schedule[tick]
                c = clusters[ci]
                inj = {"tick": tick, "t_s": t_s, "kind": kind, "family": family,
                       "cluster": c.sess, "what": what, "until": tick + inject_dur}
                if kind == "broker-kill":
                    alive = np.nonzero(np.asarray(c.arrays["broker_alive"], bool))[0]
                    inj["victim"] = int(rng_inject.choice(alive))
                else:  # bank-kill: armed for this tick's window only
                    inj["spec"] = "placement.bank:raise@1"
                active[ci] = inj
                injections.append(inj)
                det.note_signal(c.sess, t_s)  # the tth clock starts here
                log.info("soak tick %d: inject %s -> %s", tick, kind, c.sess)
            for ci, c in enumerate(clusters):
                inj = active.get(ci)
                new = None
                armed = False
                if inj is not None and inj["kind"] == "broker-kill":
                    new = dict(drift_metrics(c.arrays, c.rng, p_real, run["n_drift"]))
                    ba = np.array(new["broker_alive"], bool)
                    # dead from the injection tick through the dwell,
                    # restored at ``until``
                    ba[inj["victim"]] = tick >= inj["until"]
                    new["broker_alive"] = ba
                if inj is not None and inj["kind"] == "bank-kill" and tick == inj["tick"]:
                    faults.FAULTS.arm(inj["spec"], seed=seed + tick)
                    armed = True
                n0 = agg_op.LAUNCHES
                w = c.window(new)
                w["launches"] = agg_op.LAUNCHES - n0
                if armed:
                    st = faults.FAULTS.stats()
                    faults.FAULTS.disarm()
                    inj["fired"] = dict(st["fired"])
                if inj is not None and tick >= inj["until"]:
                    active.pop(ci, None)
                d = observe(c, w, t_s,
                            fault=inj["spec"] if armed and not w["verified"] else None)
                w.update(tick=tick, cluster=c.sess, violations=d["violations"])
                if d["fired"]:
                    w["healed_by"] = d["verb"]
                windows.append(w)
                ledger.append(_ledger_sample())
            if tick % 24 == 23:
                log.info("soak tick %d/%d: episodes %s compliance %s", tick + 1, n_ticks,
                         dict(det.metrics), det.slo.compliance())
        launches["measured"] = sum(w["launches"] for w in windows)

        # drain: the horizon may end inside a clean streak; serve more clean
        # windows (still observed, the clock still ticking) until every
        # episode closes or the drain budget is spent
        drain = 0
        drained: list = []
        while any(det.slo.episode(c.sess) for c in clusters) \
                and drain < det.clean_windows + inject_dur + 2:
            t_s = (n_ticks + drain) * window_s
            for c in clusters:
                if det.slo.episode(c.sess) is None:
                    continue
                w = counted("drain", c.window)
                observe(c, w, t_s, drain=True)
                drained.append(w)
            drain += 1
        measured_s = time.monotonic() - t_measured
        warm_compiles = compilestats.delta(cs0, compilestats.snapshot())
        zero_measured = warm_compiles["backend_compiles"] == 0

        # settle stragglers before the leak and stuck gates
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and FLEET.stats()["activeJobs"]:
            time.sleep(0.1)
        stuck = FLEET.stats()["activeJobs"]
        reg, store = sidecar.registry.stats(), incr.STORE.stats()
    finally:
        client.close()
        for c in clusters:
            incr.STORE.drop(c.sess)

    open_eps = det.slo.open_episodes
    episodes = det.slo.closed_episodes + open_eps
    recovered_eps = [e for e in episodes if e.t_recovered_s is not None]
    fam_census: dict = {}
    for e in episodes:
        fam_census[e.family] = fam_census.get(e.family, 0) + 1
    want_census: dict = {}
    for inj in injections:
        want_census[inj["family"]] = want_census.get(inj["family"], 0) + 1
    detector_initiated = (
        len(episodes) == len(injections) and fam_census == want_census
        and all(e.t_fired_s is not None and e.verb for e in episodes)
    )
    all_recovered = not open_eps and len(recovered_eps) == len(episodes)
    tths = sorted(e.time_to_heal_s for e in recovered_eps if e.time_to_heal_s is not None)
    tth_p50 = statistics.median(tths) if tths else None
    tth_p99 = _p99(tths) if tths else None
    # a transient injection dwells ``inject_dur`` ticks and the fault's
    # observable lands one tick late: a healthy loop recovers at the first
    # clean window after that
    tth_bound = (inject_dur + 2) * window_s
    tth_bounded = bool(tths) and tth_p99 <= tth_bound
    compliance = det.slo.compliance()
    slo_ok = all(v["met"] for v in compliance.values() if v["total"] > 0)
    budget_respected = all(s["withinBudget"] for s in ledger)
    half = len(ledger) // 2
    peak1 = max(s["evictableBytes"] for s in ledger[:half])
    peak2 = max(s["evictableBytes"] for s in ledger[half:])
    devmem_flat = budget_respected and peak2 <= peak1 * 1.05 + 1_000_000
    # the registry keeps a host snapshot per session it was given (the cold
    # ref and any earlier run's, plus the clusters); the placement store
    # must hold exactly the clusters beyond what it held before: any other
    # entry is a leaked warm base
    no_leaks = (reg["sessions"] == reg0 + n_clusters
                and store["sessions"] == store0 + n_clusters)
    walls = sorted(w["wall_s"] for w in windows if w["wall_s"] is not None)
    served_ok = len(walls) == len(windows)
    sim_s = n_ticks * window_s
    fleet_minutes = n_clusters * sim_s / 60.0
    gates = {
        "fleet_minutes_ok": fleet_minutes >= 30.0,
        "all_recovered": all_recovered,
        "detector_initiated": detector_initiated,
        "tth_bounded": tth_bounded,
        "slo_ok": slo_ok,
        "devmem_flat": devmem_flat,
        "zero_measured_loop_compiles": zero_measured,
        "all_windows_served": served_ok,
        "no_stuck_jobs": not stuck,
        "no_leaks": no_leaks,
    }
    return {
        "metric": (
            f"{name} closed-loop soak: {n_clusters} clusters x {n_ticks} drift windows "
            f"({fleet_minutes:.0f} simulated fleet-minutes), seeded anomaly/fault injections "
            "healed by the stream detector (time-to-heal p99)"
        ),
        "value": tth_p99,
        "unit": "s",
        # what a detector-healed horizon costs per window over the clean p50
        "vs_baseline": round(statistics.median(walls) / max(clean_p50, 1e-9), 2)
        if walls else None,
        "soak": True,
        "config": name,
        "n_clusters": n_clusters,
        "n_ticks": n_ticks,
        "window_s": window_s,
        "fleet_minutes": round(fleet_minutes, 1),
        "seed": seed,
        "drift_fraction": drift,
        "backend": served.device.type,
        "device": device_line(served.device),
        "host_cores": os.cpu_count(),
        "verified": bool(all(gates.values()) and bool(served.cold_res["verified"])),
        "cold_s": round(served.cold_s, 2),
        "clean_p50_s": round(clean_p50, 3),
        "gates": gates,
        "healing": {
            "injections": len(injections),
            "episodes": len(episodes),
            "recovered": len(recovered_eps),
            "open": len(open_eps),
            "family_census": fam_census,
            "expected_census": want_census,
            "detector_metrics": dict(det.metrics),
            "prewarms": det._prewarms,
            "tth_p50_s": tth_p50,
            "tth_p99_s": tth_p99,
            "tth_bound_s": tth_bound,
            "tths": tths,
            "heals": heals,
        },
        "slo": {
            "latency_budget_s": round(lat_budget, 2),
            "compliance": compliance,
            "burn_rates": det.slo.burn_rates(),
            "summary": det.slo.summary(),
        },
        "episodes": det.slo.episodes_json(limit=64),
        "injections": injections,
        "windows": {
            "total": len(windows),
            "drain": drain * n_clusters,
            "drain_served": len(drained),
            "p50_s": round(statistics.median(walls), 3) if walls else None,
            "p99_s": round(_p99(walls), 3) if walls else None,
            "warm": sum(1 for w in windows if w["warm"]),
            "cold_fallback": sum(1 for w in windows if w["cold_fallback"]),
            "unverified": sum(1 for w in windows if not w["verified"]),
            "repair_retries": sum(w["repair_retries"] for w in windows + drained)
            + sum(h["repair_retries"] for h in heals),
        },
        "window_detail": windows,
        "phase_seconds": {"seed_prewarm": round(prewarm_s, 3), "measured": round(measured_s, 3)},
        "devmem": {
            "budget_respected": budget_respected,
            "first_half_peak_bytes": int(peak1),
            "second_half_peak_bytes": int(peak2),
            "samples": len(ledger),
            "final": DEVMEM.stats(),
        },
        "compile_cache": {"measured": warm_compiles},
        "scheduler": {"stuckJobs": len(stuck), "activeJobs": stuck},
        "registry": reg,
        "store": store,
        "launches": {"broker_aggregates": {"cold": served.cold_launches, **launches}},
        "effort": {
            **served.warm_wire, "cold": served.cold_effort, "n_clusters": n_clusters,
            "n_ticks": n_ticks, "seed": seed, "drift": drift, "inject_every": inject_every,
            "inject_start": inject_start, "inject_dur": inject_dur,
        },
    }


class _FleetCluster:
    """One steady-fleet cluster: its cold result applied (a full put at
    generation 2) and its drift stream of delta puts and warm Proposes."""

    def __init__(self, i: int, m0: TensorClusterModel, run: dict) -> None:
        self.run = run
        self.sess = f"sfleet-{i}"
        warm_base = incr.STORE.get(self.sess)
        if warm_base is None:
            raise RuntimeError(f"steady fleet: no warm base banked for cluster {i}: "
                               "is CCX_INCREMENTAL=0 set?")
        applied = m0.replace(assignment=warm_base.assignment,
                             leader_slot=warm_base.leader_slot,
                             replica_disk=warm_base.replica_disk)
        self.arrays = model_to_arrays(applied)
        run["client"].put_snapshot(None, session=self.sess, generation=2,
                                   packed=to_msgpack(applied), cluster_id=self.sess)
        self.gen, self.base_gen = 2, 1
        self.rng = np.random.default_rng(1000 + i)
        self.p_real = int(m0.partition_valid.sum())
        self.n_drift = max(int(self.p_real * run["drift"]), 1)

    def put_drift(self) -> float:
        new = drift_metrics(self.arrays, self.rng, self.p_real, self.n_drift)
        delta = delta_encode(self.arrays, new)
        t0 = time.monotonic()
        self.run["client"].put_snapshot(None, session=self.sess, generation=self.gen + 1,
                                        packed=pack_arrays(delta), is_delta=True,
                                        base_generation=self.gen)
        self.gen += 1
        self.arrays = new
        return time.monotonic() - t0

    def warm_window(self) -> dict:
        run = self.run
        t0 = time.monotonic()
        res = run["client"].propose(session=self.sess, goals=run["goal_names"], columnar=True,
                                    cluster_id=self.sess, warm_start=True,
                                    base_generation=self.base_gen, **run["warm_wire"])
        self.base_gen = self.gen
        inc = res.get("incremental") or {}
        return {
            "wall": time.monotonic() - t0,
            "verified": bool(res["verified"]),
            "warm": bool(inc.get("warmStart")),
            "proposals": int(res["numProposals"]),
            "repair_retries": int(inc.get("repairRetries") or 0),
            # repair, warm SA or the retries ran: more than the metrics
            # path's two aggregates passes
            "structural": bool(inc.get("structuralOffenders") or inc.get("plateau")
                               or inc.get("repairRetries")),
            # the base was shipped: the server re-scans its pressure to bank it
            "reverted": bool(inc.get("reverted")),
        }


def run_steady_fleet(name: str = "B3", n_clusters: int = 16, n_windows: int = 10,
                     drift: float = 0.01, *, device=None, cold_opts: dict | None = None,
                     spec: RandomClusterSpec | None = None,
                     goals: tuple[str, ...] | None = None,
                     warm_wire: dict | None = None) -> dict:
    """N warm clusters on one sidecar under the device-memory ledger (module
    docstring). ``cold_opts`` (default ``rungs.fleet_wire_options()``) are
    the cold converges' Propose keys; ``spec``, ``goals`` and ``warm_wire``
    (default: the steady rung's keys) replace the config's fixture, the
    server's goal stack and the warm budget (the tests' small sizes).
    ``CCX_FLEET_MAX_CONCURRENT`` caps resident jobs (default unlimited) and
    ``CCX_FLEET_DISPATCH_WIDTH`` sets the dispatch width (default the
    port's, 1); both are restored when the run ends."""
    from ccx_torch.search import scheduler

    max_conc = int(os.environ.get("CCX_FLEET_MAX_CONCURRENT", "0"))
    prev = FLEET.max_concurrent, FLEET.dispatch_width
    scheduler.configure(max_concurrent=max_conc,
                        dispatch_width=int(os.environ.get("CCX_FLEET_DISPATCH_WIDTH", "0")))
    try:
        with _capture():
            return _steady_fleet(
                name, max(int(n_clusters), 1), max(int(n_windows), 1), drift,
                resolve_device(device), fleet_wire_options() if cold_opts is None else cold_opts,
                spec or bench_spec(name), goals,
                steady_wire_options() if warm_wire is None else warm_wire, max_conc)
    finally:
        FLEET.max_concurrent, FLEET.dispatch_width = prev


def _steady_fleet(name: str, n_clusters: int, n_windows: int, drift: float, dev: torch.device,
                  cold_opts: dict, spec: RandomClusterSpec, goals, warm_wire: dict,
                  max_conc: int) -> dict:
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ccx_torch.common.devmem import DEVMEM
    from ccx_torch.search.state import max_partitions_per_topic
    from ccx_torch.sidecar.client import SidecarClient

    # same spec, other seeds: the fleet pads to one shape bucket
    models = [random_cluster(dataclasses.replace(spec, seed=spec.seed + 300 + i), device=dev)
              for i in range(n_clusters)]
    buckets: dict = {}
    for i, m in enumerate(models):
        buckets.setdefault((int(m.P), int(m.B), max_partitions_per_topic(m)), []).append(i)
    log.info("steady fleet: %d %s clusters in %d shape bucket(s)", n_clusters, name, len(buckets))

    sidecar = OptimizerSidecar(device=dev)
    server, port = make_grpc_server(sidecar, address="127.0.0.1:0", max_workers=n_clusters + 8)
    server.start()
    client = SidecarClient(f"127.0.0.1:{port}")
    # no goals: the server's default stack, as the JAX bench sends
    run = {"client": client, "goal_names": goals or (), "drift": drift, "warm_wire": warm_wire}
    launches: dict = {}
    clusters: list = []
    try:
        # 1. cold converge: one session per cluster, each banks its warm base;
        # each bucket's first member first
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        for i, m in enumerate(models):
            client.put_snapshot(None, session=f"sfleet-{i}", generation=1,
                                packed=to_msgpack(m), cluster_id=f"sfleet-{i}")
        cold_walls = []
        order = [members[0] for members in buckets.values()]
        order += [i for i in range(n_clusters) if i not in set(order)]
        for i in order:
            t1 = time.monotonic()
            res = client.propose(session=f"sfleet-{i}", goals=run["goal_names"], columnar=True,
                                 cluster_id=f"sfleet-{i}", **cold_opts)
            cold_walls.append(time.monotonic() - t1)
            log.info("steady fleet: cold converge %d/%d of cluster %d in %.1fs",
                     len(cold_walls), n_clusters, i, cold_walls[-1])
            if not res["verified"]:
                raise RuntimeError(f"steady fleet: cold Propose {i} unverified: "
                                   f"{res.get('verificationFailures')}")
        cold_s = time.monotonic() - t0
        launches["cold"] = agg_op.LAUNCHES - n0
        log.info("steady fleet: %d cold converges in %.1fs (first %.1fs)", n_clusters, cold_s,
                 cold_walls[0])

        # 2. apply, then two unmeasured warm windows each (the second grafts
        # onto the resident model)
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        clusters.extend(_FleetCluster(i, m, run) for i, m in enumerate(models))
        for c in clusters:
            for _ in range(2):
                c.put_drift()
                c.warm_window()
        prewarm_s = time.monotonic() - t0
        launches["prewarm"] = agg_op.LAUNCHES - n0
        freeze_gc_steady_state()

        # 3. the single-session baseline, serialized
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        single = []
        for _ in range(n_windows):
            clusters[0].put_drift()
            single.append(clusters[0].warm_window())
        single_s = time.monotonic() - t0
        single_rate = n_windows / max(single_s, 1e-9)
        launches["single"] = agg_op.LAUNCHES - n0

        # 4. the measured fleet: every cluster drives its windows at once;
        # the ledger is sampled after every window
        FLEET.reset_stats()
        cs0 = compilestats.snapshot()
        windows: list = []
        ledger: list = []
        wlock = threading.Lock()

        def drive(c: _FleetCluster) -> None:
            for _ in range(n_windows):
                put_s = c.put_drift()
                r = c.warm_window()
                r["put_s"] = put_s
                s = _ledger_sample()
                with wlock:
                    windows.append(r)
                    ledger.append(s)

        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        with ThreadPoolExecutor(n_clusters) as ex:
            list(ex.map(drive, clusters))
        fleet_s = time.monotonic() - t0
        launches["measured"] = agg_op.LAUNCHES - n0
        sched = FLEET.stats()
        fleet_compiles = compilestats.delta(cs0, compilestats.snapshot())
        reg, store = sidecar.registry.stats(), incr.STORE.stats()
    finally:
        client.close()
        server.stop(0).wait(30)
        for i in range(n_clusters):
            incr.STORE.drop(f"sfleet-{i}")
    zero_warm = fleet_compiles["backend_compiles"] == 0
    walls = sorted(r["wall"] for r in windows)
    p50 = statistics.median(walls)
    p99 = _p99(walls)
    agg_rate = len(windows) / max(fleet_s, 1e-9)
    all_verified = all(r["verified"] for r in windows)
    all_warm = all(r["warm"] for r in windows)
    budget_respected = all(s["withinBudget"] for s in ledger)
    max_evictable = max(s["evictableBytes"] for s in ledger)
    devmem_final = DEVMEM.stats()
    log.info("steady fleet: %dx%d windows in %.1fs (%.2f windows/s vs single %.2f) p50=%.0fms "
             "p99=%.0fms", n_clusters, n_windows, fleet_s, agg_rate, single_rate, p50 * 1e3,
             p99 * 1e3)
    return {
        "metric": (
            f"{name} steady-state fleet: {n_clusters} warm clusters x {n_windows} drift "
            "windows through the sidecar (per-window p99)"
        ),
        "value": round(p99, 3),
        "unit": "s",
        # aggregate fleet windows/s over the single-session rate: what
        # concurrency buys (>= 1.0: no loss)
        "vs_baseline": round(agg_rate / max(single_rate, 1e-9), 3),
        "steadyfleet": True,
        "config": name,
        "n_clusters": n_clusters,
        "n_windows": n_windows,
        "drift_fraction": drift,
        "backend": dev.type,
        "device": device_line(dev),
        "host_cores": os.cpu_count(),
        "verified": bool(all_verified and all_warm and zero_warm and budget_respected),
        "windows_per_sec": round(agg_rate, 3),
        "single_windows_per_sec": round(single_rate, 3),
        "fleet_s": round(fleet_s, 2),
        "single_s": round(single_s, 2),
        "cold_s": round(cold_s, 2),
        "cold_walls": [round(w, 3) for w in cold_walls],
        "prewarm_s": round(prewarm_s, 2),
        "warm": {
            "p50_s": round(p50, 3),
            "p99_s": round(p99, 3),
            "mean_s": round(statistics.mean(walls), 3),
            "walls": [round(w, 3) for w in walls],
        },
        "single_warm": {
            "p50_s": round(statistics.median(r["wall"] for r in single), 3),
            "walls": [round(r["wall"], 3) for r in single],
        },
        "all_verified": all_verified,
        "all_warm_started": all_warm,
        "zero_warm_fresh_compiles": zero_warm,
        "compile_cache": {"measured": fleet_compiles},
        "devmem": {
            "budget_respected": budget_respected,
            "max_evictable_bytes": int(max_evictable),
            "samples": len(ledger),
            "final": devmem_final,
        },
        "diff_rows": int(statistics.median(r["proposals"] for r in windows)),
        "repair_retries": sum(r["repair_retries"] for r in single + windows),
        "structural_windows": sum(r["structural"] for r in windows),
        "reverted_windows": sum(r["reverted"] for r in windows),
        "occupancy": sched["occupancy"],
        "mean_depth": sched["meanDepth"],
        "chunks_granted": sched["chunksGranted"],
        "registry": reg,
        "store": store,
        "shape_buckets": len(buckets),
        "launches": {"broker_aggregates": launches},
        "effort": {
            **warm_wire, "cold": cold_opts, "n_clusters": n_clusters, "n_windows": n_windows,
            "drift": drift, "max_concurrent": max_conc, "dispatch_width": FLEET.dispatch_width,
        },
    }
