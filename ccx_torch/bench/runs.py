"""The scenario corpus and the chaos run, through the port's gRPC sidecar.

Ports of the JAX bench's ``run_scenario`` and ``run_chaos`` (``bench.py``,
``--scenario`` and ``--chaos``). Each drives a real loopback gRPC sidecar
(``ccx_torch.sidecar.server``) with the port's retrying client, from one
cold Propose at the config's target rung, and returns its JSON line (the
keys of the JAX bench's ``SCENARIO_r*.json`` or ``CHAOS_r*.json``, plus the
device, the backend and the ``broker_aggregates`` launches per family and
window). ``verified`` is the conjunction of the run's gates.

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

One deliberate difference from the JAX bench: its scenario run replays the
whole family x window matrix on throwaway sessions before it measures, only
so that XLA compiles one program per static dense count outside the
measured loop. The port compiles nothing per shape (its search is eager
PyTorch and its one kernel is built once per process), so the replay would
only double the run's time: it is dropped, and the two metric prewarm
windows stay. The zero-compile gate stays, as zero ``nvcc`` builds
(``compilestats``).

``serve_cold`` brings up the sidecar and runs the cold Propose; both runs
take its ``Served`` so that one cold Propose can seed both (each run then
seeds its own sessions from the applied result). Both run on the CUDA
device unless the caller asks for another (``device="cpu"``: the tests).
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
    build_opts, drift_metrics, effort_of, steady_wire_options, wire_options,
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
    cold and a warm request."""

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

    def close(self) -> None:
        self.server.stop(0)


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
    try:
        with SidecarClient(address) as client:
            client.put_snapshot(None, session=ref, generation=1, packed=to_msgpack(m0))
            n0 = agg_op.LAUNCHES
            t0 = time.monotonic()
            cold_res = client.propose(session=ref, goals=goal_names, columnar=True, **cold_wire)
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
        server.stop(0)
        raise
    log.info("cold propose %.1fs verified=%s", cold_s, cold_res["verified"])
    return Served(
        name=name, device=dev, sidecar=sidecar, server=server, address=address,
        goal_names=goal_names, cold_wire=cold_wire,
        warm_wire=steady_wire_options() if warm_wire is None else dict(warm_wire),
        cold_effort=cold_effort, cold_res=cold_res, cold_s=cold_s,
        cold_launches=cold_launches, m_applied=m_applied,
        applied=model_to_arrays(m_applied),
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
