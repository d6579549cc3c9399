"""The bench's default effort ladder, its scaling curve and its mesh slope.

Ports of ``bench.py``'s ``run_config`` and the ladder in ``main`` (what
``python bench.py`` runs with no flag), ``run_scaling`` (``--scaling``) and
``run_mesh_bench`` (``CCX_BENCH_MESH=1``):

* ``run_ladder``: a B1 ``smoke`` rung first (a cold and one warm run, no
  goals block), then ``target`` (B5 only), ``lean`` and ``full`` from
  ``ccx_torch.rungs.RUNGS``, or the one ``custom`` rung when all four of
  ``CCX_BENCH_CHAINS``/``STEPS``/``MOVES``/``POLISH_ITERS`` are set. Per rung
  one cold run and ``samples`` warm runs, the median warm wall the line's
  ``value``; the rungs ``sidecar_for_rung`` picks run through the port's
  gRPC sidecar (a put, then one Propose per run). One JSON line per rung
  with the keys of ``BENCH_r05.json``'s line (``LINE_KEYS``), plus the
  kernel's launches and the card; the last line re-emits the final rung.
  ``compile_cache`` counts ``nvcc`` builds: a warm run must count none.
* ``run_scaling``: the chunk-driven sharded anneal at fixed work on 1, 2,
  4 and 8 devices with every ``(chains, parts)`` split, verified on the
  widest mesh's best layout: the line of ``MULTICHIP_r06.json``'s keys.
* ``run_mesh_bench``: the slope of the sharded SA step (one parts axis over
  every device) against the unsharded one, between 10 and 50 steps.

Where the virtual mesh applies: JAX runs both mesh modes on a virtual CPU
mesh by definition (``MULTICHIP_r06.json``: ``"backend": "cpu"``). On the
card with fewer than two physical GPUs they, and the ladder under
``CCX_BENCH_SHARDED=1``, run on ``ccx_torch.common.vmesh``'s 8 logical
devices over ``cuda:0`` (JAX's ``force_host_devices(8)``), and the line says
so (``mesh: {"devices": 8, "virtual": true}``); with ``--device cpu`` they
use 8 logical CPU devices. Both price the sharding structure (a shard's
launches and the psum per shard), not a multi-card speedup.

Deliberate differences from the JAX bench:

1. No CPU-first baseline subprocess and no CPU rung cut: both are CPU
   fallbacks, and the port runs where it is asked to or fails.
2. No MXU A/B probe (``tools/probe_mxu.py``), so no ``mxu_ab`` key: its
   counterpart is the kernel line of ``chip_smoke.py``.
3. No prewarm pass and no ``prewarm`` key: it only pre-compiles XLA
   programs, and the port compiles nothing per shape.
4. No in-process degrade when the wire fails: a failed put or Propose fails
   the rung, because the port has no catch-all retry.
5. No XProf trace under ``CCX_PROFILE_DIR``, which is TPU-only in JAX.

Every run is on the CUDA device unless the caller asks for another
(``device="cpu"``: the tests, with ``spec`` replacing a config's fixture).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import time

import torch

from ccx_torch.bench.runs import device_line
from ccx_torch.common import compilestats, vmesh
from ccx_torch.device import resolve_device, synchronize
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import optimize
from ccx_torch.rungs import build_opts, wire_options

log = logging.getLogger(__name__)

#: the headline's target wall (``vs_baseline`` is this over the warm wall)
TARGET_S = 5.0
#: the keys every rung line carries (``BENCH_r05.json``'s and the optional
#: ones of ``bench.py``'s line, less ``mxu_ab``, ``prewarm`` and
#: ``backend_detail``)
LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "verified", "verification_failures",
    "proposals", "cold_s", "backend", "rung", "lean", "effort", "samples", "spanTree",
    "costModel", "mesh", "convergence", "compile_cache", "sidecar", "goals",
)
#: the effort knobs that, all set, collapse the ladder to ``custom``
EFFORT_KNOBS = ("CCX_BENCH_CHAINS", "CCX_BENCH_STEPS", "CCX_BENCH_MOVES", "CCX_BENCH_POLISH_ITERS")
#: logical devices of the virtual mesh the mesh modes run on (``bench.py``'s)
VIRTUAL_DEVICES = 8


def sidecar_for_rung(rung: str) -> bool:
    """``CCX_BENCH_SIDECAR``: unset, the target rung only; ``"1"``, every
    non-smoke rung; ``"0"``, none; any other value raises ``SystemExit``."""
    v = os.environ.get("CCX_BENCH_SIDECAR")
    if v == "1":
        return True
    if v == "0":
        return False
    if v not in (None, ""):
        raise SystemExit(f"CCX_BENCH_SIDECAR must be '0' or '1', got {v!r}")
    return rung == "target"


def ladder_rungs(name: str) -> list[str]:
    """The rungs after the smoke rung: target (B5 only), lean and full; or
    ``custom`` alone when every effort knob is set."""
    if all(os.environ.get(k) for k in EFFORT_KNOBS):
        return ["custom"]
    return (["target"] if name == "B5" else []) + ["lean", "full"]


def local_summary(res) -> dict:
    """What a rung line reads from an in-process ``OptimizerResult``."""
    return {
        "verified": bool(res.verification.ok),
        "failures": list(res.verification.failures),
        "proposals": int(res.diff.n),
        "phases": dict(res.phase_seconds),
        "span_tree": res.span_tree,
        "cost_model": res.cost_model,
        "mesh": res.mesh,
        "convergence": res.convergence,
        "before": res.stack_before.by_name(),
        "after": res.stack_after.by_name(),
    }


def _wire_summary(res: dict) -> dict:
    """What a rung line reads from a Propose result."""
    return {
        "verified": bool(res["verified"]),
        "failures": list(res["verificationFailures"]),
        "proposals": int(res["numProposals"]),
        "phases": dict(res.get("phaseSeconds", {})),
        "span_tree": res.get("spanTree"),
        "cost_model": res.get("costModel"),
        "mesh": res.get("mesh"),
        "convergence": res.get("convergence"),
        "before": {g["goal"]: (g["violationsBefore"], g["costBefore"]) for g in res["goalSummary"]},
        "after": {g["goal"]: (g["violationsAfter"], g["costAfter"]) for g in res["goalSummary"]},
    }


def _goals_block(before: dict, after: dict) -> dict:
    return {
        goal: {
            "violations": [round(float(before[goal][0]), 1), round(float(va), 1)],
            "cost": [round(float(before[goal][1]), 5), round(float(ca), 5)],
        }
        for goal, (va, ca) in after.items()
    }


def rung_result(rung: str, cold: tuple[float, dict], warms: list[tuple[float, dict]],
                effort: dict, compile_cache: dict, sidecar: dict | None = None,
                launches: dict | None = None) -> dict:
    """A rung's result from its cold run and its warm runs (each ``(wall,
    summary)``): the median warm wall, the last warm run's verdict, goals
    and blocks (``bench.py``'s ``run_config`` return)."""
    walls = [w for w, _ in warms]
    r = warms[-1][1]
    t_warm = statistics.median(walls)
    return {
        "cold": cold[0], "warm": t_warm, "verified": r["verified"], "failures": r["failures"],
        "proposals": r["proposals"],
        "goals": {} if rung == "smoke" else _goals_block(r["before"], r["after"]),
        "compile_cache": compile_cache, "sidecar": sidecar or {}, "effort": effort,
        "span_tree": r["span_tree"], "cost_model": r["cost_model"], "mesh": r["mesh"],
        "convergence": r["convergence"], "phases": r["phases"],
        "samples": {"n": len(walls), "min": round(min(walls), 3), "median": round(t_warm, 3),
                    "max": round(max(walls), 3), "walls": [round(w, 3) for w in walls]},
        "launches": launches or {},
    }


def rung_line(name: str, rung: str, r: dict, dev: torch.device) -> dict:
    """The rung's JSON line (``LINE_KEYS``, then the last warm run's phase
    seconds, the kernel's launches and the card)."""
    return {
        "metric": f"{name} full-goal-stack rebalance proposal wall-clock (warm)",
        "value": round(r["warm"], 3),
        "unit": "s",
        "vs_baseline": round(TARGET_S / max(r["warm"], 1e-9), 3),
        "verified": r["verified"],
        "verification_failures": r["failures"],
        "proposals": r["proposals"],
        "cold_s": round(r["cold"], 3),
        "backend": dev.type,
        "rung": rung,
        "lean": rung == "lean",
        "effort": r["effort"],
        "samples": r["samples"],
        "spanTree": r["span_tree"],
        "costModel": r["cost_model"],
        "mesh": r["mesh"],
        "convergence": r["convergence"],
        "compile_cache": r["compile_cache"],
        "sidecar": r["sidecar"],
        "goals": r["goals"],
        "phase_seconds": r["phases"],
        "launches": r["launches"],
        "device": device_line(dev),
    }


class _Wire:
    """A loopback gRPC sidecar with one config's snapshot put, for the rungs
    that run over the wire. A failed put raises (no in-process degrade)."""

    def __init__(self, name: str, m, dev: torch.device) -> None:
        from ccx_torch.model.snapshot import to_msgpack
        from ccx_torch.sidecar.client import SidecarClient
        from ccx_torch.sidecar.server import OptimizerSidecar, make_grpc_server

        self.session = f"bench-{name}"
        self.server, port = make_grpc_server(OptimizerSidecar(device=dev), address="127.0.0.1:0")
        self.server.start()
        try:
            self.client = SidecarClient(f"127.0.0.1:{port}")
            t0 = time.monotonic()
            packed = to_msgpack(m)
            self.info = {"encode_s": round(time.monotonic() - t0, 3),
                         "snapshot_mb": round(len(packed) / 1e6, 2)}
            t0 = time.monotonic()
            self.client.put_snapshot(None, session=self.session, generation=1, packed=packed)
            self.info["put_s"] = round(time.monotonic() - t0, 3)
        except BaseException:
            self.close()
            raise

    def propose(self, goal_names, wire: dict, label: str) -> tuple[float, dict]:
        t0 = time.monotonic()
        res = self.client.propose(session=self.session, goals=goal_names, columnar=True, **wire)
        rtt = time.monotonic() - t0
        self.info[f"hop_overhead_{label}_s"] = round(rtt - res["wallSeconds"], 3)
        return rtt, _wire_summary(res)

    def close(self) -> None:
        client = getattr(self, "client", None)
        if client is not None:
            client.close()
        self.server.stop(0).wait(30)


def run_config(name: str, rung: str, samples: int = 1, *, device=None,
               spec: RandomClusterSpec | None = None) -> dict:
    """One rung of config ``name`` (``spec`` replaces its fixture): a cold
    run and ``samples`` warm runs (one at the smoke rung), in process or
    over the wire as ``sidecar_for_rung`` says."""
    dev = resolve_device(device)
    smoke = rung == "smoke"
    m = random_cluster(spec or bench_spec(name), device=dev)
    goal_names, opts, effort = build_opts(name, rung)
    cfg = GoalConfig()
    log.info("[%s] %s: padded P=%d B=%d T=%d", rung, name, m.P, m.B, m.num_topics)
    wire = _Wire(name, m, dev) if (not smoke and sidecar_for_rung(rung)) else None
    try:
        def one_run(label: str) -> tuple[float, dict]:
            if wire is not None:
                out = wire.propose(goal_names, wire_options(opts), label)
                synchronize(dev)
                return out
            t0 = time.monotonic()
            res = optimize(m, cfg, goal_names, opts)
            synchronize(dev)
            return time.monotonic() - t0, local_summary(res)

        cs0, n0 = compilestats.snapshot(), agg_op.LAUNCHES
        cold = one_run("cold")
        cs1, n1 = compilestats.snapshot(), agg_op.LAUNCHES
        n_samples = 1 if smoke else max(int(samples), 1)
        warms = [one_run("warm" if n_samples == 1 else f"warm{i + 1}") for i in range(n_samples)]
        cs2, n2 = compilestats.snapshot(), agg_op.LAUNCHES
    finally:
        if wire is not None:
            wire.close()
    log.info("[%s] %s cold=%.2fs warm=%s verified=%s", rung, name, cold[0],
             [round(w, 2) for w, _ in warms], warms[-1][1]["verified"])
    return rung_result(
        rung, cold, warms, effort,
        {"cold": compilestats.delta(cs0, cs1), "warm": compilestats.delta(cs1, cs2)},
        sidecar=wire.info if wire is not None else None,
        launches={"cold": n1 - n0, "warm": n2 - n1},
    )


def _mesh_context(dev: torch.device, n: int = VIRTUAL_DEVICES):
    """Where the mesh modes run: a list the caller forced; the physical
    devices of ``dev``'s type when two or more are visible; else ``n``
    logical devices forced over ``dev``. Returns (context manager,
    virtual)."""
    if vmesh.virtual():
        return contextlib.nullcontext(), True
    if sum(d.type == dev.type for d in vmesh.devices()) >= 2:
        return contextlib.nullcontext(), False
    return vmesh.forced(n, dev), True


def run_ladder(name: str = "B5", samples: int = 1, *, device=None,
               spec: RandomClusterSpec | None = None, smoke_spec: RandomClusterSpec | None = None,
               emit=None) -> list[dict]:
    """The ladder: the B1 smoke rung, then ``ladder_rungs(name)``; each
    line is passed to ``emit`` (default: printed) as it completes, and the
    lines are returned. ``CCX_BENCH_SKIP_SMOKE=1`` skips the smoke rung;
    ``CCX_BENCH_SHARDED=1`` runs on the virtual mesh when fewer than two
    devices are visible."""
    dev = resolve_device(device)
    if emit is None:
        def emit(line):
            print(json.dumps(line), flush=True)
    ctx, virtual = contextlib.nullcontext(), False
    if os.environ.get("CCX_BENCH_SHARDED") == "1":
        ctx, virtual = _mesh_context(dev)
    lines = []
    with ctx:
        if os.environ.get("CCX_BENCH_SKIP_SMOKE") != "1":
            r = run_config("B1", "smoke", device=dev, spec=smoke_spec)
            lines.append(rung_line("B1", "smoke", r, dev))
            emit(lines[-1])
        for rung in ladder_rungs(name):
            r = run_config(name, rung, samples, device=dev, spec=spec)
            line = rung_line(name, rung, r, dev)
            if virtual and line["mesh"] is not None:
                line["mesh"] = {**line["mesh"], "virtual": True}
            lines.append(line)
            emit(line)
    return lines


def scaling_layouts(n: int) -> list[tuple[int, int]]:
    """Every (chains, parts) split of an n-device mesh, chains-major."""
    return [(n // p, p) for p in (1, 2, 4, 8) if p <= n and n % p == 0]


def run_scaling(name: str = "B6", samples: int = 1, *, device=None,
                spec: RandomClusterSpec | None = None, n_devices: int | None = None) -> dict:
    """The multi-device scaling curve (``bench.py``'s ``run_scaling``): the
    chunk-driven mesh anneal at fixed work (``CCX_BENCH_CHAINS``/``STEPS``/
    ``MOVES``/``CHUNK``, default 8 x 50 x 8 in chunks of 25) on 1, 2, 4 and 8
    devices with every layout; each layout one cold run and ``samples``
    timed ones. Verified when the widest mesh's best layout improves the
    stack and ``verify_model_consistency`` finds nothing."""
    from ccx_torch.parallel.sharding import make_mesh
    from ccx_torch.search.annealer import AnnealOptions, anneal
    from ccx_torch.verify import verify_model_consistency

    dev = resolve_device(device)
    n_want = n_devices or int(os.environ.get("CCX_BENCH_DEVICES", VIRTUAL_DEVICES))
    chains = int(os.environ.get("CCX_BENCH_CHAINS", "8"))
    steps = int(os.environ.get("CCX_BENCH_STEPS", "50"))
    moves = int(os.environ.get("CCX_BENCH_MOVES", "8"))
    chunk = int(os.environ.get("CCX_BENCH_CHUNK", "25"))
    m = random_cluster(spec or bench_spec(name), device=dev)
    cfg = GoalConfig()
    opts = AnnealOptions(n_chains=chains, n_steps=steps, moves_per_step=moves, seed=3,
                         batched=True, chunk_steps=chunk)
    ctx, virtual = _mesh_context(dev, n_want)
    with ctx:
        devices = [d for d in vmesh.devices() if d.type == dev.type][:n_want]
        n_max = len(devices)
        log.info("[scaling] %s: P=%d B=%d devices=%d (virtual=%s) %dx%dx%d chunk %d",
                 name, m.P, m.B, n_max, virtual, chains, steps, moves, chunk)
        curve, wall1, n_widest, best_wide, result_wide = [], None, 0, None, None
        launches = {}
        for n in (1, 2, 4, 8):
            if n > n_max:
                continue
            n_widest, best_wide, result_wide = n, None, None
            layouts = {}
            for cx, px in scaling_layouts(n):
                mesh = make_mesh(devices[:n], parts=px)
                label = f"{cx}x{px}"
                t0 = time.monotonic()
                anneal(m, cfg, DEFAULT_GOAL_ORDER, opts, mesh=mesh)
                synchronize(dev)
                cold = time.monotonic() - t0
                walls = []
                l0 = agg_op.LAUNCHES
                for _ in range(max(samples, 1)):
                    t0 = time.monotonic()
                    r = anneal(m, cfg, DEFAULT_GOAL_ORDER, opts, mesh=mesh)
                    synchronize(dev)
                    walls.append(time.monotonic() - t0)
                launches[label] = agg_op.LAUNCHES - l0
                w = statistics.median(walls)
                layouts[label] = round(w, 3)
                log.info("[scaling] %ddev %s: warm %.2fs cold %.2fs", n, label, w, cold)
                if n == 1:
                    wall1 = w
                if best_wide is None or w < best_wide:
                    best_wide, result_wide = w, r
            curve.append({"devices": n, "layouts": layouts})
    verified = False
    if result_wide is not None:
        improved = float(result_wide.stack_after.soft_scalar) < float(
            result_wide.stack_before.soft_scalar)
        problems = verify_model_consistency(result_wide.model)
        verified = improved and not problems
        log.info("[scaling] verify: improved=%s problems=%s", improved, problems)
    best_wall = best_wide if best_wide is not None else wall1
    speedup = {}
    for row in curve:
        ws = list(row["layouts"].values())
        if ws and wall1:
            speedup[str(row["devices"])] = round(wall1 / min(ws), 3)
    return {
        "metric": f"{name} mesh-sharded chunked anneal wall (fixed work: {chains}x{steps}x{moves}, "
                  f"chunk {chunk})",
        "value": None if best_wall is None else round(best_wall, 3),
        "unit": "s",
        "vs_baseline": round(wall1 / best_wall, 3) if wall1 and best_wall else None,
        "backend": dev.type,
        "config": name,
        "scaling": True,
        "shape": {"P": int(m.P), "B": int(m.B)},
        "effort": {"chains": chains, "steps": steps, "moves": moves, "chunk_steps": chunk,
                   "samples": max(samples, 1)},
        "mesh": {"devices": n_max, "virtual": virtual},
        "verified": verified,
        "curve": curve,
        "speedup_vs_1dev": speedup,
        "launches": launches,
        "device": device_line(dev),
    }


def run_mesh_bench(name: str = "B5", *, device=None, spec: RandomClusterSpec | None = None,
                   n_devices: int | None = None, steps: tuple[int, int] = (10, 50)) -> dict:
    """The sharded SA step's slope (``bench.py``'s ``run_mesh_bench``): one
    parts axis over every device against the unsharded engine, at 8 chains
    x 8 moves, from the walls at ``steps[0]`` and ``steps[1]`` steps (each
    after an untimed call at the same budget). ``vs_baseline`` is the
    unsharded slope over the sharded one. Verified when the sharded runs
    verify as ``run_scaling``'s do."""
    from ccx_torch.parallel.sharding import make_mesh, sharded_anneal
    from ccx_torch.search.annealer import AnnealOptions, anneal
    from ccx_torch.verify import verify_model_consistency

    dev = resolve_device(device)
    n_want = n_devices or VIRTUAL_DEVICES
    m = random_cluster(spec or bench_spec(name), device=dev)
    cfg = GoalConfig()
    ctx, virtual = _mesh_context(dev, n_want)
    lo, hi = steps
    results: dict = {}
    with ctx:
        devices = [d for d in vmesh.devices() if d.type == dev.type]
        parts = len(devices)
        mesh = make_mesh(devices, parts=parts)
        log.info("[mesh] %s: P=%d B=%d mesh=%s virtual=%s", name, m.P, m.B, mesh.shape, virtual)

        def slope(fn, *extra):
            walls, launches = {}, {}
            for n in (lo, hi):
                opts = AnnealOptions(n_chains=8, n_steps=n, moves_per_step=8, seed=3, batched=True)
                fn(m, cfg, DEFAULT_GOAL_ORDER, opts, *extra)
                synchronize(dev)
                l0 = agg_op.LAUNCHES
                t0 = time.monotonic()
                r = fn(m, cfg, DEFAULT_GOAL_ORDER, opts, *extra)
                synchronize(dev)
                walls[n] = time.monotonic() - t0
                launches[n] = agg_op.LAUNCHES - l0
                results[(fn.__name__, n)] = r
            return (walls[hi] - walls[lo]) / (hi - lo), walls, launches

        s_sharded, w_sharded, l_sharded = slope(sharded_anneal, mesh)
        s_unsharded, w_unsharded, _ = slope(anneal)
    rs = results[("sharded_anneal", hi)]
    verified = (float(rs.stack_after.soft_scalar) < float(rs.stack_before.soft_scalar)
                and not verify_model_consistency(rs.model))
    return {
        "metric": f"{name} sharded-anneal step slope ({parts}-device parts mesh)",
        "value": round(s_sharded * 1e3, 2),
        "unit": "ms/step",
        "vs_baseline": round(s_unsharded / max(s_sharded, 1e-9), 3),
        "unsharded_ms_per_step": round(s_unsharded * 1e3, 2),
        "backend": dev.type,
        "n_devices": parts,
        "mesh": {**mesh.shape, "devices": parts, "virtual": virtual},
        "walls": {"sharded": w_sharded, "unsharded": w_unsharded},
        "launches": l_sharded,
        "verified": verified,
        "device": device_line(dev),
    }
