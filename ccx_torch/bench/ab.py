"""The movement-plan A/B and the replica-exchange A/B.

Ports of the JAX bench's ``run_plan`` and ``run_exchange_ab`` (``bench.py``,
``--plan`` and ``--exchange-ab``) onto the port's optimizer, movement
planner and annealer. Each returns its JSON line: every key of the
``parsed`` block of the JAX bench's ``PLAN_r*.json`` or
``EXCHANGE_r*.json``, plus the device and the ``broker_aggregates``
launches of each phase. ``verified`` is the JAX run's own conjunction.

* ``run_plan``: (1) the cold diff A/B: one smoke-rung optimize of config
  ``name`` with the planner armed, its diff planned by the device loop and
  by the numpy oracle (every output array equal) against
  ``naive_schedule`` under the same per-broker cap, and the movement-cost
  tier on the device and in numpy (within 1e-3, relative); (2) the warm
  re-plan loop: wave 0 lands as a delta, re-diff, re-plan, until one wave
  is left; (3) the disk-evacuation family of ``ccx_torch.bench.scenarios``
  on the ``evac_name`` base, each cumulative window optimized and its diff
  planned against the naive schedule. Gates: planned no worse than naive on
  makespan and peak inflow for the cold diff and the evacuation total, the
  oracle pins, every optimize verified, no kernel build in the re-plan
  loop.
* ``run_exchange_ab``: seeded SA on config ``name``'s fixture with taps
  armed, the flat chain batch (``n_temps=1``) against the ladder
  (``n_temps=K``) at equal chains, steps and chunk; then a flat run with a
  non-default exchange interval, which must return the flat arm's
  placement bit for bit (at K=1 there is no ladder code to run), and the
  ladder at another step budget, which must build nothing. Gates: the
  ladder reaches the flat arm's plateau cost in fewer chunks or ends
  lexicographically better, the K=1 probe is bit-exact, and the retune
  built nothing.

Deliberate differences from the JAX bench:

1. Passes whose only job is to pay XLA compiles are dropped: the JAX
   exchange A/B runs each arm once untimed before the timed run, and the
   JAX plan A/B runs its whole re-plan loop once before the measured one.
   The port compiles nothing per shape (its search is eager PyTorch and
   its one kernel is built once per process), so each arm and the loop run
   once, measured. The zero-compile gates read ``nvcc`` builds
   (``ccx_torch.common.compilestats``) over that measured pass, and
   ``prewarm_iters`` is 0.
2. The re-plan loop plans on the backend the port's size rule picks
   (``movement.DEVICE_PLAN_MIN_ROWS``) where the JAX loop forces its
   compiled device program; the cold A/B pins the device loop against the
   oracle, as the JAX run does. The device loop is a chain of launches per
   diff row (about 1.8 ms a row on an H100: 97 s for B5's 53k-row cold
   diff), so no plan of one diff is made twice: the cold A/B holds the
   optimize's shipped plan when the size rule made it on the device loop,
   and the loop starts from the A/B's plan. ``replan_iters`` caps the loop
   below its ``2 * max_waves`` bound (a cut, recorded on the line).
3. Neither run banks its line into a ``*_r*.json`` file in the checkout;
   the caller keeps the printed line.

Both run on the CUDA device unless the caller asks for another
(``device="cpu"``: the tests).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from ccx_torch.bench import scenarios as sc
from ccx_torch.bench.runs import device_line
from ccx_torch.common import compilestats
from ccx_torch.common.convergence import lex_improved, plateau_chunk
from ccx_torch.common.resources import Resource
from ccx_torch.device import resolve_device, synchronize
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx_torch.model.snapshot import arrays_to_model, model_to_arrays
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.proposals import columnar_diff
from ccx_torch.rungs import build_opts
from ccx_torch.search import telemetry
from ccx_torch.search.annealer import AnnealOptions, anneal
from ccx_torch.search.movement import PlanOptions, movement_cost, naive_schedule, plan_movement

log = logging.getLogger(__name__)

#: the A/B's slack on makespan and peak inflow (the bench's)
PLAN_EPS = 1e-3
#: the exchange A/B's moves per SA step (the bench's)
EXCHANGE_MOVES = 2
#: the K=1 probe's exchange interval (any but the default 1)
K1_INTERVAL = 3


def _env(name: str, default, kind=int):
    raw = os.environ.get(name)
    return kind(raw) if raw else default


def plan_knobs() -> dict:
    """The plan A/B's planner knobs from the JAX run's environment twins:
    ``CCX_PLAN_CAP`` (5), ``CCX_PLAN_MAX_WAVES`` (64),
    ``CCX_PLAN_WAVE_BYTES_MB`` (0), ``CCX_PLAN_THROTTLE_MBPS`` (0) and
    ``CCX_PLAN_SEED`` (7, the evacuation family's seed)."""
    return {
        "cap": _env("CCX_PLAN_CAP", 5),
        "max_waves": _env("CCX_PLAN_MAX_WAVES", 64),
        "wave_mb": _env("CCX_PLAN_WAVE_BYTES_MB", 0.0, float),
        "throttle": _env("CCX_PLAN_THROTTLE_MBPS", 0.0, float),
        "seed": _env("CCX_PLAN_SEED", 7),
    }


def exchange_knobs() -> dict:
    """The exchange A/B's knobs from the JAX run's environment twins:
    ``CCX_EXCHANGE_TEMPS`` (4), ``_CHAINS`` (16), ``_STEPS`` (1200),
    ``_CHUNK`` (40), ``_INTERVAL`` (1) and ``_SEED`` (17)."""
    return {
        "n_temps": _env("CCX_EXCHANGE_TEMPS", 4),
        "chains": _env("CCX_EXCHANGE_CHAINS", 16),
        "steps": _env("CCX_EXCHANGE_STEPS", 1200),
        "chunk": _env("CCX_EXCHANGE_CHUNK", 40),
        "interval": _env("CCX_EXCHANGE_INTERVAL", 1),
        "seed": _env("CCX_EXCHANGE_SEED", 17),
    }


#: the plan A/B's brief of a plan: these keys of ``MovementPlan.summary_json``
PLAN_BRIEF = ("nWaves", "nMoves", "bytesMoved", "peakInflowMb", "makespanSeconds",
              "overflowRows", "backend")


def plan_ab(dcols, bytes_pp: np.ndarray, n_brokers: int, popts: PlanOptions,
            device=None, planned=None) -> tuple:
    """One planned-against-naive A/B of a diff: ``(plan, oracle_match,
    line)``. The plan runs on ``popts``' backend (its device loop on
    ``device``), or is ``planned``, a ``(plan, seconds)`` of this diff
    already made on that backend with these knobs; it is held against the
    numpy oracle on every output array, and the naive schedule runs under
    the same cap and throttle."""
    if planned is None:
        t0 = time.monotonic()
        plan = plan_movement(dcols, bytes_pp, n_brokers, popts, device=device)
        plan_wall = time.monotonic() - t0
    else:
        plan, plan_wall = planned
        if plan.backend != popts.backend or dataclasses.replace(
                plan.opts, backend=popts.backend) != popts:
            raise ValueError(f"the given plan ran on {plan.backend} with {plan.opts}, "
                             f"not with {popts}")
    oracle = plan_movement(dcols, bytes_pp, n_brokers,
                           dataclasses.replace(popts, backend="numpy"))
    match = bool(
        np.array_equal(plan.wave, oracle.wave)
        and np.array_equal(plan.wave_bytes, oracle.wave_bytes)
        and np.array_equal(plan.wave_inflow_peak, oracle.wave_inflow_peak)
        and np.array_equal(plan.wave_outflow_peak, oracle.wave_outflow_peak)
    )
    t0 = time.monotonic()
    naive = naive_schedule(dcols, bytes_pp, n_brokers, cap=popts.broker_cap,
                           throttle_mb_per_sec=popts.throttle_mb_per_sec)
    naive_wall = time.monotonic() - t0
    better = bool(plan.makespan_seconds <= naive["makespanSeconds"] + PLAN_EPS
                  and plan.peak_inflow <= naive["peakInflowMb"] + PLAN_EPS)
    cols = dcols.cols if hasattr(dcols, "cols") else dcols
    return plan, match, {
        "rows": int(np.asarray(cols["partition"]).shape[0]),
        "planned": {k: v for k, v in plan.summary_json().items() if k in PLAN_BRIEF},
        "naive": {
            "rounds": naive["rounds"],
            "makespanSeconds": round(naive["makespanSeconds"], 3),
            "peakInflowMb": round(naive["peakInflowMb"], 3),
            "nMoves": naive["nMoves"],
        },
        "planned_better": better,
        "oracle_match": match,
        "plan_wall_s": round(plan_wall, 3),
        "naive_wall_s": round(naive_wall, 3),
    }


def _disk_bytes(m: TensorClusterModel) -> np.ndarray:
    return m.leader_load[Resource.DISK].cpu().numpy().astype(np.float32)


def run_plan(name: str = "B5", evac_name: str = "B3", evac_windows: int = 4, *, device=None,
             replan_iters: int | None = None, spec: RandomClusterSpec | None = None,
             evac_spec: RandomClusterSpec | None = None, goals: tuple[str, ...] | None = None,
             opts: OptimizeOptions | None = None) -> dict:
    """The movement-plan A/B (module docstring). ``replan_iters`` caps the
    re-plan loop (default its ``2 * max_waves`` bound); ``spec`` and
    ``evac_spec`` replace the two configs' fixtures, ``goals`` and ``opts``
    both configs' stack and smoke-rung options (the tests' small sizes; the
    planner knobs are set over them)."""
    dev = resolve_device(device)
    k = plan_knobs()
    cap, max_waves, wave_mb, throttle = k["cap"], k["max_waves"], k["wave_mb"], k["throttle"]
    limit = 2 * max_waves if replan_iters is None else max(int(replan_iters), 0)
    popts_dev = PlanOptions(broker_cap=cap, wave_bytes=wave_mb, max_waves=max_waves,
                            throttle_mb_per_sec=throttle, backend="device")
    # the loop's backend: the size rule's
    popts_loop = dataclasses.replace(popts_dev, backend=None)
    popts_np = dataclasses.replace(popts_dev, backend="numpy")
    cfg = GoalConfig()
    launches: dict = {}

    def rung(config: str) -> tuple[tuple[str, ...], OptimizeOptions]:
        g, o, _ = build_opts(config, "smoke")
        return goals or g, dataclasses.replace(
            opts or o, plan_enabled=True, plan_broker_cap=cap, plan_max_waves=max_waves,
            plan_wave_bytes_mb=wave_mb, plan_throttle_mb_per_sec=throttle)

    # ----- 1. the cold diff A/B -----------------------------------------------
    m0 = random_cluster(spec or bench_spec(name), device=dev)
    goal_names, oopts = rung(name)
    n0 = agg_op.LAUNCHES
    t0 = time.monotonic()
    res = optimize(m0, cfg, goal_names, oopts)
    synchronize(dev)
    cold_s = time.monotonic() - t0
    launches["cold"] = agg_op.LAUNCHES - n0
    bytes_pp = _disk_bytes(m0)
    B = int(m0.B)
    log.info("plan: cold optimize %.1fs, %d diff rows, verified=%s, shipped plan %s", cold_s,
             res.diff.n, res.verification.ok, res.plan.summary_json() if res.plan else None)
    # the optimize's shipped plan is the device loop's plan of this diff
    # with these knobs when the size rule sent it there: held as it is
    shipped = None
    if res.plan is not None and res.plan.backend == "device":
        shipped = (res.plan, res.phase_seconds["plan"])
    cold_plan, cold_match, cold_ab = plan_ab(res.diff, bytes_pp, B, popts_dev, device=dev,
                                             planned=shipped)
    cold_ab["shipped_plan_held"] = shipped is not None
    log.info("plan: cold A/B makespan %s against naive %s, peak %s against %s, oracle %s",
             cold_ab["planned"]["makespanSeconds"], cold_ab["naive"]["makespanSeconds"],
             cold_ab["planned"]["peakInflowMb"], cold_ab["naive"]["peakInflowMb"], cold_match)
    # the movement-cost tier (f32 device sums against f64 host sums)
    n0 = agg_op.LAUNCHES
    bm_d, pk_d = movement_cost(m0, res.model, backend="device")
    bm_n, pk_n = movement_cost(m0, res.model, backend="numpy")
    launches["cost_tier"] = agg_op.LAUNCHES - n0
    cost_match = bool(abs(bm_d - bm_n) <= 1e-3 * max(abs(bm_n), 1.0)
                      and abs(pk_d - pk_n) <= 1e-3 * max(abs(pk_n), 1.0))

    # ----- 2. the warm re-plan loop -------------------------------------------
    cs0 = compilestats.snapshot()
    n0 = agg_op.LAUNCHES
    t0 = time.monotonic()
    a_cur = m0.assignment.cpu().numpy().copy()
    dcols = res.diff.cols
    # the loop starts from the cold diff's plan: the oracle pin made it equal
    # to what either backend returns
    plan = cold_plan if cold_match else plan_movement(dcols, bytes_pp, B, popts_loop, device=dev)
    replan_walls: list = []
    replan_backends: list = []
    replan_rows: list = []
    while plan.n_waves > 1 and len(replan_walls) < limit:
        part, new = dcols["partition"], dcols["newReplicas"]
        w0 = plan.wave == 0
        a_cur[part[w0], : new.shape[1]] = new[w0]
        mid = m0.replace(assignment=torch.from_numpy(a_cur).to(dev))
        dcols = columnar_diff(mid, res.model).cols
        t1 = time.monotonic()
        plan = plan_movement(dcols, bytes_pp, B, popts_loop, device=dev)
        replan_walls.append(time.monotonic() - t1)
        replan_backends.append(plan.backend)
        replan_rows.append(int(dcols["partition"].shape[0]))
        log.info("plan: re-plan %d: %d rows, %d waves, %s, %.2fs", len(replan_walls),
                 replan_rows[-1], plan.n_waves, plan.backend, replan_walls[-1])
    replan_s = time.monotonic() - t0
    launches["replan"] = agg_op.LAUNCHES - n0
    fresh = compilestats.delta(cs0, compilestats.snapshot())["backend_compiles"]
    replan_done = plan.n_waves <= 1

    # ----- 3. the disk-evacuation family --------------------------------------
    n0 = agg_op.LAUNCHES
    m_e = random_cluster(evac_spec or bench_spec(evac_name), device=dev)
    egoals, eopts = rung(evac_name)
    res_clean = optimize(m_e, cfg, egoals, eopts)
    applied = model_to_arrays(res_clean.model)
    sopts = sc.ScenarioOptions(seed=k["seed"], windows=max(int(evac_windows), 1),
                               families=("disk-evacuation",))
    placement = ("assignment", "leader_slot", "replica_disk")
    cur = {f: applied[f] for f in placement}
    windows_out: list = []
    evac_ok = bool(res_clean.verification.ok)
    evac_oracle = True
    planned_ms = naive_ms = planned_pk = naive_pk = 0.0
    n_move_windows = 0
    for w in sc.generate("disk-evacuation", applied, sopts):
        arrays = {**w.arrays, **cur}  # cumulative: the previous window's placement
        m_w = arrays_to_model(arrays, device=dev)
        r = optimize(m_w, cfg, egoals, eopts)
        out_arrays = model_to_arrays(r.model)
        cur = {f: out_arrays[f] for f in placement}
        evac_ok = evac_ok and bool(r.verification.ok)
        row = {"label": w.label, "rows": int(r.diff.n), "verified": bool(r.verification.ok)}
        if r.diff.n:
            _, match_w, ab_w = plan_ab(r.diff, _disk_bytes(m_w), int(m_w.B), popts_np)
            row.update(ab_w)
            evac_oracle = evac_oracle and match_w
            planned_ms += ab_w["planned"]["makespanSeconds"]
            naive_ms += ab_w["naive"]["makespanSeconds"]
            planned_pk = max(planned_pk, ab_w["planned"]["peakInflowMb"])
            naive_pk = max(naive_pk, ab_w["naive"]["peakInflowMb"])
            n_move_windows += 1
        windows_out.append(row)
        log.info("plan: evacuation window %r: %d rows, planned %s, naive %s", w.label,
                 row["rows"], row.get("planned", {}).get("makespanSeconds"),
                 row.get("naive", {}).get("makespanSeconds"))
    launches["evacuation"] = agg_op.LAUNCHES - n0
    evac_better = bool(n_move_windows >= 1 and planned_ms <= naive_ms + PLAN_EPS
                       and planned_pk <= naive_pk + PLAN_EPS)

    planned_better = bool(cold_ab["planned_better"] and evac_better)
    oracle_match = bool(cold_match and evac_oracle and cost_match)
    verified = bool(planned_better and oracle_match and int(fresh) == 0
                    and res.verification.ok and evac_ok)
    return {
        "plan": True,
        "rung": "plan",
        "bench": name,
        "backend": dev.type,
        "device": device_line(dev),
        "broker_cap": cap,
        "max_waves": max_waves,
        "wave_bytes_mb": wave_mb,
        "throttle_mb_per_sec": throttle,
        "seed": k["seed"],
        "value": cold_ab["planned"]["makespanSeconds"],
        "cold_s": round(cold_s, 3),
        "cold_verified": bool(res.verification.ok),
        "cold_ab": cold_ab,
        "shipped_plan": res.plan.summary_json() if res.plan is not None else None,
        "cost_tier": {
            "device": [round(bm_d, 3), round(pk_d, 3)],
            "numpy": [round(bm_n, 3), round(pk_n, 3)],
            "match": cost_match,
        },
        "replan": {
            "iters": len(replan_walls),
            "prewarm_iters": 0,
            "wall_s": round(replan_s, 3),
            "plan_walls_s": [round(x, 4) for x in replan_walls],
            "fresh_compiles": int(fresh),
            "limit": limit,
            "done": replan_done,
            "backends": replan_backends,
            "rows": replan_rows,
        },
        "evacuation": {
            "bench": evac_name,
            "windows": windows_out,
            "move_windows": n_move_windows,
            "planned_makespan": round(planned_ms, 3),
            "naive_makespan": round(naive_ms, 3),
            "planned_peak": round(planned_pk, 3),
            "naive_peak": round(naive_pk, 3),
            "planned_better": evac_better,
            "verified": evac_ok,
        },
        "planned_better": planned_better,
        "oracle_match": oracle_match,
        "fresh_compiles_in_replan": int(fresh),
        "verified": verified,
        "launches": {"broker_aggregates": launches},
    }


def _arm(r, wall: float, launches: int) -> dict:
    series = (r.convergence or {}).get("series") or []
    return {
        "wall_s": round(wall, 3),
        "plateau_chunk": plateau_chunk(series),
        "chunks": len(series),
        "final": [float(x) for x in r.stack_after.costs.cpu().tolist()],
        "chains": r.n_chains,
        "accepted": r.n_accepted,
        "engine": r.engine,
        "hard_after": float(r.stack_after.hard_violations),
        "violations_after": {n: v for n, (v, _) in r.stack_after.by_name().items()},
        "launches": launches,
    }


def run_exchange_ab(name: str = "B3", *, device=None, model: TensorClusterModel | None = None,
                    spec: RandomClusterSpec | None = None, goals: tuple[str, ...] | None = None,
                    anneal_opts: AnnealOptions | None = None) -> dict:
    """The flat chain batch against the ladder (module docstring) on
    ``model`` (default: config ``name``'s fixture, or ``spec``'s) and
    ``goals`` (default the full stack). ``anneal_opts`` (default the JAX
    run's: ``exchange_knobs()`` chains, steps, chunk and seed, 2 moves per
    step) is the flat arm; the ladder is it with ``exchange_knobs()``'s
    rungs, exchanging every ``interval`` chunks."""
    k = exchange_knobs()
    n_temps, interval = k["n_temps"], k["interval"]
    if anneal_opts is None:
        anneal_opts = AnnealOptions(n_chains=k["chains"], n_steps=k["steps"],
                                    moves_per_step=EXCHANGE_MOVES, seed=k["seed"],
                                    chunk_steps=k["chunk"])
    dev = resolve_device(device) if model is None else model.device
    m = model if model is not None else random_cluster(spec or bench_spec(name), device=dev)
    cfg = GoalConfig()
    goal_names = goals or DEFAULT_GOAL_ORDER
    flat_opts = dataclasses.replace(anneal_opts, n_temps=1)
    ladder_opts = dataclasses.replace(anneal_opts, n_temps=n_temps, exchange_interval=interval)

    def drive(opts: AnnealOptions):
        n0 = agg_op.LAUNCHES
        t0 = time.monotonic()
        r = anneal(m, cfg, goal_names, opts)
        synchronize(dev)
        return r, time.monotonic() - t0, agg_op.LAUNCHES - n0

    with telemetry.taps(True):
        r_flat, wall_flat, n_flat = drive(flat_opts)
        log.info("exchange: flat arm %.1fs (%s engine)", wall_flat, r_flat.engine)
        r_ladder, wall_ladder, n_ladder = drive(ladder_opts)
        log.info("exchange: ladder arm %.1fs", wall_ladder)

        # the K=1 probe: the flat arm's placement, bit for bit
        r_k1, wall_k1, n_k1 = drive(dataclasses.replace(flat_opts, exchange_interval=K1_INTERVAL))
        k1_bitexact = bool(torch.equal(r_k1.model.assignment, r_flat.model.assignment)
                           and torch.equal(r_k1.model.is_leader, r_flat.model.is_leader))
        k1_split = None
        if not k1_bitexact:
            # where the two runs part: the first chunk whose tap row differs
            fs = (r_flat.convergence or {}).get("series") or []
            ks = (r_k1.convergence or {}).get("series") or []
            k1_split = next((i for i, (a, b) in enumerate(zip(fs, ks)) if a != b), None)
        log.info("exchange: K=1 probe %.1fs, bit-exact %s", wall_k1, k1_bitexact)

        # the retune: another step budget builds nothing
        cs0 = compilestats.snapshot()
        _, wall_retune, n_retune = drive(
            dataclasses.replace(ladder_opts, n_steps=2 * anneal_opts.chunk_steps))
        fresh = compilestats.delta(cs0, compilestats.snapshot())["backend_compiles"]

    flat_series = (r_flat.convergence or {}).get("series") or []
    ladder_series = (r_ladder.convergence or {}).get("series") or []
    flat = _arm(r_flat, wall_flat, n_flat)
    ladder = _arm(r_ladder, wall_ladder, n_ladder)
    flat_best = flat_series[flat["plateau_chunk"]] if flat_series else flat["final"]
    # the first chunk where the ladder is at least as good (lex) as the flat
    # arm's plateau cost; None: never
    reached = next((i for i, row in enumerate(ladder_series) if not lex_improved(flat_best, row)),
                   None)
    ladder_better = bool((reached is not None and reached < flat["plateau_chunk"])
                         or lex_improved(ladder["final"], flat["final"]))
    exchange = (r_ladder.convergence or {}).get("exchange") or {}
    attempted = sum(exchange.get("attempted") or [])
    accepted = sum(exchange.get("accepted") or [])
    ladder.update(reached_flat_plateau_chunk=reached, exchange_attempted=attempted,
                  exchange_accepted=accepted,
                  exchange_accept_rate=round(accepted / attempted, 4) if attempted else None)
    return {
        "exchange_ab": True,
        "rung": "exchange-ab",
        "bench": name,
        "backend": dev.type,
        "device": device_line(dev),
        "chains": anneal_opts.n_chains,
        "steps": anneal_opts.n_steps,
        "chunk": anneal_opts.chunk_steps,
        "moves": anneal_opts.moves_per_step,
        "n_temps": n_temps,
        "interval": interval,
        "seed": anneal_opts.seed,
        "value": round(wall_ladder, 3),
        "flat": flat,
        "ladder": ladder,
        "ladder_better": ladder_better,
        "k1_bitexact": k1_bitexact,
        "k1": {"interval": K1_INTERVAL, "wall_s": round(wall_k1, 3), "launches": n_k1,
               "first_differing_chunk": k1_split},
        "fresh_compiles_on_retune": int(fresh),
        "retune": {"steps": 2 * anneal_opts.chunk_steps, "wall_s": round(wall_retune, 3),
                   "launches": n_retune},
        "verified": bool(ladder_better and k1_bitexact and int(fresh) == 0),
        "convergence": {"phases": {"anneal": [r_ladder.convergence]}},
        "launches": {"broker_aggregates": {"flat": n_flat, "ladder": n_ladder, "k1": n_k1,
                                           "retune": n_retune}},
    }
