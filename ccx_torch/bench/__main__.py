"""``python -m ccx_torch.bench``: one of the JAX bench's run modes on the card.

    python -m ccx_torch.bench --scenario B5 [--windows N] [--seed S] [--families a,b]
    python -m ccx_torch.bench --chaos B5 [--iters N]
    python -m ccx_torch.bench --soak B3 [--clusters N] [--ticks T] [--seed S]
    python -m ccx_torch.bench --steady-fleet B3 [--clusters N] [--windows W]
    python -m ccx_torch.bench --fleet B3 [--jobs N]
    python -m ccx_torch.bench --steady B5 [--iters N]
    python -m ccx_torch.bench --wire B5 [--iters N]
    python -m ccx_torch.bench --plan B5 [--evac CONFIG] [--evac-windows N] [--replan-iters N]
    python -m ccx_torch.bench --exchange-ab B3
    python -m ccx_torch.bench --ladder B5 [--samples N]
    python -m ccx_torch.bench --scaling B6 [--samples N]
    python -m ccx_torch.bench --mesh B5

Each prints its JSON line (``ccx_torch.bench.runs``, ``.serving``, ``.ab``,
``.ladder``) and exits non-zero when a gate failed; ``--ladder`` prints one
line per rung, then the final rung's again, and fails when a rung is
unverified. The environment twins of the JAX
bench set the defaults: ``CCX_SCENARIO_WINDOWS``, ``CCX_SCENARIO_SEED``,
``CCX_SCENARIO_FAMILIES``, ``CCX_BENCH_CHAOS_ITERS`` (14),
``CCX_FAULTS_SEED``, ``CCX_SOAK_CLUSTERS`` (2), ``CCX_SOAK_TICKS`` (96),
``CCX_SOAK_SEED`` (1729), ``CCX_BENCH_STEADYFLEET_CLUSTERS`` (16),
``CCX_BENCH_STEADYFLEET_WINDOWS`` (10), ``CCX_BENCH_FLEET_JOBS`` (16),
``CCX_BENCH_STEADY_ITERS`` (20), ``CCX_BENCH_WIRE_ITERS`` (20),
``CCX_PLAN_EVAC_BENCH`` (B3) and ``CCX_PLAN_EVAC_WINDOWS`` (4); the runs
themselves read ``CCX_SOAK_INJECT_START``, ``CCX_SOAK_INJECT_EVERY``,
``CCX_SOAK_LATENCY_BUDGET``, ``CCX_SOAK_DWELL_TARGET``,
``CCX_FLEET_MAX_CONCURRENT``, ``CCX_FLEET_DISPATCH_WIDTH``, ``CCX_PLAN_*``
(``ab.plan_knobs``) and ``CCX_EXCHANGE_*`` (``ab.exchange_knobs``).
``--replan-iters`` caps the plan's re-plan loop (default its bound, twice
the planner's waves). The ladder and the mesh modes read the JAX bench's
``CCX_BENCH_*`` knobs (``ccx_torch.bench.ladder``); ``--samples`` (default
1) sets their timed runs per rung or layout. All run on the CUDA device, which is probed first
(``ccx_torch.device.ensure_responsive_backend``: a failed or hung card
raises; there is no CPU fallback). ``--device cpu`` runs them on the host.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    return int(raw) if raw else None


def _pick(flag: int | None, env: str, default: int | None) -> int | None:
    """A flag shared by several runs: its value, else the run's environment
    twin, else the run's default."""
    if flag is not None:
        return flag
    from_env = _env_int(env)
    return default if from_env is None else from_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ccx_torch.bench",
                                 description="ccx_torch bench run modes")
    run = ap.add_mutually_exclusive_group(required=True)
    run.add_argument("--scenario", metavar="CONFIG",
                     help="run the scenario corpus on config CONFIG (B1..B6)")
    run.add_argument("--chaos", metavar="CONFIG",
                     help="run the chaos schedule on config CONFIG (B1..B6)")
    run.add_argument("--soak", metavar="CONFIG",
                     help="run the closed-loop soak on config CONFIG (B1..B6)")
    run.add_argument("--steady-fleet", metavar="CONFIG",
                     help="run the steady-state fleet on config CONFIG (B1..B6)")
    run.add_argument("--fleet", metavar="CONFIG",
                     help="run N concurrent cold Propose jobs on config CONFIG (B1..B6)")
    run.add_argument("--steady", metavar="CONFIG",
                     help="run one session's warm loop on config CONFIG (B1..B6)")
    run.add_argument("--wire", metavar="CONFIG",
                     help="run the sidecar's wire split on config CONFIG (B1..B6)")
    run.add_argument("--plan", metavar="CONFIG",
                     help="run the movement-plan A/B on config CONFIG (B1..B6)")
    run.add_argument("--exchange-ab", metavar="CONFIG",
                     help="run the replica-exchange A/B on config CONFIG (B1..B6)")
    run.add_argument("--ladder", metavar="CONFIG",
                     help="run the default effort ladder on config CONFIG (B1..B6)")
    run.add_argument("--scaling", metavar="CONFIG",
                     help="run the mesh scaling curve on config CONFIG (B1..B6)")
    run.add_argument("--mesh", metavar="CONFIG",
                     help="run the sharded SA step slope on config CONFIG (B1..B6)")
    ap.add_argument("--samples", type=int, default=1,
                    help="warm runs per ladder rung or timed runs per scaling layout (default 1)")
    ap.add_argument("--windows", type=int, default=None,
                    help="windows per family (default: optimizer.scenario.windows, 4) or "
                         "per steady-fleet cluster (default 10)")
    ap.add_argument("--seed", type=int, default=None,
                    help="the corpus seed (default: optimizer.scenario.seed, 7) or the "
                         "soak's seed (default 1729)")
    ap.add_argument("--clusters", type=int, default=None,
                    help="soak clusters (default 2) or steady-fleet clusters (default 16)")
    ap.add_argument("--ticks", type=int, default=_env_int("CCX_SOAK_TICKS") or 96,
                    help="soak ticks per cluster (default 96)")
    ap.add_argument("--families", default=os.environ.get("CCX_SCENARIO_FAMILIES", ""),
                    help="comma-separated families (default: all five)")
    ap.add_argument("--iters", type=int, default=None,
                    help="faulted windows of the chaos run (default 14: two cycles) or "
                         "measured windows of the steady loop or the wire split (default 20)")
    ap.add_argument("--jobs", type=int, default=None, help="fleet jobs (default 16)")
    ap.add_argument("--evac", default=os.environ.get("CCX_PLAN_EVAC_BENCH", "B3"),
                    help="the plan A/B's evacuation config (default B3)")
    ap.add_argument("--evac-windows", type=int, default=_env_int("CCX_PLAN_EVAC_WINDOWS") or 4,
                    help="the plan A/B's evacuation windows (default 4)")
    ap.add_argument("--replan-iters", type=int, default=None,
                    help="cap of the plan A/B's re-plan loop (default twice the planner's waves)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    from ccx_torch.bench import ab, ladder, runs, serving
    from ccx_torch.device import ensure_responsive_backend, resolve_device, synchronize

    device = resolve_device(args.device)
    if device.type == "cuda":
        ensure_responsive_backend()
    if args.ladder:
        lines = ladder.run_ladder(args.ladder, args.samples, device=device)
        synchronize(device)
        print(json.dumps(lines[-1]), flush=True)
        return 0 if all(ln["verified"] for ln in lines) else 1
    if args.scaling:
        out = ladder.run_scaling(args.scaling, args.samples, device=device)
    elif args.mesh:
        out = ladder.run_mesh_bench(args.mesh, device=device)
    elif args.scenario:
        families = tuple(f.strip() for f in args.families.split(",") if f.strip())
        out = runs.run_scenario(
            args.scenario, windows=_pick(args.windows, "CCX_SCENARIO_WINDOWS", None),
            seed=_pick(args.seed, "CCX_SCENARIO_SEED", None), families=families, device=device)
    elif args.chaos:
        out = runs.run_chaos(args.chaos, n_iters=_pick(args.iters, "CCX_BENCH_CHAOS_ITERS", 14),
                             device=device)
    elif args.soak:
        out = runs.run_soak(args.soak, _pick(args.clusters, "CCX_SOAK_CLUSTERS", 2),
                            args.ticks, _pick(args.seed, "CCX_SOAK_SEED", 1729), device=device)
    elif args.steady_fleet:
        out = runs.run_steady_fleet(
            args.steady_fleet, _pick(args.clusters, "CCX_BENCH_STEADYFLEET_CLUSTERS", 16),
            _pick(args.windows, "CCX_BENCH_STEADYFLEET_WINDOWS", 10), device=device)
    elif args.fleet:
        out = serving.run_fleet(args.fleet, _pick(args.jobs, "CCX_BENCH_FLEET_JOBS", 16),
                                device=device)
    elif args.steady:
        out = serving.run_steady(args.steady, _pick(args.iters, "CCX_BENCH_STEADY_ITERS", 20),
                                 device=device)
    elif args.wire:
        out = serving.run_wire(args.wire, _pick(args.iters, "CCX_BENCH_WIRE_ITERS", 20),
                               device=device)
    elif args.plan:
        out = ab.run_plan(args.plan, args.evac, max(args.evac_windows, 1), device=device,
                          replan_iters=args.replan_iters)
    else:
        out = ab.run_exchange_ab(args.exchange_ab, device=device)
    synchronize(device)
    print(json.dumps(out), flush=True)
    return 0 if out["verified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
