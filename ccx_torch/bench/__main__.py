"""``python -m ccx_torch.bench``: the scenario corpus, the chaos run, the
soak or the steady fleet on the card.

    python -m ccx_torch.bench --scenario B5 [--windows N] [--seed S] [--families a,b]
    python -m ccx_torch.bench --chaos B5 [--iters N]
    python -m ccx_torch.bench --soak B3 [--clusters N] [--ticks T] [--seed S]
    python -m ccx_torch.bench --steady-fleet B3 [--clusters N] [--windows W]

Each prints its JSON line (``ccx_torch.bench.runs``) and exits non-zero when
a gate failed. The environment twins of the JAX bench set the defaults:
``CCX_SCENARIO_WINDOWS``, ``CCX_SCENARIO_SEED``, ``CCX_SCENARIO_FAMILIES``,
``CCX_BENCH_CHAOS_ITERS``, ``CCX_FAULTS_SEED``, ``CCX_SOAK_CLUSTERS`` (2),
``CCX_SOAK_TICKS`` (96), ``CCX_SOAK_SEED`` (1729),
``CCX_BENCH_STEADYFLEET_CLUSTERS`` (16) and ``CCX_BENCH_STEADYFLEET_WINDOWS``
(10); the runs themselves read ``CCX_SOAK_INJECT_START``,
``CCX_SOAK_INJECT_EVERY``, ``CCX_SOAK_LATENCY_BUDGET``,
``CCX_SOAK_DWELL_TARGET``, ``CCX_FLEET_MAX_CONCURRENT`` and
``CCX_FLEET_DISPATCH_WIDTH``. All run on the CUDA device, which is probed
first (``ccx_torch.device.ensure_responsive_backend``: a failed or hung card
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
                                 description="ccx_torch scenario corpus, chaos run, soak and steady fleet")
    run = ap.add_mutually_exclusive_group(required=True)
    run.add_argument("--scenario", metavar="CONFIG",
                     help="run the scenario corpus on config CONFIG (B1..B6)")
    run.add_argument("--chaos", metavar="CONFIG",
                     help="run the chaos schedule on config CONFIG (B1..B6)")
    run.add_argument("--soak", metavar="CONFIG",
                     help="run the closed-loop soak on config CONFIG (B1..B6)")
    run.add_argument("--steady-fleet", metavar="CONFIG",
                     help="run the steady-state fleet on config CONFIG (B1..B6)")
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
    ap.add_argument("--iters", type=int, default=_env_int("CCX_BENCH_CHAOS_ITERS") or 14,
                    help="faulted windows of the chaos run (default 14: two cycles)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    import torch

    from ccx_torch.bench import runs
    from ccx_torch.device import ensure_responsive_backend, resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        ensure_responsive_backend()
    if args.scenario:
        families = tuple(f.strip() for f in args.families.split(",") if f.strip())
        out = runs.run_scenario(
            args.scenario, windows=_pick(args.windows, "CCX_SCENARIO_WINDOWS", None),
            seed=_pick(args.seed, "CCX_SCENARIO_SEED", None), families=families, device=device)
    elif args.chaos:
        out = runs.run_chaos(args.chaos, n_iters=args.iters, device=device)
    elif args.soak:
        out = runs.run_soak(args.soak, _pick(args.clusters, "CCX_SOAK_CLUSTERS", 2),
                            args.ticks, _pick(args.seed, "CCX_SOAK_SEED", 1729), device=device)
    else:
        out = runs.run_steady_fleet(
            args.steady_fleet, _pick(args.clusters, "CCX_BENCH_STEADYFLEET_CLUSTERS", 16),
            _pick(args.windows, "CCX_BENCH_STEADYFLEET_WINDOWS", 10), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps(out), flush=True)
    return 0 if out["verified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
