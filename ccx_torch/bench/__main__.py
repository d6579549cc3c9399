"""``python -m ccx_torch.bench``: the scenario corpus or the chaos run on the card.

    python -m ccx_torch.bench --scenario B5 [--windows N] [--seed S] [--families a,b]
    python -m ccx_torch.bench --chaos B5 [--iters N]

Each prints its JSON line (``ccx_torch.bench.runs``) and exits non-zero when
a gate failed. The environment twins of the JAX bench set the defaults:
``CCX_SCENARIO_WINDOWS``, ``CCX_SCENARIO_SEED``, ``CCX_SCENARIO_FAMILIES``,
``CCX_BENCH_CHAOS_ITERS`` and ``CCX_FAULTS_SEED``. Both run on the CUDA
device, which is probed first (``ccx_torch.device.ensure_responsive_backend``:
a failed or hung card raises; there is no CPU fallback). ``--device cpu``
runs them on the host.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ccx_torch.bench",
                                 description="ccx_torch scenario corpus and chaos run")
    run = ap.add_mutually_exclusive_group(required=True)
    run.add_argument("--scenario", metavar="CONFIG",
                     help="run the scenario corpus on config CONFIG (B1..B6)")
    run.add_argument("--chaos", metavar="CONFIG",
                     help="run the chaos schedule on config CONFIG (B1..B6)")
    ap.add_argument("--windows", type=int, default=_env_int("CCX_SCENARIO_WINDOWS"),
                    help="windows per family (default: optimizer.scenario.windows, 4)")
    ap.add_argument("--seed", type=int, default=_env_int("CCX_SCENARIO_SEED"),
                    help="the corpus seed (default: optimizer.scenario.seed, 7)")
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
        out = runs.run_scenario(args.scenario, windows=args.windows, seed=args.seed,
                                families=families, device=device)
    else:
        out = runs.run_chaos(args.chaos, n_iters=args.iters, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps(out), flush=True)
    return 0 if out["verified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
