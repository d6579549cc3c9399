#!/usr/bin/env python3
"""Replay scenario families through the port's warm path, several times
from one cold result, and print each window's hard violations stage by
stage: one JSON line per window and repeat.

The cold base is ``ccx_torch.optimizer.optimize`` at the config's target
rung, its placement applied (the scenario run's base); ``--fresh-cold``
solves it again for every repeat (on the card two cold solves differ in
their float sums' order, so their placements differ). Each repeat replays
the family's windows (``ccx_torch.bench.scenarios.generate``, seed 7) from
that base with the steady rung's warm budget, banking each verified result
as the next window's base, as the scenario run does. Per window: the wall,
``verified`` and its failures, the hard violations per goal after the
warm base is grafted (``warm``), after the structural path's repair
(``repair``) and warm SA (``anneal``), in the shipped result (``final``) and
in the shipped placement scored with the plain aggregates (``final_plain``),
and the incremental block. The stage records tell where a window that fails
in one repeat and passes in another parts. ``--heal N`` also takes, on a
window whose warm SA left a hard violation, the annealed placement through
each candidate last stage with seeds 0..N-1 and records the hard violations
left: the warm swap polish (``swap``), the rung's polish for the swap
budget's iterations (``polish``) and its leadership-only form
(``leader``).

    python3 tools/torch_scenario_stages.py --family hot-skew --repeats 5
    python3 tools/torch_scenario_stages.py --family hot-skew --repeats 8 --fresh-cold
    python3 tools/torch_scenario_stages.py --family hot-skew --repeats 4 --fresh-cold --heal 8
    python3 tools/torch_scenario_stages.py --config B3 --device cpu --repeats 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="B5")
    ap.add_argument("--family", action="append", default=None,
                    help="family to replay (repeatable; default hot-skew)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fresh-cold", action="store_true",
                    help="solve the cold base again for every repeat")
    ap.add_argument("--heal", type=int, default=0, metavar="N",
                    help="seeds of each candidate last stage on an annealed placement "
                         "that kept a hard violation")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    from ccx_torch import rungs
    from ccx_torch.bench import scenarios as sc
    from ccx_torch.device import resolve_device
    from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
    from ccx_torch.goals.stack import evaluate_stack
    from ccx_torch.model.fixtures import bench_spec, random_cluster
    from ccx_torch.model.snapshot import arrays_to_model, model_to_arrays
    from ccx_torch.ops import broker_aggregates as agg_op
    from ccx_torch.optimizer import optimize
    from ccx_torch.search import annealer, repair
    from ccx_torch.search import incremental as inc

    dev = resolve_device(args.device)
    kind = {"kind": dev.type}
    if dev.type == "cuda":
        kind = {"kind": torch.cuda.get_device_name(dev), "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()}
    cfg = GoalConfig()
    goal_names, opts, _ = rungs.build_opts(args.config, "target")
    hard = [n for n in goal_names if GOAL_REGISTRY[n].hard]

    def hard_of(stack) -> dict:
        by = stack.by_name()
        return {n: by[n][0] for n in hard if by[n][0]}

    stages: dict = {}
    real_repair, real_anneal = repair.hard_repair, annealer.anneal

    def traced_repair(m, *a, **k):
        out = real_repair(m, *a, **k)
        stages["repair"] = hard_of(evaluate_stack(out[0], cfg, goal_names))
        return out

    def traced_anneal(m, *a, **k):
        res = real_anneal(m, *a, **k)
        stages["anneal"] = hard_of(res.stack_after)
        if args.heal and float(res.stack_after.hard_violations) > 0:
            stages["heal"] = heal(res.model)
        return res

    def heal(annealed) -> dict:
        from ccx_torch.search.greedy import SwapPolishOptions, greedy_optimize, swap_polish

        iopts = rungs.steady_options()
        ksw = max(iopts.warm_swap_candidates // 2, 1)
        out: dict = {"swap": [], "polish": [], "leader": []}
        for seed in range(args.heal):
            spo = SwapPolishOptions(
                n_swap_candidates=ksw, n_lead_candidates=iopts.warm_swap_candidates - ksw,
                max_iters=iopts.warm_swap_iters, patience=iopts.warm_swap_patience,
                trd_guard=opts.swap_polish_guarded, chunk_iters=iopts.warm_swap_iters, seed=seed)
            out["swap"].append(float(swap_polish(annealed, cfg, goal_names, spo)
                                     .stack_after.hard_violations))
            for name, lead in (("polish", False), ("leader", True)):
                g = dataclasses.replace(opts.polish, max_iters=iopts.warm_swap_iters,
                                        patience=iopts.warm_swap_patience, seed=seed,
                                        leadership_only=lead)
                out[name].append(float(greedy_optimize(annealed, cfg, goal_names, g)
                                       .stack_after.hard_violations))
        return out

    m0 = random_cluster(bench_spec(args.config), device=dev)

    def cold_base():
        t = time.monotonic()
        cold = optimize(m0, cfg, goal_names, opts)
        print(json.dumps({"device": kind, "config": args.config,
                          "cold_seconds": time.monotonic() - t,
                          "cold_verified": cold.verification.ok}), flush=True)
        applied = m0.replace(assignment=cold.model.assignment,
                             leader_slot=cold.model.leader_slot,
                             replica_disk=cold.model.replica_disk)
        return applied, model_to_arrays(applied)

    applied, base = cold_base()
    warm_opts = dataclasses.replace(opts, incremental=rungs.steady_options())
    sopts = sc.ScenarioOptions(seed=args.seed, windows=args.windows)
    try:
        for family in args.family or ["hot-skew"]:
            for rep in range(args.repeats):
                if args.fresh_cold and rep:
                    applied, base = cold_base()
                repair.hard_repair, annealer.anneal = traced_repair, traced_anneal
                session = f"stages-{family}-{rep}"
                inc.STORE.drop(session)
                inc.remember(session, 1, applied, cfg)
                for gen, w in enumerate(sc.generate(family, base, sopts), 2):
                    snap = arrays_to_model(w.arrays, device=dev)
                    stages.clear()
                    stages["warm"] = hard_of(evaluate_stack(
                        inc.warm_model(snap, inc.STORE.get(session)), cfg, goal_names))
                    t = time.monotonic()
                    res = optimize(snap, cfg, goal_names, warm_opts,
                                   warm_start=inc.STORE.get(session))
                    wall = time.monotonic() - t
                    plain = evaluate_stack(res.model, cfg, goal_names,
                                           agg=agg_op.broker_aggregates_plain(res.model))
                    print(json.dumps({
                        "family": family, "repeat": rep, "window": w.label, "wall_s": wall,
                        "verified": res.verification.ok, "failures": res.verification.failures,
                        **stages, "final": hard_of(res.stack_after), "final_plain": hard_of(plain),
                        "incremental": {k: v for k, v in (res.incremental or {}).items()
                                        if k in ("warmStart", "structuralOffenders",
                                                 "driftPartitions", "reverted", "plateau",
                                                 "repairRetries")},
                        "phase_seconds": res.phase_seconds,
                    }, default=str), flush=True)
                    if res.verification.ok:
                        inc.remember(session, gen, res.model, cfg, pressure=res.warm_pressure)
                inc.STORE.drop(session)
                repair.hard_repair, annealer.anneal = real_repair, real_anneal
    finally:
        repair.hard_repair, annealer.anneal = real_repair, real_anneal


if __name__ == "__main__":
    main()
