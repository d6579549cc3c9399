#!/usr/bin/env python3
"""Run a bench config at the lean rung through ``ccx_torch`` once per SA
seed, on the card or on the CPU, and print one JSON line per run: the device
(with ``nvidia-smi``'s name and power limit on a card), the seed, the wall,
``verified``, the hard violations and every goal's violations after. The
samples hold the card's lean quality against the CPU path's; the rung is
``ccx_torch.rungs.build_opts(config, "lean")`` with only the annealer's
seed changed.

``--host-draws`` makes every search of the run draw its random numbers from
a generator on the CPU and move them to the card, so a card run and a CPU
run of one seed share their random stream (the package itself always draws
on the model's device). ``--stages`` adds, per run, each pipeline stage's
result in call order (its placement's hash and violations), for finding
the first stage at which two runs part.

    python3 tools/torch_lean_samples.py --device cuda --seeds 43 44
    python3 tools/torch_lean_samples.py --device cuda --host-draws --stages --seeds 42
    python3 tools/torch_lean_samples.py --device cpu --stages --seeds 42
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def draw_on_the_host() -> None:
    """Make ``torch.Generator`` build CPU generators, and ``torch.rand`` /
    ``torch.randint`` with a CPU generator and another device draw on the
    CPU and copy the numbers there."""
    import torch

    gen, rand, randint = torch.Generator, torch.rand, torch.randint

    def host_generator(device=None):
        return gen(device="cpu")

    def elsewhere(generator, device) -> bool:
        return generator is not None and device is not None and torch.device(device) != generator.device

    def host_rand(*size, generator=None, device=None, **kw):
        if elsewhere(generator, device):
            return rand(*size, generator=generator, **kw).to(device)
        return rand(*size, generator=generator, device=device, **kw)

    def host_randint(*args, generator=None, device=None, **kw):
        if elsewhere(generator, device):
            return randint(*args, generator=generator, **kw).to(device)
        return randint(*args, generator=generator, device=device, **kw)

    torch.Generator, torch.rand, torch.randint = host_generator, host_rand, host_randint


def record_stages(log: list, goals, cfg) -> None:
    """Wrap the pipeline stages that ``ccx_torch.optimizer`` calls so that
    each call appends its result (stage name, placement hash, violations
    under ``goals``)."""
    from ccx_torch import optimizer
    from ccx_torch.goals.stack import evaluate_stack

    def model_of(out):
        if hasattr(out, "model"):
            return out.model
        return out[0]

    def entry(name, model) -> dict:
        h = hashlib.sha256()
        for t in (model.assignment, model.leader_slot, model.replica_disk):
            h.update(t.cpu().numpy().tobytes())
        stack = evaluate_stack(model, cfg, goals)
        return {"stage": name, "placement": h.hexdigest()[:16],
                "violations": [int(v) for v in stack.violations.tolist()]}

    def wrap(name):
        fn = getattr(optimizer, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            log.append(entry(name, model_of(out)))
            return out

        setattr(optimizer, name, wrapped)

    for name in ("hard_repair_counted", "anneal", "greedy_optimize", "topic_rebalance", "swap_polish",
                 "finalize_preferred_leaders"):
        wrap(name)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--config", default="B5")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--host-draws", action="store_true")
    ap.add_argument("--stages", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.model.fixtures import bench_spec, random_cluster
    from ccx_torch.optimizer import optimize
    from ccx_torch.rungs import build_opts

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("torch_lean_samples: no CUDA device is available")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    if args.host_draws:
        draw_on_the_host()
    goals, opts, _ = build_opts(args.config, "lean")
    stages: list = []
    if args.stages:
        record_stages(stages, goals, GoalConfig())
    m = random_cluster(bench_spec(args.config), device=args.device)
    for seed in args.seeds:
        stages.clear()
        run = dataclasses.replace(opts, anneal=dataclasses.replace(opts.anneal, seed=seed))
        res = optimize(m, goal_names=goals, opts=run)
        print(json.dumps({
            "lean": args.config, "device": args.device, "card": card, "seed": seed,
            "host_draws": args.host_draws,
            "wall_seconds": res.wall_seconds, "verified": res.verification.ok,
            "hard_violations": float(res.stack_after.hard_violations),
            "after": {n: int(v) for n, (v, _) in res.stack_after.by_name().items()},
            "phase_seconds": res.phase_seconds,
            **({"stages": list(stages)} if args.stages else {}),
        }), flush=True)


if __name__ == "__main__":
    main()
