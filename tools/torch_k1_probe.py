#!/usr/bin/env python3
"""Find where two runs of one seeded SA part on the card: the exchange A/B's
K=1 probe (``ccx_torch.bench.ab.run_exchange_ab``) at chip_smoke's budget.

On config ``--config``'s fixture after ``hard_repair`` (B5: the smoke's
``exchange-ab`` phase), prints one JSON line per check:

1. ``kernel``: the aggregates kernel called ``--repeats`` times on one model;
   for each float field, how many cells differ bitwise from the first call
   and by how much (the float sums are atomics in a run-dependent order);
2. ``anneal``: the flat arm (the target rung's SA, chunks of 25, ``--steps``
   steps) and the same at exchange interval 3, placements compared, and the
   first chunk whose tap row differs;
3. ``anneal-memo``: the same two runs with the kernel's result memoized per
   placement, so both runs read the same aggregates bits wherever they ask
   for the same placement's: if they then agree, the kernel's summation
   order is what parted them.

    python3 tools/torch_k1_probe.py [--config B5] [--steps 250] [--repeats 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FLOATS = ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="B5")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.model.fixtures import bench_spec, random_cluster
    from ccx_torch.ops import broker_aggregates as agg_op
    from ccx_torch.rungs import build_opts
    from ccx_torch.search import telemetry
    from ccx_torch.search.annealer import anneal
    from ccx_torch.search.repair import hard_repair

    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = GoalConfig()
    goal_names, opts, _ = build_opts(args.config, "target")
    repaired, _ = hard_repair(random_cluster(bench_spec(args.config), device=dev), cfg, goal_names)
    torch.cuda.synchronize()

    first = agg_op.broker_aggregates_cuda(repaired)
    differ = {f: 0 for f in FLOATS}
    max_diff = {f: 0.0 for f in FLOATS}
    for _ in range(args.repeats - 1):
        again = agg_op.broker_aggregates_cuda(repaired)
        for f in FLOATS:
            a, b = getattr(first, f), getattr(again, f)
            differ[f] = max(differ[f], int((a != b).sum()))
            max_diff[f] = max(max_diff[f], float((a - b).abs().max()))
    print(json.dumps({"check": "kernel", "config": args.config, "device": smi,
                      "calls": args.repeats, "cells": {f: getattr(first, f).numel() for f in FLOATS},
                      "cells_differing": differ, "max_abs_diff": max_diff}), flush=True)

    flat = dataclasses.replace(opts.anneal, chunk_steps=25, n_steps=args.steps, n_temps=1)
    k1 = dataclasses.replace(flat, exchange_interval=3)

    def pair(check: str) -> None:
        with telemetry.taps(True):
            a = anneal(repaired, cfg, goal_names, flat)
            b = anneal(repaired, cfg, goal_names, k1)
        sa = (a.convergence or {}).get("series") or []
        sb = (b.convergence or {}).get("series") or []
        print(json.dumps({
            "check": check, "steps": args.steps,
            "placement_equal": bool(torch.equal(a.model.assignment, b.model.assignment)
                                    and torch.equal(a.model.leader_slot, b.model.leader_slot)),
            "first_differing_chunk": next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y),
                                          None),
            "costs": [a.stack_after.costs.tolist()[:10], b.stack_after.costs.tolist()[:10]],
        }), flush=True)

    pair("anneal")
    memo: list = []
    kernel = agg_op.broker_aggregates_cuda

    def memoized(m, rows="auto"):
        for key, out in memo:
            if all(torch.equal(getattr(m, f), k) for f, k in zip(
                    ("assignment", "leader_slot", "replica_disk", "leader_load"), key)):
                return out
        out = kernel(m, rows)
        memo.append(((m.assignment.clone(), m.leader_slot.clone(), m.replica_disk.clone(),
                      m.leader_load.clone()), out))
        return out

    agg_op.broker_aggregates_cuda = memoized
    try:
        pair("anneal-memo")
    finally:
        agg_op.broker_aggregates_cuda = kernel


if __name__ == "__main__":
    main()
