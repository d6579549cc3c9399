"""ccx-propose — one-shot proposal computation from a snapshot file.

``python -m ccx_torch.sidecar.cli --snapshot cluster.json`` runs the port's
optimizer in this process, on the CUDA device (``--device cpu`` for the
host); ``--address host:port`` sends it to a running sidecar instead.
Snapshot files are ``ccx_torch.model.snapshot.to_json`` (the JAX package's
format).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ccx-propose", description=__doc__)
    ap.add_argument("--snapshot", required=True,
                    help="cluster snapshot (.json per ccx_torch/model/snapshot.py)")
    ap.add_argument("--address", help="sidecar host:port (default: in-process)")
    ap.add_argument("--device", default=None,
                    help="in-process only: torch device (default: the CUDA device)")
    ap.add_argument("--goals", default="", help="comma-separated goal names")
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    from ccx_torch.model.snapshot import from_json

    with open(args.snapshot, encoding="utf-8") as f:
        text = f.read()
    goals = tuple(g.strip() for g in args.goals.split(",") if g.strip())

    if args.address:
        from ccx_torch.sidecar.client import SidecarClient

        with SidecarClient(args.address) as client:
            out = client.propose(
                from_json(text, device="cpu"), goals=goals, chains=args.chains,
                steps=args.steps, seed=args.seed,
                on_progress=lambda s: print(f"[progress] {s}", file=sys.stderr),
            )
    else:
        from ccx_torch.goals.base import GoalConfig
        from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
        from ccx_torch.optimizer import OptimizeOptions, optimize
        from ccx_torch.search.annealer import AnnealOptions

        names = goals or DEFAULT_GOAL_ORDER
        if "StructuralFeasibility" not in names:
            names = ("StructuralFeasibility",) + tuple(names)
        res = optimize(
            from_json(text, device=args.device), GoalConfig(), names,
            OptimizeOptions(anneal=AnnealOptions(
                n_chains=args.chains, n_steps=args.steps, seed=args.seed)),
        )
        out = res.to_json()
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
