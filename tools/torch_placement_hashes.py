"""Hashes of a cell's cold proposals, request by request, for holding one
checkout's placements against another's on the same card:

    python3 tools/torch_placement_hashes.py --workload b5-cold-target \\
        --seed 3800000011 --requests 3 [--root DIR]

Serves the cell's set-up and then its first ``--requests`` cold requests
through the port's sidecar, as ``perfbench`` does (the same snapshots for
the same seed), untimed and untraced. Prints one JSON line per request: a
sha256 of the columnar diff's arrays and one of the goal summary, the
request's wall, and the ``anneal`` span's ``engine``, ``subSteps``,
``syncs``, ``graphCaptures`` and ``graphReplays``. ``--root`` runs the
checkout at DIR (its ``ccx_torch`` and ``perfbench``), so the parent and the
change run in one process each on one card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path


def digest_arrays(arrays: dict) -> str:
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(arrays):
        v = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{v.dtype}:{v.shape};".encode())
        h.update(v.tobytes())
    return h.hexdigest()[:16]


def anneal_span(result: dict) -> dict:
    for c in (result.get("spanTree") or {}).get("children", ()):
        if c.get("name") == "anneal":
            a = c.get("attrs", {})
            return {"engine": a.get("engine"), "subSteps": a.get("subSteps"),
                    "syncs": (c.get("syncs") or {}).get("total", 0),
                    "graphCaptures": a.get("graphCaptures"),
                    "graphReplays": a.get("graphReplays")}
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    from perfbench import harness

    cell = harness.Cell.load(args.workload, root=root)
    device = harness.require_card(int(cell.workload["chips"]))
    run = harness.Run(cell, args.seed, device)
    drv = harness.driver(cell.traffic["driver"])
    run.start_sidecar()
    try:
        drv.setup(run)
        for i in range(args.requests):
            t0 = time.monotonic()
            r = drv.request(run, i)
            if r.error is not None:
                raise RuntimeError(f"request {i}: {r.error}")
            res = r.result
            goals = json.dumps(res["goalSummary"], sort_keys=True, default=str)
            print(json.dumps({
                "request": i, "wall_s": time.monotonic() - t0,
                "verified": bool(res.get("verified")),
                "diff": digest_arrays(res["proposalsColumnar"]),
                "goals": hashlib.sha256(goals.encode()).hexdigest()[:16],
                "anneal": anneal_span(res),
            }), flush=True)
    finally:
        run.stop_sidecar()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
