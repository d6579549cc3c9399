"""The readings the limits of ``correct`` are set from, on the card:

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 --requests <n>

For each seed, one process-local sidecar serves ``n`` requests of the cell's
traffic at the cell's own size (set-up as a run makes it), and every answer
is judged twice by the reference: as the system reported it, and as the
control (the reference in bfloat16 in the system's place) would have
reported the same proposal. One JSON line a seed: the worst reading of each
number over its requests, for the system and for the control. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json

from perfbench.run import pin_caches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    pin_caches()
    from perfbench import harness

    cell = harness.Cell.load(args.workload)
    device = harness.require_card(int(cell.workload["chips"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(calibrate(cell, seed, args.requests, device)), flush=True)
    return 0


def calibrate(cell, seed: int, n_requests: int, device) -> dict:
    """The worst reading of each number over ``n_requests`` requests of
    ``cell`` on ``seed``, for the system and for the control."""
    from perfbench import harness
    from perfbench.reference import compare

    run = harness.Run(cell, seed, device)
    drv = harness.driver(cell.traffic["driver"])
    try:
        run.start_sidecar()
        drv.setup(run)
        for i in range(n_requests):
            run.requests.append(drv.request(run, i))
    finally:
        run.stop_sidecar()
    system, control = [], []
    for r in run.requests:
        if r.result is None:
            continue
        system.append(compare.judge(r.snap, r.result, cell.config))
        control.append(compare.judge(r.snap, compare.control(r.snap, r.result, cell.config),
                                     cell.config))
    def worst(readings):
        return {k: v["value"] for k, v in compare.summarize(readings, cell.limits).items()}

    return {
        "seed": seed, "requests": len(run.requests),
        "errors": [r.error for r in run.requests if r.error],
        "system": worst(system), "control": worst(control),
        "walls": [r.wall_s for r in run.requests],
        "gaps_at": [x.get("violation_gap_at") for x in system],
        "phases": [(r.result or {}).get("phaseSeconds") for r in run.requests],
    }


if __name__ == "__main__":
    raise SystemExit(main())
