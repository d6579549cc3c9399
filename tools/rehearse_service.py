#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s service phase on the CPU, at a cut budget.

    python3 tools/rehearse_service.py [--brokers 1000] [--partitions 100000]

Runs ``chip_smoke.service_phase`` on the CPU over a random cluster of the
given size (B5's brokers and partitions by default, 20 racks, 500 topics),
with the target rung's search cut to 4 chains x 20 SA steps, polish 20 and
leader pass 10 (on the façade's config keys and on the rung they are
checked against alike) and the demo execution to 4 x 30 steps, and prints
the phase's JSON line. It checks the phase's control flow before a chip
run; its seconds are the host's and say nothing of the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import B5Sampler  # noqa: E402,F401  (the config's __main__.B5Sampler)
from ccx_torch import rungs  # noqa: E402
from ccx_torch.model.fixtures import RandomClusterSpec  # noqa: E402
from ccx_torch.ops import broker_aggregates as agg_op  # noqa: E402

CUT_KEYS = {"optimizer.num.chains": 4, "optimizer.num.steps": 20, "optimizer.chunk.steps": 20,
            "optimizer.polish.max.iters": 20, "optimizer.leader.pass.max.iters": 10}
CUT_DEMO = {"optimizer.num.chains": 4, "optimizer.num.steps": 30}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--brokers", type=int, default=1000)
    ap.add_argument("--partitions", type=int, default=100_000)
    args = ap.parse_args()
    chip_smoke.SERVICE_TARGET_KEYS.update(CUT_KEYS)
    chip_smoke.DEMO_KEYS.update(CUT_DEMO)
    build_opts = rungs.build_opts

    def cut(name, rung):
        goals, opts, effort = build_opts(name, rung)
        return goals, dataclasses.replace(
            opts, anneal=dataclasses.replace(opts.anneal, n_chains=4, n_steps=20, chunk_steps=20),
            polish=dataclasses.replace(opts.polish, max_iters=20), leader_pass_max_iters=10,
        ), effort

    rungs.build_opts = cut
    chip_smoke.LOG.parent.mkdir(exist_ok=True)
    spec = RandomClusterSpec(n_brokers=args.brokers, n_racks=20, n_topics=500,
                             n_partitions=args.partitions, skew=0.3, seed=5)
    print(json.dumps(chip_smoke.service_phase(torch.device("cpu"), agg_op, "rehearsal",
                                              spec, 0.0)))


if __name__ == "__main__":
    main()
