"""The benchmark's command:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It serves the cell's traffic through the
system's own gRPC sidecar on the CUDA card, judges every answer against the
plain reference in ``perfbench/reference/`` and prints one JSON line last on
standard output; exit code 2 without a card (there is no CPU fallback).
Kernel and build caches live in ``.perfbench_cache/`` in the checkout.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def pin_caches() -> None:
    """Every kernel cache the system or torch may write, at fixed paths in
    the checkout, so that only a checkout's first run builds."""
    cache = ROOT / ".perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.enable()
    pin_caches()
    from perfbench import harness

    cell = harness.Cell.load(args.workload)
    device = harness.require_card(int(cell.workload["chips"]))
    code, line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    if line is not None:
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
