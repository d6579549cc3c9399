#!/usr/bin/env python3
"""Time the broker-aggregates kernel of a given checkout on one NVIDIA GPU,
on the fixtures of ``chip_smoke.py``'s kernel-time phase, so that two
designs are compared on one card in one call.

For each fixture (B5, 4000 brokers, B6) it prints one JSON line with
``chip_smoke.time_kernel`` of one ``broker_aggregates_cuda`` call of the
``ccx_torch`` package under ROOT: ``device_ms`` (every device op of a call,
from torch.profiler, each named in ``device_ops``), ``call_ms`` (CUDA events
around back-to-back calls) and ``host_us`` (host enqueue time per call),
beside the byte bound. The card's ``nvidia-smi`` name and power limit come
first. An earlier commit is unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, and the two are timed in turns:

    python3 tools/time_torch_aggregates.py _archive/parent
    python3 tools/time_torch_aggregates.py .
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path, help="checkout whose ccx_torch is timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_torch_aggregates: no CUDA device is available")
    # chip_smoke and the bound's reckoning (the cost model, standard
    # library at import) from this checkout, ccx_torch from the timed one
    sys.path.insert(0, str(REPO))
    from chip_smoke import TIME_FIXTURES, fixture_spec, time_kernel

    spec = importlib.util.spec_from_file_location(
        "_costmodel", REPO / "ccx_torch" / "common" / "costmodel.py")
    costmodel = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(costmodel)
    sys.path.insert(0, str(args.root.resolve()))
    from ccx_torch.model import fixtures
    from ccx_torch.ops import broker_aggregates as agg_op

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "root": str(args.root),
                      "ccx_torch": agg_op.__file__}), flush=True)
    agg_op.build()
    dev = torch.device("cuda", 0)
    for name in TIME_FIXTURES:
        m = fixtures.random_cluster(fixture_spec(name, fixtures), device=dev)
        print(json.dumps({"fixture": name, "P": m.P, "B": m.B, "T": m.num_topics,
                          "D": m.D, **time_kernel(agg_op, m, costmodel=costmodel)}), flush=True)
        del m


if __name__ == "__main__":
    main()
