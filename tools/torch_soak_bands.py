#!/usr/bin/env python3
"""Run the closed-loop soak (``ccx_torch.bench.runs.run_soak``) at B3 as
``chip_smoke.py``'s ``soak`` phase runs it (2 clusters x 36 ticks, seed 1729,
a cold Propose of its own at ``chip_smoke.soak_options()``), on the card or on
the CPU, and print one JSON line per run: the device (with ``nvidia-smi``'s
name and power limit on a card), the gates, the episodes and, per served
window of the horizon, the banked pressure stack's mean, the adaptive
baseline it was read against, the band the detector saw, the violations
and the wall. The lines show why an episode stayed open: a pressure band at
or above the detector's 0.85 keeps a window violating.

``--host-draws`` makes every search draw its random numbers on the CPU and
copy them to the card (``tools/torch_lean_samples.py``), so a card run and
a CPU run share their random stream.

    python3 tools/torch_soak_bands.py --device cuda [--host-draws] [--repeats 2]
    python3 tools/torch_soak_bands.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--host-draws", action="store_true")
    ap.add_argument("--ticks", type=int, default=36)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(REPO), str(REPO / "tools")]
    import torch

    import chip_smoke
    from ccx_torch.bench import runs

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("torch_soak_bands: no CUDA device is available")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    if args.host_draws:
        from torch_lean_samples import draw_on_the_host

        draw_on_the_host()

    bands: list = []
    read = runs._SoakCluster.pressure_band

    def recorded(self):
        entry = runs.incr.STORE.get(self.sess)
        raw = None
        if entry is not None and entry.pressure is not None:
            raw = abs(float(entry.pressure.float().mean()))
        p0 = self._p0
        band = read(self)
        bands.append({"raw": raw, "p0": p0, "band": band})
        return band

    runs._SoakCluster.pressure_band = recorded
    _, opts = chip_smoke.soak_options()
    for repeat in range(args.repeats):
        bands.clear()
        served = runs.serve_cold("B3", args.device, opts=opts)
        try:
            line = runs.run_soak("B3", chip_smoke.SOAK_CLUSTERS, args.ticks,
                                 chip_smoke.SOAK_SEED, served=served)
        finally:
            served.close()
        windows = [
            {"tick": w["tick"], "cluster": w["cluster"], **b, "violations": w["violations"],
             "wall_s": w["wall_s"], "launches": w["launches"], "warm": w["warm"],
             "cold_fallback": w["cold_fallback"], "healed_by": w.get("healed_by")}
            for w, b in zip(line["window_detail"], bands)
        ]
        print(json.dumps({
            "soak": "B3", "device": args.device, "card": card, "host_draws": args.host_draws,
            "repeat": repeat, "ticks": args.ticks, "cold_s": line["cold_s"],
            "gates": line["gates"], "tths": line["healing"]["tths"],
            "episodes": line["episodes"], "heals": line["healing"]["heals"],
            "windows": windows,
        }), flush=True)


if __name__ == "__main__":
    main()
