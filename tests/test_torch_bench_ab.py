"""The port's movement-plan A/B and replica-exchange A/B against the JAX
bench's.

* The runs' knobs are the JAX bench's: the defaults of its ``CCX_PLAN_*``
  and ``CCX_EXCHANGE_*`` environment twins, read from ``bench.py``'s
  source, and the entry point's ``--evac`` / ``--evac-windows`` defaults.
* On one seeded diff, the cold A/B's planned (device loop) and naive
  makespans and peak inflows equal ``ccx.search.movement``'s on the same
  columns and bytes, and the device loop equals the oracle.
* ``run_plan`` on the CPU at a small size is verified, builds no kernel in
  its re-plan loop and returns every key of ``PLAN_r01.json``'s ``parsed``
  block; the loop's cap is honoured and recorded.
* ``run_exchange_ab`` at a small size is verified: its K=1 probe is
  bit-exact and the retune builds nothing; its gate equals the JAX
  package's convergence helpers on the same series; its line has every key
  of ``EXCHANGE_r01.json``'s ``parsed`` block.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ccx.common.convergence import lex_improved as jax_lex_improved
from ccx.common.convergence import plateau_chunk as jax_plateau_chunk
from ccx.search import movement as jmv
from ccx_torch.bench import ab
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.movement import PlanOptions
from test_torch_bench_serving import _has_banked_keys
from test_torch_scenarios import GOALS, base_spec, small_opts

ROOT = Path(__file__).resolve().parents[1]
#: the small exchange A/B: the JAX run's 16 chains, 4 rungs and 2 moves a
#: step, its 1200 steps in chunks of 40 cut to 240 in chunks of 20 (12
#: chunks, as its 30)
EXCHANGE_SMALL = AnnealOptions(n_chains=16, n_steps=240, moves_per_step=2, seed=17,
                               chunk_steps=20)


def _bench_env_defaults(prefix: str) -> dict:
    """``{VAR: default}`` of every ``os.environ.get("CCX_<prefix>_...",
    "<default>")`` in ``bench.py``."""
    src = (ROOT / "bench.py").read_text()
    return dict(re.findall(rf'os\.environ\.get\(\s*"(CCX_{prefix}_\w+)",\s*"([^"]*)"', src))


def test_knobs_are_the_jax_benchs(monkeypatch):
    for var in list(_bench_env_defaults("PLAN")) + list(_bench_env_defaults("EXCHANGE")):
        monkeypatch.delenv(var, raising=False)
    plan = _bench_env_defaults("PLAN")
    assert ab.plan_knobs() == {
        "cap": int(plan["CCX_PLAN_CAP"]), "max_waves": int(plan["CCX_PLAN_MAX_WAVES"]),
        "wave_mb": float(plan["CCX_PLAN_WAVE_BYTES_MB"]),
        "throttle": float(plan["CCX_PLAN_THROTTLE_MBPS"]), "seed": int(plan["CCX_PLAN_SEED"]),
    }
    ex = _bench_env_defaults("EXCHANGE")
    assert ab.exchange_knobs() == {
        "n_temps": int(ex["CCX_EXCHANGE_TEMPS"]), "chains": int(ex["CCX_EXCHANGE_CHAINS"]),
        "steps": int(ex["CCX_EXCHANGE_STEPS"]), "chunk": int(ex["CCX_EXCHANGE_CHUNK"]),
        "interval": int(ex["CCX_EXCHANGE_INTERVAL"]), "seed": int(ex["CCX_EXCHANGE_SEED"]),
    }
    assert ab.EXCHANGE_MOVES == 2
    monkeypatch.setenv("CCX_PLAN_MAX_WAVES", "8")
    monkeypatch.setenv("CCX_EXCHANGE_TEMPS", "2")
    assert ab.plan_knobs()["max_waves"] == 8 and ab.exchange_knobs()["n_temps"] == 2


def test_entry_point_defaults_are_the_jax_benchs(monkeypatch):
    from ccx_torch.bench.__main__ import main

    monkeypatch.delenv("CCX_PLAN_EVAC_BENCH", raising=False)
    monkeypatch.delenv("CCX_PLAN_EVAC_WINDOWS", raising=False)
    seen = {}

    def plan(name, evac, windows, **kw):
        seen["plan"] = (name, evac, windows, kw["replan_iters"])
        return {"verified": True}

    def exchange(name, **kw):
        seen["exchange"] = name
        return {"verified": False}

    monkeypatch.setattr(ab, "run_plan", plan)
    monkeypatch.setattr(ab, "run_exchange_ab", exchange)
    assert main(["--plan", "B5", "--device", "cpu"]) == 0
    assert seen["plan"] == ("B5", "B3", 4, None)
    assert main(["--plan", "B5", "--evac", "B4", "--evac-windows", "2", "--replan-iters", "3",
                 "--device", "cpu"]) == 0
    assert seen["plan"] == ("B5", "B4", 2, 3)
    # an unverified run exits non-zero
    assert main(["--exchange-ab", "B3", "--device", "cpu"]) == 1
    assert seen["exchange"] == "B3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in ("--plan", "--exchange-ab"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([flag, "B3"])


def _seeded_diff(n: int = 300, B: int = 24, R: int = 3, seed: int = 5):
    rng = np.random.default_rng(seed)
    old = np.stack([rng.choice(B, R, replace=False) for _ in range(n)]).astype(np.int32)
    new = old.copy()
    new[np.arange(n), rng.integers(0, R, n)] = rng.integers(0, B, n)
    new[::7, 2] = -1  # a few rows that shrink
    cols = {"partition": np.arange(n, dtype=np.int32), "oldReplicas": old, "newReplicas": new}
    return cols, rng.uniform(1.0, 500.0, n).astype(np.float32), B


def test_cold_ab_equals_the_jax_planner_on_a_seeded_diff():
    cols, bytes_pp, B = _seeded_diff()
    popts = PlanOptions(broker_cap=5, max_waves=16, backend="device")
    plan, match, line = ab.plan_ab(cols, bytes_pp, B, popts, device="cpu")
    assert match and line["oracle_match"] and plan.backend == "device"
    theirs = jmv.plan_movement(cols, bytes_pp, B,
                               jmv.PlanOptions(broker_cap=5, max_waves=16, backend="numpy"))
    naive = jmv.naive_schedule(cols, bytes_pp, B, cap=5)
    np.testing.assert_array_equal(plan.wave, theirs.wave)
    assert line["planned"]["makespanSeconds"] == round(theirs.makespan_seconds, 3)
    assert line["planned"]["peakInflowMb"] == round(theirs.peak_inflow, 3)
    assert line["naive"] == {"rounds": naive["rounds"],
                             "makespanSeconds": round(naive["makespanSeconds"], 3),
                             "peakInflowMb": round(naive["peakInflowMb"], 3),
                             "nMoves": naive["nMoves"]}
    assert line["planned_better"] == (
        theirs.makespan_seconds <= naive["makespanSeconds"] + ab.PLAN_EPS
        and theirs.peak_inflow <= naive["peakInflowMb"] + ab.PLAN_EPS)


def test_run_plan_on_the_cpu_is_verified():
    out = ab.run_plan("B3", "B3", 2, device="cpu", spec=base_spec(), evac_spec=base_spec(),
                      goals=GOALS, opts=small_opts())
    assert out["verified"], {k: v for k, v in out.items() if k != "evacuation"}
    banked = json.loads((ROOT / "PLAN_r01.json").read_text())["parsed"]
    _has_banked_keys(out, banked)
    assert set(banked["evacuation"]["windows"][0]) <= set(out["evacuation"]["windows"][0])
    assert out["backend"] == "cpu" and out["oracle_match"] and out["planned_better"]
    assert out["cold_ab"]["planned"]["backend"] == "device"
    replan = out["replan"]
    assert replan["fresh_compiles"] == out["fresh_compiles_in_replan"] == 0
    assert replan["prewarm_iters"] == 0 and replan["limit"] == 2 * out["max_waves"]
    # the loop ran until one wave was left, each plan on the size rule's
    # backend (this diff is below DEVICE_PLAN_MIN_ROWS)
    assert replan["done"] and replan["iters"] == len(replan["plan_walls_s"]) > 0
    assert set(replan["backends"]) <= {"numpy", "empty"}
    assert replan["rows"] == sorted(replan["rows"], reverse=True)
    assert out["evacuation"]["verified"] and out["evacuation"]["move_windows"] >= 1
    assert out["launches"]["broker_aggregates"] == {
        "cold": 0, "cost_tier": 0, "replan": 0, "evacuation": 0}
    assert not out["cold_ab"]["shipped_plan_held"]  # the shipped plan was the oracle's


def test_run_plan_holds_a_shipped_device_plan_and_honours_the_cap(monkeypatch):
    # the device loop forced for every plan: the optimize's shipped plan is
    # then the device plan of the cold diff, held as the A/B's
    monkeypatch.setenv("CCX_DEVICE_PLAN", "1")
    out = ab.run_plan("B3", "B3", 1, device="cpu", spec=base_spec(), evac_spec=base_spec(),
                      goals=GOALS, opts=small_opts(), replan_iters=2)
    assert out["cold_ab"]["shipped_plan_held"] and out["cold_ab"]["oracle_match"]
    assert out["cold_ab"]["planned"] == {k: out["shipped_plan"][k] for k in out["cold_ab"]["planned"]}
    assert out["replan"]["iters"] == 2 and not out["replan"]["done"]
    assert out["replan"]["limit"] == 2 and set(out["replan"]["backends"]) == {"device"}
    assert out["verified"]


def test_run_exchange_ab_on_the_cpu_is_verified():
    out = ab.run_exchange_ab("B3", device="cpu", spec=base_spec(), goals=GOALS,
                             anneal_opts=EXCHANGE_SMALL)
    assert (out["n_temps"], out["interval"]) == (4, 1)
    assert out["k1_bitexact"], out["k1"]
    assert out["fresh_compiles_on_retune"] == 0
    assert out["verified"], {k: v for k, v in out.items() if k != "convergence"}
    banked = json.loads((ROOT / "EXCHANGE_r01.json").read_text())["parsed"]
    _has_banked_keys(out, banked)
    ladder, flat = out["ladder"], out["flat"]
    assert ladder["exchange_attempted"] > 0 and flat["chunks"] == ladder["chunks"] == 12
    assert out["k1"]["first_differing_chunk"] is None
    # the gate, recomputed with the JAX package's helpers on the same data
    series = out["convergence"]["phases"]["anneal"][0]["series"]
    assert ladder["plateau_chunk"] == jax_plateau_chunk(series)
    reached = ladder["reached_flat_plateau_chunk"]
    assert out["ladder_better"] == (
        (reached is not None and reached < flat["plateau_chunk"])
        or jax_lex_improved(ladder["final"], flat["final"]))
    assert out["launches"] == {"broker_aggregates": {"flat": 0, "ladder": 0, "k1": 0,
                                                     "retune": 0}}
