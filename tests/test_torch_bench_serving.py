"""The port's fleet, steady loop and wire split against the JAX bench's.

* The runs' options are the JAX bench's: the fleet's Propose keys are
  ``bench._fleet_options()``, the warm windows' ``bench._steady_options()``,
  and the entry point's defaults its environment twins' defaults.
* ``run_steady`` and ``run_wire`` on the CPU at a small size, from one cold
  Propose on one in-process gRPC sidecar, are verified, build no kernel in
  their measured loops and return every key of the JAX bench's
  ``STEADY_r01.json`` / ``WIRE_r01.json`` (nested blocks too).
* ``run_fleet`` at the same size, 3 jobs on its own sidecar, is verified,
  builds nothing, its urgent job finishes verified while the second wave
  runs, its line has every key of ``FLEET_r01.json``, and the fleet
  scheduler's settings are restored; unset, the dispatch width is the
  port's (1) and the residency cap the host's core count, as in JAX.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest
import torch

import bench
from ccx_torch.bench import runs, serving
from ccx_torch.rungs import fleet_wire_options, steady_wire_options, wire_options
from ccx_torch.search import incremental as tinc
from ccx_torch.search.scheduler import DEFAULT_DISPATCH_WIDTH, FLEET
from test_torch_scenarios import GOALS, WARM_WIRE, base_spec, small_opts

ROOT = Path(__file__).resolve().parents[1]


def _banked(name: str) -> dict:
    return json.loads((ROOT / name).read_text())


def _has_banked_keys(out: dict, banked: dict, path: str = "") -> None:
    """Every key of ``banked`` is in ``out``, and so on down every nested
    block the two share."""
    missing = set(banked) - set(out)
    assert not missing, (path, missing)
    for key, value in banked.items():
        if isinstance(value, dict) and isinstance(out[key], dict):
            _has_banked_keys(out[key], value, f"{path}.{key}")


@pytest.fixture(scope="module")
def served():
    s = runs.serve_cold("B3", "cpu", spec=base_spec(), goals=GOALS, opts=small_opts(),
                        warm_wire={**steady_wire_options(), **WARM_WIRE})
    yield s
    s.close()
    tinc.STORE.clear()


def test_run_options_are_the_jax_benchs():
    assert fleet_wire_options() == bench._fleet_options()
    assert steady_wire_options() == bench._steady_options()


def test_entry_point_defaults_are_the_jax_benchs(monkeypatch):
    from ccx_torch.bench.__main__ import main

    for var in ("CCX_BENCH_FLEET_JOBS", "CCX_BENCH_STEADY_ITERS", "CCX_BENCH_WIRE_ITERS"):
        monkeypatch.delenv(var, raising=False)
    seen = {}

    def stub(run):
        def call(name, n, **kw):
            seen[run] = (name, n, str(kw["device"]))
            return {"verified": True}
        return call

    for run in ("run_fleet", "run_steady", "run_wire"):
        monkeypatch.setattr(serving, run, stub(run))
    for flag in ("--fleet", "--steady", "--wire"):
        assert main([flag, "B3", "--device", "cpu"]) == 0
    assert seen == {"run_fleet": ("B3", 16, "cpu"), "run_steady": ("B3", 20, "cpu"),
                    "run_wire": ("B3", 20, "cpu")}
    monkeypatch.setenv("CCX_BENCH_WIRE_ITERS", "7")
    assert main(["--wire", "B5", "--device", "cpu"]) == 0
    assert seen["run_wire"] == ("B5", 7, "cpu")
    assert main(["--wire", "B5", "--iters", "3", "--device", "cpu"]) == 0
    assert seen["run_wire"] == ("B5", 3, "cpu")


def test_entry_point_needs_a_card(monkeypatch):
    from ccx_torch.bench.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in ("--fleet", "--steady", "--wire"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([flag, "B3"])


def test_run_steady_on_the_cpu_is_verified(served):
    out = serving.run_steady("B3", 4, served=served)
    assert out["verified"], {k: v for k, v in out.items() if k != "convergence"}
    _has_banked_keys(out, _banked("STEADY_r01.json"))
    assert out["backend"] == "cpu" and out["device"] == {"kind": "cpu"}
    assert out["n_iters"] == len(out["warm"]["walls"]) == 4
    assert out["all_warm_started"] and out["zero_warm_fresh_compiles"]
    assert out["compile_cache"]["measured"]["backend_compiles"] == 0
    # 2 + 4 metric-only deltas, each grafted onto the resident model after
    # the first one of the session
    assert out["registry"]["deltaGrafts"] >= 5
    assert out["incremental"]["warmStart"] and out["incremental"]["session"] == "steady-B3"
    assert tinc.STORE.get("steady-B3") is None  # the run dropped its base
    # on the CPU the wrapper takes the plain version and counts nothing
    assert out["launches"] == {"broker_aggregates": {"cold": 0, "prewarm": 0, "measured": 0}}


def test_run_wire_on_the_cpu_is_verified(served):
    out = serving.run_wire("B3", 4, served=served)
    assert out["verified"], out
    _has_banked_keys(out, _banked("WIRE_r01.json"))
    assert out["unit"] == "ms" and out["value"] == out["warm_ms"]["p50"]
    assert out["zero_warm_fresh_compiles"] and out["all_warm_started"]
    cold = out["cold"]
    assert cold["repeated"] and cold["rows"] == served.cold_res["numProposals"]
    assert cold["segments"] >= 1 and cold["snapshot_mb"] > 0
    # the split's legs are the parts of a window, and none is negative
    assert all(v >= 0 for v in out["split_ms"].values()), out["split_ms"]
    assert out["segments"] >= 1
    # the cold leg read off the served Propose instead of a repeat
    again = serving.run_wire("B3", 1, served=served, repeat_cold=False)
    assert again["verified"] and not again["cold"]["repeated"]
    assert again["cold"]["rtt_s"] == round(served.cold_s, 2)


def test_run_fleet_on_the_cpu_is_verified_and_restores_the_scheduler(monkeypatch):
    monkeypatch.delenv("CCX_FLEET_DISPATCH_WIDTH", raising=False)
    monkeypatch.delenv("CCX_FLEET_MAX_CONCURRENT", raising=False)
    before = FLEET.max_concurrent, FLEET.dispatch_width
    out = serving.run_fleet("B3", 3, device="cpu", options=wire_options(small_opts()),
                            spec=base_spec(), goals=GOALS)
    assert (FLEET.max_concurrent, FLEET.dispatch_width) == before
    assert out["verified"], out
    _has_banked_keys(out, _banked("FLEET_r01.json"))
    assert out["effort"]["dispatch_width"] == DEFAULT_DISPATCH_WIDTH == 1
    assert out["effort"]["max_concurrent"] == os.cpu_count()
    assert out["n_jobs"] == len(out["latency"]["walls"]) == 3 and out["shape_buckets"] == 1
    assert out["zero_warm_fresh_compiles"]
    assert all(c["backend_compiles"] == 0 for c in out["compile_cache"].values())
    # the preemption probe: the urgent job finished verified mid-wave, and
    # the wave it jumped finished too
    assert out["urgent"]["verified"] and out["urgent"]["wave_verified"]
    assert out["chunks_granted"] > 0 and 0 < out["occupancy"] <= 1
    assert out["launches"] == {"broker_aggregates": {
        "prewarm": 0, "serialized": 0, "concurrent": 0, "preempt": 0}}
    assert not any(tinc.STORE.get(f"fleet-{i}") for i in range(3))
