"""The port's steady-state fleet against the JAX bench's.

* ``rungs.fleet_wire_options()`` is the JAX bench's ``_fleet_options()``.
* ``run_steady_fleet`` on the CPU at a small size, 3 clusters x 3 windows
  through one in-process gRPC sidecar, is verified, its line has every key
  of the JAX bench's ``STEADYFLEET_r01.json``, and the fleet scheduler's
  settings are the same after the run as before it, also when the run's
  environment twins changed them.
* Unset, the dispatch width is the port's (1), not the JAX package's core
  count.
"""

from __future__ import annotations

import json
from pathlib import Path

import bench
from ccx_torch.bench import runs
from ccx_torch.rungs import fleet_wire_options, steady_wire_options, wire_options
from ccx_torch.search import incremental as tinc
from ccx_torch.search.scheduler import DEFAULT_DISPATCH_WIDTH, FLEET
from test_torch_scenarios import GOALS, WARM_WIRE, base_spec, small_opts

ROOT = Path(__file__).resolve().parents[1]


def test_fleet_wire_options_are_the_jax_benchs():
    assert fleet_wire_options() == bench._fleet_options()


def _small_fleet(n_clusters: int = 3, n_windows: int = 3) -> dict:
    return runs.run_steady_fleet("B3", n_clusters, n_windows, device="cpu",
                                 cold_opts=wire_options(small_opts()), spec=base_spec(),
                                 goals=GOALS, warm_wire={**steady_wire_options(), **WARM_WIRE})


def test_run_steady_fleet_on_the_cpu_is_verified_and_restores_the_scheduler(monkeypatch):
    monkeypatch.setenv("CCX_FLEET_MAX_CONCURRENT", "2")
    monkeypatch.setenv("CCX_FLEET_DISPATCH_WIDTH", "3")
    # the warm store is process-wide: drop what earlier test files banked
    # in this process, so the session counts below are this run's
    tinc.STORE.clear()
    before = FLEET.max_concurrent, FLEET.dispatch_width
    out = _small_fleet()
    assert (FLEET.max_concurrent, FLEET.dispatch_width) == before
    assert out["effort"]["max_concurrent"] == 2 and out["effort"]["dispatch_width"] == 3
    assert out["verified"], {k: v for k, v in out.items() if k not in ("warm", "effort")}
    banked = json.loads((ROOT / "STEADYFLEET_r01.json").read_text())
    assert set(banked) <= set(out)
    for key in ("devmem", "warm", "single_warm", "effort"):
        assert set(banked[key]) <= set(out[key]), key
    assert out["backend"] == "cpu" and out["device"] == {"kind": "cpu"}
    assert (out["n_clusters"], out["n_windows"], out["shape_buckets"]) == (3, 3, 1)
    assert len(out["warm"]["walls"]) == 9 and len(out["single_warm"]["walls"]) == 3
    assert out["devmem"]["samples"] == 9 and out["devmem"]["budget_respected"]
    assert out["all_warm_started"] and out["zero_warm_fresh_compiles"]
    # every cluster's session and warm base were live during the run, and
    # the run dropped its warm bases at the end
    assert out["registry"]["sessions"] == out["store"]["sessions"] == 3
    assert not any(tinc.STORE.get(f"sfleet-{i}") for i in range(3))
    # on the CPU the wrapper takes the plain version and counts nothing
    assert out["launches"] == {"broker_aggregates": {
        "cold": 0, "prewarm": 0, "single": 0, "measured": 0}}


def test_unset_dispatch_width_is_the_ports(monkeypatch):
    monkeypatch.delenv("CCX_FLEET_DISPATCH_WIDTH", raising=False)
    monkeypatch.delenv("CCX_FLEET_MAX_CONCURRENT", raising=False)
    out = _small_fleet(2, 2)
    assert out["effort"]["dispatch_width"] == DEFAULT_DISPATCH_WIDTH == 1
    assert out["effort"]["max_concurrent"] == 0
    assert out["verified"]
