"""The port's closed-loop soak against the JAX bench's.

* ``SOAK_INJECTIONS`` is the JAX bench's, and ``soak_schedule`` gives the
  plan that ``bench.run_soak``'s own schedule expression gives (taken from
  its source), case by case, at the JAX defaults and at the smoke's 36
  ticks.
* The port's ``StreamDetector``, fed one recorded signal stream (clean
  windows, a dead broker for two windows, a cold fallback, clean again),
  takes the JAX package's decisions: the same per-window verdicts, healer
  calls, episodes, metrics and SLO compliance.
* ``run_soak`` on the CPU through an in-process gRPC sidecar at a small
  size, 2 clusters and ticks enough for one injection of each kind: every
  gate but the fleet-minutes one holds, each injection opened one episode
  that fired and recovered, the line has every key of the JAX bench's
  ``SOAK_r01.json``, and the run leaves no fault armed and no warm base of
  its clusters behind.
* ``python -m ccx_torch.bench --soak`` and ``--steady-fleet`` refuse to run
  without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import inspect
import json
import re
import types
from pathlib import Path

import pytest
import torch

import bench
from ccx.config import CruiseControlConfig as JaxConfig
from ccx.detector.stream import FAMILY_VERB as JAX_FAMILY_VERB
from ccx.detector.stream import StreamDetector as JaxStreamDetector
from ccx_torch.bench import runs
from ccx_torch.common.faults import FAULTS
from ccx_torch.config import CruiseControlConfig
from ccx_torch.detector.stream import FAMILY_VERB, StreamDetector
from ccx_torch.search import incremental as tinc
from test_torch_scenarios import GOALS, WARM_WIRE, base_spec, small_opts

ROOT = Path(__file__).resolve().parents[1]
#: the soak's detector settings (``bench.run_soak``'s config, priced budget)
SOAK_PROPS = {"observability.slo.latency.budget.seconds": 60.0,
              "observability.slo.dwell.target": 0.85, "detector.stream.seed": 1729}


def _jax_schedule(n_ticks, n_clusters, inject_start, inject_every, inject_dur,
                  clean_windows) -> dict:
    """The schedule that ``bench.run_soak``'s own lines compute, run on the
    given knobs (the expression is taken from its source, from ``tail =``
    to the end of the ``schedule`` dict)."""
    src = inspect.getsource(bench.run_soak)
    block = re.search(r"\n( *)tail = .*?\n\1}\n", src, re.S)
    assert block, "bench.run_soak no longer computes its schedule inline"
    ns = {"SOAK_INJECTIONS": bench.SOAK_INJECTIONS, "n_ticks": n_ticks,
          "n_clusters": n_clusters, "inject_start": inject_start,
          "inject_every": inject_every, "inject_dur": inject_dur,
          "det": types.SimpleNamespace(clean_windows=clean_windows)}
    exec(inspect.cleandoc(block.group(0)), {}, ns)
    return ns["schedule"]


def test_soak_injections_are_the_jax_benchs():
    assert runs.SOAK_INJECTIONS == bench.SOAK_INJECTIONS
    assert FAMILY_VERB == JAX_FAMILY_VERB


def test_detectors_read_the_same_clean_streak_from_the_soaks_config():
    ours = StreamDetector(CruiseControlConfig(SOAK_PROPS)).clean_windows
    assert ours == JaxStreamDetector(JaxConfig(SOAK_PROPS)).clean_windows == 3


@pytest.mark.parametrize("n_ticks,n_clusters,inject_start,inject_every", [
    (96, 2, 10, 12),   # the JAX defaults
    (36, 2, 10, 12),   # the smoke's cut
    (29, 2, 10, 12),   # the shortest horizon with one injection of each kind
    (28, 2, 10, 12),   # one tick short: the bank kill has no room
    (96, 3, 10, 12),
    (96, 1, 4, 5),
    (13, 2, 2, 4),
    (5, 2, 10, 12),    # no injection fits
])
def test_soak_schedule_is_the_jax_benchs(n_ticks, n_clusters, inject_start, inject_every):
    want = _jax_schedule(n_ticks, n_clusters, inject_start, inject_every, runs.SOAK_INJECT_DUR, 3)
    got = runs.soak_schedule(n_ticks, n_clusters, inject_start, inject_every,
                             runs.SOAK_INJECT_DUR, 3)
    assert got == want


def test_smoke_schedule_places_one_injection_of_each_kind():
    sched = runs.soak_schedule(36, 2, 10, 12, runs.SOAK_INJECT_DUR, 3)
    assert {t: (inj[0], c) for t, (inj, c) in sched.items()} == {
        10: ("broker-kill", 0), 22: ("bank-kill", 1)}


def _recorded_stream() -> list:
    """(cluster, t_s, signals, injected) per window: clean windows, a broker
    dead for two windows on c0, then a cold fallback on c1 (a lost bank),
    then clean windows until both recover; the pressure band wobbles in
    its regime, so the forecaster fits but never fires."""
    out = []
    for tick in range(14):
        t_s = tick * 10.0
        for c in ("c0", "c1"):
            sig = {"warm": True, "verified": True, "wall_s": 0.05 + 0.001 * tick,
                   "cold_fallback": False, "dead_brokers": (),
                   "devmem_within_budget": True, "fault": None,
                   "pressure": round(0.5 + 0.002 * (tick % 3), 4)}
            injected = False
            if c == "c0" and tick in (3, 4):
                sig["dead_brokers"] = (7,)
                injected = tick == 3
            if c == "c1" and tick == 7:
                injected = True  # the bank is killed in this window
            if c == "c1" and tick == 8:
                sig.update(warm=False, cold_fallback=True, wall_s=2.5)
            out.append((c, t_s, sig, injected))
    return out


def _drive(det_cls, cfg_cls) -> dict:
    calls, prewarms = [], []

    def healer(cluster, family, cause):
        calls.append((cluster, family, cause))
        return FAMILY_VERB.get(family, "rebalance")

    def prewarmer(cluster):
        prewarms.append(cluster)
        return True

    det = det_cls(cfg_cls(SOAK_PROPS), healer=healer, prewarmer=prewarmer, clock=lambda: 0)
    decisions = []
    for cluster, t_s, sig, injected in _recorded_stream():
        if injected:
            det.note_signal(cluster, t_s)
        decisions.append(det.observe(cluster, dict(sig), t_s))
    return {"decisions": decisions, "calls": calls, "prewarms": prewarms,
            "metrics": dict(det.metrics), "episodes": det.slo.episodes_json(limit=64),
            "compliance": det.slo.compliance(), "burn_rates": det.slo.burn_rates(),
            "times_to_heal": det.slo.times_to_heal()}


def test_stream_detector_takes_the_jax_packages_decisions():
    ours = _drive(StreamDetector, CruiseControlConfig)
    theirs = _drive(JaxStreamDetector, JaxConfig)
    assert ours == theirs
    # the stream opened one episode per injection, each fired and recovered
    assert [(e["cluster"], e["family"]) for e in ours["episodes"]] == [
        ("c0", "broker_failure"), ("c1", "cold_serve")]
    assert all(e["verb"] and e["recoveredS"] is not None for e in ours["episodes"])
    assert [c[:2] for c in ours["calls"]] == [("c0", "broker_failure"), ("c1", "cold_serve")]


@pytest.fixture(autouse=True)
def _disarmed():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def test_run_soak_through_the_sidecar_on_the_cpu():
    served = runs.serve_cold("B3", "cpu", spec=base_spec(), goals=GOALS, opts=small_opts(),
                             warm_wire=WARM_WIRE)
    try:
        out = runs.run_soak("B3", 2, 29, 1729, served=served)
    finally:
        served.close()
    assert not FAULTS.armed
    assert not any(tinc.STORE.get(f"soak-B3-c{i}") for i in range(2))
    tinc.STORE.clear()
    banked = json.loads((ROOT / "SOAK_r01.json").read_text())
    assert set(banked) <= set(out)
    for key in ("gates", "healing", "slo", "windows", "devmem"):
        assert set(banked[key]) <= set(out[key]), key
    assert out["backend"] == "cpu" and out["device"] == {"kind": "cpu"}
    gates = out["gates"]
    assert not gates["fleet_minutes_ok"] and out["fleet_minutes"] == pytest.approx(9.7, abs=0.1)
    assert all(ok for k, ok in gates.items() if k != "fleet_minutes_ok"), gates
    assert not out["verified"]  # 9.7 simulated fleet-minutes are below the run's 30
    heal = out["healing"]
    assert [(i["tick"], i["kind"], i["cluster"]) for i in out["injections"]] == [
        (10, "broker-kill", "soak-B3-c0"), (22, "bank-kill", "soak-B3-c1")]
    assert out["injections"][1]["fired"] == {"placement.bank:raise": 1}
    assert heal["injections"] == heal["episodes"] == heal["recovered"] == 2
    assert heal["family_census"] == {"broker_failure": 1, "cold_serve": 1}
    assert heal["detector_metrics"]["fired"] == heal["detector_metrics"]["recovered"] == 2
    assert [(h["cluster"], h["family"]) for h in heal["heals"]] == [
        ("soak-B3-c0", "broker_failure"), ("soak-B3-c1", "cold_serve")]
    assert all(h["verified"] and h["warm"] for h in heal["heals"])
    w = out["windows"]
    assert w["total"] == len(out["window_detail"]) == 58
    assert w["cold_fallback"] == 1 and w["unverified"] == 0
    assert all(x["wall_s"] is not None for x in out["window_detail"])
    # the registry holds the cold ref and the clusters, the store the clusters
    assert (out["registry"]["sessions"], out["store"]["sessions"]) == (3, 2)
    # on the CPU the wrapper takes the plain version and counts nothing
    assert all(x["launches"] == 0 for x in out["window_detail"])


@pytest.mark.parametrize("run", [["--soak", "B3"], ["--steady-fleet", "B3"]])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(run, monkeypatch):
    from ccx_torch.bench.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(run)
    seen = {}

    def fake(name, *args, device=None, **kwargs):
        seen.update(name=name, args=args, device=device)
        return {"verified": True}

    monkeypatch.setattr(runs, "run_soak", fake)
    monkeypatch.setattr(runs, "run_steady_fleet", fake)
    assert main([*run, "--device", "cpu"]) == 0
    assert seen["name"] == "B3" and seen["device"].type == "cpu"
    # the JAX bench's defaults: 2 clusters x 96 ticks at seed 1729; 16 x 10
    assert seen["args"] == ((2, 96, 1729) if run[0] == "--soak" else (16, 10))


def test_entry_point_reads_the_jax_benchs_environment_twins(monkeypatch):
    from ccx_torch.bench.__main__ import main

    seen = []
    monkeypatch.setattr(runs, "run_soak", lambda *a, **k: seen.append(a) or {"verified": True})
    monkeypatch.setattr(runs, "run_steady_fleet",
                        lambda *a, **k: seen.append(a) or {"verified": False})
    for k, v in {"CCX_SOAK_CLUSTERS": "3", "CCX_SOAK_TICKS": "40", "CCX_SOAK_SEED": "7",
                 "CCX_BENCH_STEADYFLEET_CLUSTERS": "5",
                 "CCX_BENCH_STEADYFLEET_WINDOWS": "6"}.items():
        monkeypatch.setenv(k, v)
    assert main(["--soak", "B3", "--device", "cpu"]) == 0
    assert main(["--soak", "B3", "--clusters", "4", "--device", "cpu"]) == 0
    assert main(["--steady-fleet", "B3", "--device", "cpu"]) == 1
    assert seen == [("B3", 3, 40, 7), ("B3", 4, 40, 7), ("B3", 5, 6)]
