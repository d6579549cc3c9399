"""The port's scenario corpus against the JAX package's.

* The port's generator (a copy) emits the JAX package's windows: labels,
  arrays and flags equal for every family.
* Every window's arrays build the same model in both packages, field for
  field (assignment, leader slot, disks, masks and loads), and the port's
  ``shape_key`` names its built padding.
* Per family, the port's warm path serves every window verified,
  warm-started and inside the family's envelope against the port's own
  clean baseline, and JAX's warm path passes the same windows from the same
  base. The engines' draws differ, so the runs are compared on what the
  ROADMAP's rule for whole stochastic runs asks: hard tiers zero (a verified
  result) and the envelope.
* A warm result that keeps a hard violation gets the cold pipeline's
  repair retries at the warm budget, and ships verified when they clear it
  (the port's addition to the JAX warm path).
* ``run_scenario`` on the CPU through an in-process gRPC sidecar at the
  same small size is verified and returns the keys of the JAX bench's
  ``SCENARIO_r01.json``; the entry point refuses to run without a card and
  rejects an unknown family before any solve.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ccx.bench import scenarios as jsc
from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.model.fixtures import RandomClusterSpec
from ccx.model.snapshot import arrays_to_model as jax_arrays_to_model
from ccx.optimizer import OptimizeOptions as JaxOptimizeOptions
from ccx.optimizer import optimize as jax_optimize
from ccx.search import incremental as jinc
from ccx.search.annealer import AnnealOptions as JaxAnnealOptions
from ccx.search.greedy import GreedyOptions as JaxGreedyOptions
from ccx.search.incremental import IncrementalOptions as JaxIncrementalOptions
from ccx_torch.bench import runs
from ccx_torch.bench import scenarios as sc
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import evaluate_stack
from ccx_torch.model.fixtures import random_cluster
from ccx_torch.model.snapshot import arrays_to_model, model_to_arrays
from ccx_torch.model.tensor_model import TENSOR_FIELDS
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search import incremental as tinc
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from ccx_torch.search.incremental import IncrementalOptions
from ccx_torch.search.state import max_partitions_per_topic

ROOT = Path(__file__).resolve().parents[1]
CFG = GoalConfig()
#: the JAX scenario test's goal stack
GOALS = ("StructuralFeasibility", "ReplicaDistributionGoal", "RackAwareGoal", "DiskCapacityGoal")
#: the warm budget of the JAX scenario test's ``small_opts``, as Propose keys
WARM_WIRE = {"warm_swap_iters": 4, "warm_swap_candidates": 8, "warm_steps": 16,
             "warm_chunk_steps": 4}


def base_spec() -> RandomClusterSpec:
    # the JAX test's base: 10 brokers pad to 16 (wave headroom), 200
    # partitions pad to 256 (growth headroom)
    return RandomClusterSpec(n_brokers=10, n_racks=3, n_topics=6, n_partitions=200, seed=11)


def _small(O, A, G, I):  # noqa: E741 — the four option classes of a package
    return O(
        anneal=A(n_chains=2, n_steps=24, chunk_steps=12),
        polish=G(n_candidates=8, max_iters=6, chunk_iters=3),
        topic_rebalance_rounds=0, swap_polish_iters=4, swap_polish_post_iters=0,
        run_cold_greedy=False,
        incremental=I(enabled=True, warm_swap_iters=4, warm_swap_candidates=8, warm_steps=16,
                      warm_chunk_steps=4),
    )


def small_opts() -> OptimizeOptions:
    """The JAX scenario test's ``small_opts``, in the port's options."""
    return _small(OptimizeOptions, AnnealOptions, GreedyOptions, IncrementalOptions)


@pytest.fixture(scope="module")
def converged_base():
    """(applied arrays, applied port model, the port's clean goals_after):
    one cold solve on the port."""
    m = random_cluster(base_spec(), device="cpu")
    res = optimize(m, CFG, GOALS, small_opts())
    assert res.verification.ok
    applied_model = m.replace(assignment=res.model.assignment,
                              leader_slot=res.model.leader_slot,
                              replica_disk=res.model.replica_disk)
    clean = sc.goals_after(res.to_json(include_stats=False).get("goalSummary"))
    return model_to_arrays(applied_model), applied_model, clean


@pytest.mark.parametrize("family", sc.FAMILIES)
def test_generator_emits_the_jax_packages_windows(family, converged_base):
    applied, _, _ = converged_base
    opts = sc.ScenarioOptions(windows=4)
    ours = sc.generate(family, applied, opts)
    theirs = jsc.generate(family, applied, jsc.ScenarioOptions(windows=4))
    assert [(w.label, w.structural) for w in ours] == [(w.label, w.structural) for w in theirs]
    for a, b in zip(ours, theirs):
        assert sorted(a.arrays) == sorted(b.arrays)
        for k, v in a.arrays.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b.arrays[k].dtype and np.array_equal(v, b.arrays[k]), (family, k)
            else:
                assert v == b.arrays[k], (family, k)


@pytest.mark.parametrize("family", sc.FAMILIES)
def test_windows_build_equal_models_in_both_packages(family, converged_base):
    """Every window's arrays build the same padded model in the port as in
    the JAX package, and the port's ``shape_key`` is its built padding."""
    applied, _, _ = converged_base
    for w in sc.generate(family, applied, sc.ScenarioOptions(windows=4)):
        ours = arrays_to_model(w.arrays, device="cpu")
        theirs = jax_arrays_to_model(w.arrays)
        assert (ours.num_topics, ours.num_racks) == (theirs.num_topics, theirs.num_racks)
        for field in TENSOR_FIELDS:
            a, b = getattr(ours, field).numpy(), np.asarray(getattr(theirs, field))
            assert a.shape == b.shape and np.array_equal(a, b), (family, w.label, field)
        assert sc.shape_key(w.arrays) == (
            ours.P, ours.B, ours.R, ours.D, ours.num_topics, max_partitions_per_topic(ours),
            ours.num_racks,
        ), (family, w.label)


@pytest.mark.parametrize("family", sc.FAMILIES)
def test_family_recovers_warm_verified_inside_envelope(family, converged_base):
    """Two windows of each family through the port's warm path and through
    JAX's, each from the same applied base: verified, warm-started and inside
    the family's envelope against the port's clean baseline."""
    applied, applied_model, clean = converged_base
    jopts = _small(JaxOptimizeOptions, JaxAnnealOptions, JaxGreedyOptions, JaxIncrementalOptions)
    session = f"torch-scn-{family}"
    for store in (tinc.STORE, jinc.STORE):
        store.drop(session)
    tinc.remember(session, 1, applied_model, CFG)
    jinc.remember(session, 1, jax_arrays_to_model(applied), JaxGoalConfig())
    try:
        for gen, w in enumerate(sc.generate(family, applied, sc.ScenarioOptions(windows=2)), 2):
            ours = optimize(arrays_to_model(w.arrays, device="cpu"), CFG, GOALS, small_opts(),
                            warm_start=tinc.STORE.get(session))
            theirs = jax_optimize(jax_arrays_to_model(w.arrays), JaxGoalConfig(), GOALS, jopts,
                                  warm_start=jinc.STORE.get(session))
            for who, res in (("port", ours), ("jax", theirs)):
                assert res.verification.ok, (who, w.label, res.verification.failures)
                assert (res.incremental or {}).get("warmStart") is True, (who, w.label)
                after = sc.goals_after(res.to_json(include_stats=False).get("goalSummary"))
                assert sc.check_envelope(family, clean, after) == [], (who, w.label)
            tinc.remember(session, gen, ours.model, CFG)
            jinc.remember(session, gen, theirs.model, JaxGoalConfig())
    finally:
        tinc.STORE.drop(session)
        jinc.STORE.drop(session)


def test_warm_result_that_keeps_a_hard_violation_gets_the_repair_retries(converged_base,
                                                                          monkeypatch):
    """The disk family's first window with the warm search made to return the
    grafted placement unchanged, as its own base (so its disk overload stays,
    as the hot-skew family's x8 window keeps a network overload at B5): the
    cold pipeline's repair retries at the warm budget clear it, and the window
    ships warm and verified. Without them the same window ships unverified."""
    applied, applied_model, _ = converged_base
    window = sc.generate("disk-evacuation", applied, sc.ScenarioOptions(windows=1))[0]
    snap = arrays_to_model(window.arrays, device="cpu")
    real = tinc.reoptimize

    def searchless(m, warm, *args, **kwargs):
        # the result and the base the revert guards fall back to are both
        # the grafted placement, the stack to beat its own
        out = list(real(m, warm, *args, **kwargs))
        grafted = tinc.warm_model(m, warm)
        out[0], out[5] = grafted, grafted
        out[1], out[2], out[6] = evaluate_stack(grafted, CFG, GOALS), None, None
        return tuple(out)

    monkeypatch.setattr(tinc, "reoptimize", searchless)
    session = "torch-repair-retry"
    results = {}
    try:
        for retries in (True, False):
            if not retries:
                monkeypatch.setattr(tinc, "repair_retries", lambda *a, **k: None)
            tinc.STORE.drop(session)
            tinc.remember(session, 1, applied_model, CFG)
            warm = tinc.STORE.get(session)
            assert float(evaluate_stack(tinc.warm_model(snap, warm), CFG, GOALS)
                         .hard_violations) > 0
            results[retries] = optimize(snap, CFG, GOALS, small_opts(), warm_start=warm)
    finally:
        tinc.STORE.drop(session)
    healed, left = results[True], results[False]
    assert healed.verification.ok and healed.incremental["warmStart"]
    assert healed.incremental["repairRetries"] >= 1 and "repair-retry" in healed.phase_seconds
    assert float(healed.stack_after.hard_violations) == 0
    assert not left.verification.ok and "repairRetries" not in left.incremental
    assert any("DiskCapacityGoal" in f for f in left.verification.failures)


def test_run_scenario_through_the_sidecar_on_the_cpu():
    served = runs.serve_cold("B3", "cpu", spec=base_spec(), goals=GOALS, opts=small_opts(),
                             warm_wire=WARM_WIRE)
    try:
        out = runs.run_scenario("B3", windows=2, served=served)
    finally:
        served.close()
        tinc.STORE.clear()
    assert out["verified"], {k: v for k, v in out.items() if k != "families"}
    banked = json.loads((ROOT / "SCENARIO_r01.json").read_text())
    assert set(banked) <= set(out)
    assert set(banked["families"]["hot-skew"]) <= set(out["families"]["hot-skew"])
    assert list(out["families"]) == list(sc.FAMILIES)
    assert out["backend"] == "cpu" and out["device"] == {"kind": "cpu"}
    assert out["zero_measured_loop_compiles"] and out["clean"]["ok"]
    for fam, f in out["families"].items():
        assert f["windows"] == 2 and f["all_warm"] and f["envelope_ok"], fam
        # on the CPU the wrapper takes the plain version and counts nothing
        assert f["launches"] == {"broker_aggregates": 0}
        assert all(w["launches"] == 0 for w in f["window_detail"])


def test_scenario_options_read_the_ports_config_keys():
    from ccx_torch.config import CruiseControlConfig

    o = sc.ScenarioOptions.from_config(CruiseControlConfig({
        "optimizer.scenario.seed": 13, "optimizer.scenario.windows": 6,
        "optimizer.scenario.families": "hot-skew,broker-failures",
    }))
    assert (o.seed, o.windows, o.families) == (13, 6, ("hot-skew", "broker-failures"))
    assert sc.ScenarioOptions.from_config(CruiseControlConfig({})) == sc.ScenarioOptions()


def test_entry_point_needs_a_card_and_checks_families_first(monkeypatch):
    from ccx_torch.bench.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scenario", "B5"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--chaos", "B5"])
    # an unknown family fails before the fixture or the cold solve
    monkeypatch.setattr(runs, "serve_cold", lambda *a, **k: pytest.fail("cold solve started"))
    with pytest.raises(ValueError, match="unknown scenario families"):
        main(["--scenario", "B5", "--families", "bogus", "--device", "cpu"])
