"""The reference against the system on the CPU: the frozen generator draws
the system's fixtures bit for bit, and the NumPy goal stack, aggregates and
statistics equal the system's plain scoring on small clusters."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from ccx_torch.common.costmodel import aggregates_work
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, evaluate_stack
from ccx_torch.model.fixtures import bench_spec, random_cluster_arrays
from ccx_torch.model.snapshot import arrays_to_model
from ccx_torch.model.stats import cluster_model_stats
from perfbench import harness, work
from perfbench.reference import generator as gen
from perfbench.reference import goals as rg

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _spec(name: str) -> dict:
    return dataclasses.asdict(bench_spec(name))


@pytest.mark.parametrize("name", ["B1", "B2", "B3", "B4", "B5"])
def test_generator_equals_the_systems(name):
    mine, theirs = gen.random_cluster_arrays(_spec(name)), random_cluster_arrays(bench_spec(name))
    assert mine.keys() == theirs.keys()
    for key, want in theirs.items():
        got = mine[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        else:
            assert got == want, key


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_config_files_state_the_fixture_specs(cell):
    c = harness.Cell.load(cell)
    name = c.config["name"]
    spec = gen.spec_of(c.config)
    assert spec == {**_spec(name), "mean_load": list(_spec(name)["mean_load"])}


def _placement(snap: dict, seed: int) -> dict:
    """Leaders moved off slot 0 and one replica of every fifth partition
    moved to another broker: a placement with something to score."""
    rng = np.random.default_rng(seed)
    a = snap["assignment"].copy()
    rf = (a >= 0).sum(1)
    lead = (rng.integers(0, 3, rf.size) % rf).astype(np.int32)
    B = snap["broker_capacity"].shape[1]
    for p in range(0, a.shape[0], 5):
        a[p, 0] = rng.integers(0, B)
    return {"assignment": a, "leader_slot": lead}


@pytest.mark.parametrize("name", ["B1", "B2", "B3", "B4"])
def test_goal_stack_and_stats_equal_the_systems(name):
    config = harness.Cell.load("b5-cold-target").config
    snap = gen.snapshot(gen.random_cluster_arrays(_spec(name)))
    placement = _placement(snap, 7)
    m = arrays_to_model(dict(snap, **placement), device="cpu")
    theirs = evaluate_stack(m, GoalConfig(), DEFAULT_GOAL_ORDER).by_name()
    mine = rg.goal_stack(snap, placement, list(DEFAULT_GOAL_ORDER), config["thresholds"])
    for goal in DEFAULT_GOAL_ORDER:
        assert mine[goal][0] == theirs[goal][0], goal
        assert mine[goal][1] == pytest.approx(theirs[goal][1], rel=1e-5, abs=1e-6), goal
    stats = cluster_model_stats(m).to_json()
    ref = rg.cluster_stats(snap, placement)
    assert stats["metadata"] == ref["metadata"]
    for stat in ("AVG", "STD", "MIN", "MAX"):
        for key, want in ref[stat].items():
            assert stats["statistics"][stat][key] == pytest.approx(want, rel=1e-5, abs=1e-9)


def test_config_thresholds_are_the_systems_defaults():
    thr = harness.Cell.load("b5-cold-target").config["thresholds"]
    for key, want in dataclasses.asdict(GoalConfig()).items():
        if key in thr:
            assert thr[key] == (list(want) if isinstance(want, tuple) else want), key


def test_apply_diff_takes_fitting_rows_and_counts_the_rest():
    snap = gen.snapshot(gen.random_cluster_arrays(_spec("B1")))
    a = snap["assignment"]
    rows = [0, 1]
    new = a[rows].copy()
    new[0] = new[0][[1, 0, 2]]  # leadership moves to the old second replica
    cols = {"partition": np.array(rows), "oldReplicas": a[rows], "newReplicas": new,
            "oldLeader": a[rows, 0], "newLeader": new[:, 0]}
    placement, faults = rg.apply_diff(snap, cols)
    assert faults == 0
    assert np.array_equal(placement["assignment"][0], new[0])
    bad = dict(cols, oldLeader=np.array([a[0, 1], a[1, 0]]))
    _, faults = rg.apply_diff(snap, bad)
    assert faults == 1
    with pytest.raises(rg.DiffFault):
        rg.apply_diff(snap, {k: np.concatenate([v, v]) for k, v in cols.items()})


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.0 + 2**-8 + 2**-9, 3.14159265], np.float32)
    got = rg.round_bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0  # a tie rounds to even
    assert got[2] == np.float32(1.0 + 2**-7)
    assert abs(got[3] - x[3]) <= 2**-8 * 4


@pytest.mark.parametrize("name", ["B1", "B3", "B5"])
def test_aggregates_bytes_equal_the_systems_count(name):
    s = _spec(name)
    snap = gen.snapshot(gen.random_cluster_arrays(s))
    m = arrays_to_model(snap, device="cpu")
    n_rep = int((snap["assignment"] >= 0).sum())
    _, theirs = aggregates_work(m.P, m.R, m.B, m.num_topics, m.D, s["n_partitions"], n_rep)
    assert work.aggregates_bytes(s["n_partitions"], s["max_rf"], s["n_brokers"], s["n_topics"],
                                 s["n_disks"]) == theirs
