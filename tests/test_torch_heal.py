"""Broker-failure healing on the port, on the CPU at a small size: a cold
Propose through the in-process sidecar evacuates the dead brokers and
reports what the benchmark's NumPy reference counts, and the repair and
anneal spans count what the heal did."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster, random_cluster_arrays
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from perfbench import harness
from perfbench.reference import generator as gen
from perfbench.reference import goals as rg

#: 20 brokers on 4 racks, 2 of them dead, over 400 partitions
SPEC = RandomClusterSpec(n_brokers=20, n_racks=4, n_topics=10, n_partitions=400,
                         n_dead_brokers=2, seed=3)
#: a search budget the CPU runs in seconds; every phase stays on
CUT = {"chains": 4, "steps": 10, "moves_per_step": 2, "chunk_steps": 5, "polish_max_iters": 6,
       "polish_chunk_iters": 3, "leader_pass_max_iters": 3, "polish_candidates": 32}


def _small_cell() -> harness.Cell:
    """The cold benchmark cell (the sidecar, its client, the goals and the
    options, ``check_evacuation`` and ``require_hard_zero`` on) on
    ``SPEC`` at the ``CUT`` budget."""
    cell = harness.Cell.load("b5-cold-target")
    spec = {**dataclasses.asdict(SPEC), "mean_load": list(SPEC.mean_load)}
    cell.config = {**cell.config, "spec": spec}
    cell.traffic = {**cell.traffic, "options": {**cell.traffic["options"], **CUT},
                    "warmup_options": {**cell.traffic["warmup_options"], "polish_max_iters": 2,
                                       "polish_chunk_iters": 1, "leader_pass_max_iters": 1}}
    return cell


def _on_dead(snap: dict, assignment: np.ndarray) -> int:
    alive = np.asarray(snap["broker_alive"], bool)
    return int(((assignment >= 0) & ~alive[np.clip(assignment, 0, alive.size - 1)]).sum())


def test_a_dead_broker_cluster_heals_through_the_sidecar():
    cell = _small_cell()
    spec = gen.spec_of(cell.config)
    run = harness.Run(cell, 2**31 + 5, torch.device("cpu"))
    snap = gen.redraw_loads(gen.snapshot(gen.random_cluster_arrays(spec)), spec, run.rng(1, 0))
    assert spec["n_brokers"] == 20 and spec["n_racks"] == 4 and spec["n_dead_brokers"] == 2
    assert _on_dead(snap, snap["assignment"]) > 0
    run.start_sidecar()
    try:
        run.put("heal", 1, snap)
        res, _ = run.propose("heal", cell.traffic["options"])
    finally:
        run.stop_sidecar()
    assert res["verified"]
    placement, faults = rg.apply_diff(snap, res["proposalsColumnar"])
    assert faults == 0
    assert _on_dead(snap, placement["assignment"]) == 0
    goals = [g["name"] for g in cell.config["goals"]]
    ref = rg.goal_stack(snap, placement, goals, cell.config["thresholds"])
    assert sum(ref[g["name"]][0] for g in cell.config["goals"] if g["hard"]) == 0
    reported = {g["goal"]: g["violationsAfter"] for g in res["goalSummary"]}
    assert reported == {g: ref[g][0] for g in goals}


def _structural_rows(m) -> int:
    """Rows with a replica on a dead broker, two replicas on one broker,
    or two on one rack while the row fits on the racks that can take a
    replica: the offenders a repair sweep counts."""
    a = m.assignment.numpy()[: int(m.partition_valid.sum())]
    ok = m.broker_ok.numpy()
    rack = m.broker_rack.numpy()
    valid = a >= 0
    safe = np.clip(a, 0, ok.size - 1)
    on_dead = (valid & ~ok[safe]).any(1)
    recv = ok & ~m.broker_excl_replicas.numpy()
    fits = valid.sum(1) <= np.unique(rack[recv]).size
    dup_b = np.zeros(len(a), bool)
    dup_r = np.zeros(len(a), bool)
    for i in range(a.shape[1]):
        for j in range(i + 1, a.shape[1]):
            both = valid[:, i] & valid[:, j]
            dup_b |= both & (a[:, i] == a[:, j])
            dup_r |= both & (rack[safe[:, i]] == rack[safe[:, j]])
    return int((on_dead | dup_b | (dup_r & fits)).sum())


@pytest.mark.parametrize("n_brokers,moves,engine", [(20, 2, "sequential"), (100, 8, "batched")],
                         ids=["20-brokers", "100-brokers"])
def test_the_heal_spans_count_the_repair_and_the_engine(n_brokers, moves, engine):
    spec = dataclasses.replace(SPEC, n_brokers=n_brokers)
    m = random_cluster(spec, device="cpu")
    steps = 6
    opts = OptimizeOptions(
        anneal=AnnealOptions(n_chains=2, n_steps=steps, moves_per_step=moves, chunk_steps=3,
                             seed=7),
        polish=GreedyOptions(n_candidates=32, max_iters=4), leader_pass_max_iters=2,
        run_cold_greedy=False, topic_rebalance_rounds=0, max_repair_rounds=1,
    )
    res = optimize(m, GoalConfig(), DEFAULT_GOAL_ORDER, opts)
    spans = {c["name"]: c for c in res.span_tree["children"]}
    anneal = spans["anneal"]["attrs"]
    assert anneal["engine"] == engine
    assert anneal["subSteps"] == (steps * moves if engine == "sequential" else steps)
    repair = spans["repair"]["attrs"]
    assert repair["sweeps"] >= 1
    assert repair["structuralOffenders"] == _structural_rows(m) > 0
    arrays = random_cluster_arrays(spec)
    assert repair["movedReplicas"] >= _on_dead(arrays, arrays["assignment"]) > 0
