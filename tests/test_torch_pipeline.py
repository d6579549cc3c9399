"""The whole slice: ``ccx_torch.optimizer.optimize`` against ``ccx.optimizer``.

Two configurations run through both pipelines at the same small effort,
every option passed explicitly:

* a shrunk B3-like cluster (20 brokers, 2 of them dead, 400 partitions)
  with single moves only (``p_swap=0``), no topic-rebalance stage and no
  portfolio;
* the lean rung's stages on a 64-broker cluster (2 dead, 600 partitions):
  the batched SA engine with usage-coupled swaps, the polish skipped, one
  topic-rebalance round with its TRD-guarded re-polish, swap polish before
  and after a capped leadership pass.

The starting stack must equal JAX's; the port's result must verify with
zero hard violations, and applying its diff to the input must give its
output.

The two searches draw from different random streams (torch's generator vs
JAX's threefry), so their end states differ. Each soft goal's violation
count must stay within max(10, 25%) of JAX's: at this budget, six seeds of
either package spread a goal's count by up to 9 (up to ~15% for the
TopicReplicaDistribution count of 120-150).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.model.fixtures import RandomClusterSpec, random_cluster
from ccx.optimizer import OptimizeOptions as JaxOptimizeOptions
from ccx.optimizer import optimize as jax_optimize
from ccx.search.annealer import AnnealOptions as JaxAnnealOptions
from ccx.search import greedy as jgreedy
from ccx.search.greedy import GreedyOptions as JaxGreedyOptions
from ccx_torch import rungs
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions, SwapPolishOptions

SPEC = RandomClusterSpec(
    n_brokers=20, n_racks=4, n_topics=20, n_partitions=400, n_dead_brokers=2, seed=3
)
EFFORT = dict(n_chains=4, n_steps=60, moves_per_step=4, seed=42)
POLISH = dict(n_candidates=64, max_iters=40, patience=8)
LEADER_ITERS = 30


@pytest.fixture(scope="module")
def runs():
    jm = random_cluster(SPEC)
    jres = jax_optimize(jm, JaxGoalConfig(), opts=JaxOptimizeOptions(
        anneal=JaxAnnealOptions(p_swap=0.0, **EFFORT),
        polish=JaxGreedyOptions(**POLISH),
        run_cold_greedy=False,
        topic_rebalance_rounds=0,
        leader_pass_max_iters=LEADER_ITERS,
    ))
    tm = model_from_arrays(
        {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}, jm.num_topics, jm.num_racks, "cpu"
    )
    launches = agg_op.LAUNCHES
    tres = optimize(tm, GoalConfig(), opts=OptimizeOptions(
        anneal=AnnealOptions(p_swap=0.0, **EFFORT),
        polish=GreedyOptions(**POLISH),
        run_cold_greedy=False,
        topic_rebalance_rounds=0,
        leader_pass_max_iters=LEADER_ITERS,
    ))
    assert agg_op.LAUNCHES == launches
    return jm, jres, tm, tres


def _stack_before_matches(jres, tres):
    assert tres.stack_before.names == tuple(jres.stack_before.names)
    np.testing.assert_array_equal(tres.stack_before.violations.numpy(), np.asarray(jres.stack_before.violations))
    np.testing.assert_allclose(
        tres.stack_before.costs.numpy(), np.asarray(jres.stack_before.costs), rtol=1e-5, atol=1e-6
    )
    assert float(tres.stack_before.hard_violations) > 0


def test_stack_before_matches_jax(runs):
    _stack_before_matches(runs[1], runs[3])


def test_result_verifies_with_zero_hard_violations(runs):
    _, jres, _, tres = runs
    assert jres.verification.ok
    assert tres.verification.ok, tres.verification.failures
    assert float(tres.stack_after.hard_violations) == 0
    assert tres.n_sa_accepted > 0 and tres.n_polish_moves > 0
    assert set(tres.phase_seconds) >= {"repair", "anneal", "polish", "leader-pass", "diff", "verify"}


def test_diff_applied_to_input_gives_output(runs):
    _diff_gives_output(runs[2], runs[3])


def _diff_gives_output(tm, tres):
    a = tm.assignment.numpy().copy()
    lead = tm.leader_slot.numpy().copy()
    disk = tm.replica_disk.numpy().copy()
    c = tres.diff.cols
    assert len(tres.diff) > 0
    for p, new, new_leader, new_disk in zip(c["partition"], c["newReplicas"], c["newLeader"], c["newDisks"]):
        a[p] = new
        lead[p] = int(np.nonzero(new == new_leader)[0][0])
        disk[p] = np.where(new >= 0, new_disk, disk[p])
    np.testing.assert_array_equal(a, tres.model.assignment.numpy())
    np.testing.assert_array_equal(lead, tres.model.leader_slot.numpy())
    np.testing.assert_array_equal(disk, tres.model.replica_disk.numpy())
    assert tres.num_replica_movements > 0
    rows = tres.diff.rows
    assert [r.partition for r in rows] == c["partition"].tolist()
    assert all(r.new_leader == r.new_replicas[0] for r in rows)


def test_soft_goals_within_band_of_jax(runs):
    _soft_goals_within_band(runs[1], runs[3])


def _soft_goals_within_band(jres, tres):
    jv = dict(zip(jres.stack_after.names, np.asarray(jres.stack_after.violations).tolist()))
    tv = dict(zip(tres.stack_after.names, tres.stack_after.violations.tolist()))
    for name, want in jv.items():
        if GOAL_REGISTRY[name].hard:
            assert tv[name] == want == 0, name
            continue
        band = max(10.0, 0.25 * want)
        assert abs(tv[name] - want) <= band, (name, tv[name], want)


#: the lean rung's stages at a small budget, on a cluster wide enough for
#: the batched SA engine (64 brokers >= 4 * R * 4 moves)
LEAN_SPEC = RandomClusterSpec(
    n_brokers=64, n_racks=8, n_topics=24, n_partitions=600, n_dead_brokers=2, seed=3
)
LEAN_ANNEAL = dict(n_chains=4, n_steps=40, moves_per_step=4, seed=42, p_swap=0.15,
                   swap_coupling=0.5)
LEAN_STAGES = dict(
    run_polish=False, run_cold_greedy=False, topic_rebalance_rounds=1,
    topic_rebalance_max_sweeps=64, topic_rebalance_move_leaders=True,
    topic_rebalance_guarded=True, topic_rebalance_polish_iters=60,
    swap_polish_iters=20, swap_polish_post_iters=30, swap_polish_candidates=32,
    swap_polish_guarded=True, leader_pass_max_iters=20,
)


@pytest.fixture(scope="module")
def lean():
    jm = random_cluster(LEAN_SPEC)
    jres = jax_optimize(jm, JaxGoalConfig(), opts=JaxOptimizeOptions(
        anneal=JaxAnnealOptions(**LEAN_ANNEAL), polish=JaxGreedyOptions(**POLISH), **LEAN_STAGES,
    ))
    tm = model_from_arrays(
        {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}, jm.num_topics, jm.num_racks, "cpu"
    )
    tres = optimize(tm, GoalConfig(), opts=OptimizeOptions(
        anneal=AnnealOptions(**LEAN_ANNEAL), polish=GreedyOptions(**POLISH), **LEAN_STAGES,
    ))
    return jm, jres, tm, tres


def test_lean_stages_run_and_verify(lean):
    _, jres, tm, tres = lean
    _stack_before_matches(jres, tres)
    assert jres.verification.ok
    assert tres.verification.ok, tres.verification.failures
    assert float(tres.stack_after.hard_violations) == 0
    assert tres.sa_engine == "batched"
    assert set(tres.phase_seconds) >= {
        "repair", "anneal", "polish", "topic-rebalance", "swap-polish", "leader-pass",
        "swap-polish-post", "preferred-leader", "diff", "verify",
    }
    assert "portfolio" not in tres.phase_seconds
    mc = tres.move_counters
    assert mc["replicaSwap"]["proposed"] > 0 and mc["leadershipSwap"]["proposed"] > 0
    assert mc["replicaSwap"]["accepted"] > 0
    _diff_gives_output(tm, tres)


def test_lean_stages_soft_goals_within_band_of_jax(lean):
    _soft_goals_within_band(lean[1], lean[3])


def _shared_fields(port_cls, jax_cls) -> list[str]:
    jax_names = {f.name for f in dataclasses.fields(jax_cls)}
    return [f.name for f in dataclasses.fields(port_cls) if f.name in jax_names]


@pytest.mark.parametrize("port_cls,jax_cls", [
    (AnnealOptions, JaxAnnealOptions),
    (GreedyOptions, JaxGreedyOptions),
    (SwapPolishOptions, jgreedy.SwapPolishOptions),
    (OptimizeOptions, JaxOptimizeOptions),
], ids=["AnnealOptions", "GreedyOptions", "SwapPolishOptions", "OptimizeOptions"])
def test_option_defaults_equal_jax(port_cls, jax_cls):
    port, ref = port_cls(), jax_cls()
    names = _shared_fields(port_cls, jax_cls)
    assert len(names) >= 5
    for name in names:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            for sub in _shared_fields(type(a), type(b)):
                assert getattr(a, sub) == getattr(b, sub), f"{name}.{sub}"
        else:
            assert a == b, name


@pytest.mark.parametrize("rung", ["target", "lean"])
@pytest.mark.parametrize("config", ["B1", "B5"])
def test_rungs_build_the_bench_options(config, rung, monkeypatch):
    import bench

    for var in ("CCX_BENCH_CHAINS", "CCX_BENCH_STEPS", "CCX_BENCH_MOVES", "CCX_BENCH_POLISH_ITERS",
                "CCX_BENCH_PORTFOLIO", "CCX_BENCH_SHARDED"):
        monkeypatch.delenv(var, raising=False)
    goals, opts, effort = rungs.build_opts(config, rung)
    jgoals, jopts, jeffort = bench.build_opts(config, rung)
    assert goals == tuple(jgoals)
    assert rungs.RUNGS[rung] == bench.RUNGS[rung]
    for name in _shared_fields(OptimizeOptions, JaxOptimizeOptions):
        a, b = getattr(opts, name), getattr(jopts, name)
        if dataclasses.is_dataclass(a):
            for sub in _shared_fields(type(a), type(b)):
                assert getattr(a, sub) == getattr(b, sub), f"{name}.{sub}"
        else:
            assert a == b, name
    for key in ("chains", "steps", "moves", "polish_iters", "portfolio", "trd_rounds",
                "swap_polish", "swap_coupling"):
        assert effort[key] == jeffort[key], key


@pytest.mark.slow
def test_lean_quality_envelope_at_downscaled_b5():
    """The port at the JAX package's 1/10-scale B5 lean check
    (``tests/test_quality_b5_shape.py``: same cluster, effort and stages):
    verified, hard zero, every tier under the JAX test's ceilings, swaps
    accepted."""
    from test_quality_b5_shape import CEILINGS

    from ccx_torch.model.fixtures import RandomClusterSpec as TorchSpec
    from ccx_torch.model.fixtures import random_cluster as torch_cluster

    m = torch_cluster(TorchSpec(n_brokers=100, n_racks=10, n_topics=50, n_partitions=10_000,
                                n_dead_brokers=2, seed=7), device="cpu")
    res = optimize(m, GoalConfig(), opts=OptimizeOptions(
        anneal=AnnealOptions(n_chains=8, n_steps=200, moves_per_step=8, seed=42),
        polish=GreedyOptions(n_candidates=256, max_iters=200, patience=16),
        run_polish=False, run_cold_greedy=False, topic_rebalance_rounds=1,
        topic_rebalance_max_sweeps=1024, topic_rebalance_move_leaders=True,
        topic_rebalance_polish_iters=200, leader_pass_max_iters=60,
        swap_polish_iters=60, swap_polish_post_iters=100,
    ))
    assert res.verification.ok, res.verification.failures
    assert float(res.stack_after.hard_violations) == 0
    assert res.sa_engine == "batched"
    after = {n: float(v) for n, (v, _) in res.stack_after.by_name().items()}
    for goal, ceiling in CEILINGS.items():
        assert after[goal] <= ceiling, (goal, after[goal], ceiling)
    assert res.move_counters["replicaSwap"]["accepted"] > 0, res.move_counters
