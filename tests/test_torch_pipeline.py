"""The whole slice: ``ccx_torch.optimizer.optimize`` against ``ccx.optimizer``.

A shrunk B3-like cluster (20 brokers, 2 of them dead, 400 partitions) runs
through both pipelines at the same small effort, with the stages the port
has (no swaps, no topic-rebalance stage, no cold-greedy portfolio). The
starting stack must equal JAX's; the port's result must verify with zero
hard violations, and applying its diff to the input must give its output.

The two searches draw from different random streams (torch's generator vs
JAX's threefry), so their end states differ. Each soft goal's violation
count must stay within max(10, 25%) of JAX's: at this budget, six seeds of
either package spread a goal's count by up to 9 (up to ~15% for the
TopicReplicaDistribution count of 120-150).
"""

from __future__ import annotations

import numpy as np
import pytest

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.model.fixtures import RandomClusterSpec, random_cluster
from ccx.optimizer import OptimizeOptions as JaxOptimizeOptions
from ccx.optimizer import optimize as jax_optimize
from ccx.search.annealer import AnnealOptions as JaxAnnealOptions
from ccx.search.greedy import GreedyOptions as JaxGreedyOptions
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions

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
        leader_pass_max_iters=LEADER_ITERS,
    ))
    assert agg_op.LAUNCHES == launches
    return jm, jres, tm, tres


def test_stack_before_matches_jax(runs):
    _, jres, _, tres = runs
    assert tres.stack_before.names == tuple(jres.stack_before.names)
    np.testing.assert_array_equal(tres.stack_before.violations.numpy(), np.asarray(jres.stack_before.violations))
    np.testing.assert_allclose(
        tres.stack_before.costs.numpy(), np.asarray(jres.stack_before.costs), rtol=1e-5, atol=1e-6
    )
    assert float(tres.stack_before.hard_violations) > 0


def test_result_verifies_with_zero_hard_violations(runs):
    _, jres, _, tres = runs
    assert jres.verification.ok
    assert tres.verification.ok, tres.verification.failures
    assert float(tres.stack_after.hard_violations) == 0
    assert tres.n_sa_accepted > 0 and tres.n_polish_moves > 0
    assert set(tres.phase_seconds) >= {"repair", "anneal", "polish", "leader-pass", "diff", "verify"}


def test_diff_applied_to_input_gives_output(runs):
    _, _, tm, tres = runs
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
    _, jres, _, tres = runs
    jv = dict(zip(jres.stack_after.names, np.asarray(jres.stack_after.violations).tolist()))
    tv = dict(zip(tres.stack_after.names, tres.stack_after.violations.tolist()))
    for name, want in jv.items():
        if GOAL_REGISTRY[name].hard:
            assert tv[name] == want == 0, name
            continue
        band = max(10.0, 0.25 * want)
        assert abs(tv[name] - want) <= band, (name, tv[name], want)
