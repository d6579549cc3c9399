"""The port's ``topic_rebalance`` against the JAX package's.

Both are host numpy driven by ``np.random.default_rng(seed)``, so for the
same cluster and seed the placements must be bit-identical: assignment,
leader slots, replica disks and the move count, with leader moves on and
off. The fixtures cover dead brokers, JBOD disks, and a cluster with
MinTopicLeaders topics, a leadership-excluded broker, a replica-excluded
broker and immovable partitions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx.search import repair as jrepair
from ccx_torch.goals.base import GoalConfig
from ccx_torch.search import repair as trepair
from test_torch_state import carry


def _flagged():
    """A cluster whose exclusions and flags exercise every guard of the
    shed: MinTopicLeaders topics, excluded brokers, immovable partitions."""
    jm = random_cluster(RandomClusterSpec(n_brokers=24, n_racks=4, n_topics=12,
                                          n_partitions=600, n_dead_brokers=1, seed=8))
    rng = np.random.default_rng(8)
    tmin = np.zeros(jm.num_topics, bool)
    tmin[:4] = True
    excl_lead = np.zeros(jm.B, bool)
    excl_lead[3] = True
    excl_rep = np.zeros(jm.B, bool)
    excl_rep[5] = True
    imm = np.asarray(jm.partition_valid) & (rng.random(jm.P) < 0.05)
    return jm.replace(
        topic_min_leaders=jnp.asarray(tmin), broker_excl_leadership=jnp.asarray(excl_lead),
        broker_excl_replicas=jnp.asarray(excl_rep), partition_immovable=jnp.asarray(imm),
    )


FIXTURES = {
    "B3-dead-brokers": lambda: random_cluster(bench_spec("B3")),
    "B4-jbod": lambda: random_cluster(bench_spec("B4")),
    "flagged": _flagged,
}


@pytest.mark.parametrize("move_leaders", [True, False])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_topic_rebalance_bit_identical_to_jax(name, move_leaders):
    jm = FIXTURES[name]()
    tm = carry(jm)
    want, n_want = jrepair.topic_rebalance(jm, JaxGoalConfig(), max_sweeps=64, move_leaders=move_leaders)
    got, n_got = trepair.topic_rebalance(tm, GoalConfig(), max_sweeps=64, move_leaders=move_leaders)
    assert n_got == n_want > 0
    for f in ("assignment", "leader_slot", "replica_disk"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        assert getattr(got, f).dtype == getattr(tm, f).dtype
    if not move_leaders:
        assert (got.leader_slot == tm.leader_slot).all()


def test_topic_rebalance_without_over_cells_returns_the_input():
    jm = random_cluster(bench_spec("B3"))
    tm = carry(jm)
    loose = GoalConfig(topic_replica_balance_threshold=1e6)
    same, n = trepair.topic_rebalance(tm, loose)
    want, n_want = jrepair.topic_rebalance(jm, JaxGoalConfig(topic_replica_balance_threshold=1e6))
    assert n == n_want == 0 and same is tm
