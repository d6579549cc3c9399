"""The port's repair stages against the JAX package.

``_leader_fix`` and ``canonicalize_preferred_leaders`` are deterministic and
must match JAX exactly on the identical cluster. The repair sweeps draw
random tie-break noise (torch's generator, not JAX's), so their result is
held to what repair guarantees: a dead-broker cluster comes out with zero
structural and rack violations and a consistent placement.
"""

from __future__ import annotations

import numpy as np
import pytest

from ccx.model.tensor_model import build_model as jax_build_model
from ccx.search import repair as jrep
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, evaluate_stack
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster_arrays
from ccx_torch.model.tensor_model import build_model
from ccx_torch.search import repair as trep
from ccx_torch.verify import verify_model_consistency


def _pair(seed: int):
    """The same cluster in both packages: dead brokers, leadership-excluded
    brokers, immovable partitions and scrambled leader slots."""
    a = random_cluster_arrays(RandomClusterSpec(
        n_brokers=16, n_racks=4, n_topics=6, n_partitions=150, n_dead_brokers=3, seed=seed
    ))
    rng = np.random.default_rng(seed)
    P, B = a["assignment"].shape[0], a["broker_capacity"].shape[1]
    rf = (a["assignment"] >= 0).sum(1)
    a["leader_slot"] = (rng.integers(0, 3, P) % rf).astype(np.int32)
    a["broker_excl_leadership"] = rng.random(B) < 0.2
    a["partition_immovable"] = rng.random(P) < 0.1
    return jax_build_model(**a), build_model(**a, device="cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_leader_fix_matches_jax(seed):
    jm, tm = _pair(seed)
    want = np.asarray(jrep._leader_fix(jm, jm.assignment, jm.leader_slot))
    got = trep._leader_fix(tm, tm.assignment, tm.leader_slot).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != np.asarray(jm.leader_slot)).any()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_canonicalize_preferred_leaders_matches_jax(seed):
    jm, tm = _pair(seed)
    jout, jn = jrep.canonicalize_preferred_leaders(jm)
    tout, tn = trep.canonicalize_preferred_leaders(tm)
    assert tn == jn > 0
    for f in ("assignment", "leader_slot", "replica_disk"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)), err_msg=f)


@pytest.mark.parametrize("spec", [
    bench_spec("B3"),
    RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=5, n_partitions=300,
                      n_dead_brokers=3, capacity_headroom=1.4, seed=8),
], ids=["B3", "tight-capacity"])
def test_hard_repair_clears_structural_and_rack_violations(spec):
    m = build_model(**random_cluster_arrays(spec), device="cpu")
    cfg = GoalConfig()
    before = evaluate_stack(m, cfg).by_name()
    assert before["StructuralFeasibility"][0] > 0 and before["RackAwareGoal"][0] > 0
    out, n = trep.hard_repair(m, cfg, DEFAULT_GOAL_ORDER)
    after = evaluate_stack(out, cfg).by_name()
    assert n > 0
    assert after["StructuralFeasibility"][0] == 0
    assert after["RackAwareGoal"][0] == 0
    assert verify_model_consistency(out) == []
    rf0 = (m.assignment >= 0).sum(1)
    rf1 = (out.assignment >= 0).sum(1)
    assert bool((rf0 == rf1).all())


def test_finalize_preferred_leaders_zeroes_fixable_violations():
    _, tm = _pair(4)
    cfg = GoalConfig()
    stack = evaluate_stack(tm, cfg)
    out, after, n = trep.finalize_preferred_leaders(tm, cfg, DEFAULT_GOAL_ORDER, stack)
    assert n > 0
    ple = DEFAULT_GOAL_ORDER.index("PreferredLeaderElectionGoal")
    # only immovable partitions may keep a preferred-leader violation
    assert float(after.violations[ple]) <= float(tm.partition_immovable.sum())
    keep = [i for i in range(len(DEFAULT_GOAL_ORDER)) if i != ple]
    np.testing.assert_array_equal(after.violations[keep].numpy(), stack.violations[keep].numpy())
