"""The port's goal stack against the JAX package, goal by goal.

Both packages build the model from the same numpy arrays (the port's own
generator plus extra masks: leadership-excluded, replica-excluded and new
brokers, immovable partitions, min-leader topics), so every registered goal
is exercised. Violation counts must match exactly; costs within rtol 1e-5
(float sums are taken in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

from ccx.goals.base import GOAL_REGISTRY as JAX_REGISTRY
from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.goals.stack import evaluate_stack as jax_evaluate_stack
from ccx.model.tensor_model import build_model as jax_build_model
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, evaluate_stack, soft_weights
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster_arrays
from ccx_torch.model.tensor_model import TENSOR_FIELDS, build_model

GOALS = tuple(sorted(JAX_REGISTRY))


def _arrays(spec: RandomClusterSpec, masks: bool) -> dict:
    a = random_cluster_arrays(spec)
    if masks:
        rng = np.random.default_rng(spec.seed + 100)
        P = a["assignment"].shape[0]
        B = a["broker_capacity"].shape[1]
        T = int(a["partition_topic"].max()) + 1
        a["broker_excl_leadership"] = rng.random(B) < 0.15
        a["broker_excl_replicas"] = rng.random(B) < 0.1
        a["broker_new"] = rng.random(B) < 0.1
        a["partition_immovable"] = rng.random(P) < 0.05
        a["topic_min_leaders"] = rng.random(T) < 0.3
        rf = (a["assignment"] >= 0).sum(1)
        a["leader_slot"] = (rng.integers(0, 3, P) % rf).astype(np.int32)
    return a


CASES = {
    "dead-brokers": (RandomClusterSpec(
        n_brokers=20, n_racks=4, n_topics=12, n_partitions=300, n_dead_brokers=2, seed=7
    ), True),
    "jbod": (bench_spec("B4"), True),
    "hosts": (RandomClusterSpec(
        n_brokers=12, n_racks=3, n_topics=5, n_partitions=200, brokers_per_host=2,
        capacity_headroom=1.1, seed=9,
    ), False),
}


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for case, (spec, masks) in CASES.items():
        a = _arrays(spec, masks)
        tm = build_model(**a, device="cpu")
        jm = jax_build_model(**a)
        for k in TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), err_msg=k)
        js = jax_evaluate_stack(jm, JaxGoalConfig(), GOALS)
        ts = evaluate_stack(tm, GoalConfig(), GOALS)
        out[case] = (
            (np.asarray(js.violations), np.asarray(js.costs)),
            (ts.violations.numpy(), ts.costs.numpy()),
        )
    return out


@pytest.mark.parametrize("goal", GOALS)
def test_goal_matches_jax(goal, stacks):
    i = GOALS.index(goal)
    assert GOAL_REGISTRY[goal].hard == JAX_REGISTRY[goal].hard
    for case, ((jv, jc), (tv, tc)) in stacks.items():
        assert tv[i] == jv[i], (case, tv[i], jv[i])
        np.testing.assert_allclose(tc[i], jc[i], rtol=1e-5, atol=1e-6, err_msg=case)


def test_cases_exercise_most_goals(stacks):
    nonzero = set()
    for (jv, _), _t in stacks.values():
        nonzero.update(g for g, v in zip(GOALS, jv) if v > 0)
    assert len(nonzero) >= len(GOALS) - 4, sorted(set(GOALS) - nonzero)


def test_default_order_and_weights_match_jax():
    from ccx.goals.stack import DEFAULT_GOAL_ORDER as JAX_ORDER
    from ccx.goals.stack import soft_weights as jax_soft_weights

    assert DEFAULT_GOAL_ORDER == JAX_ORDER
    mask = tuple(GOAL_REGISTRY[n].hard for n in DEFAULT_GOAL_ORDER)
    np.testing.assert_array_equal(soft_weights(mask).numpy(), np.asarray(jax_soft_weights(mask)))
    assert GoalConfig() == GoalConfig(**{
        f: getattr(JaxGoalConfig(), f) for f in GoalConfig.__dataclass_fields__
    })
