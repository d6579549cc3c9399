"""The port's usage-coupled swap polish against the JAX package.

One iteration runs in both packages on the Gumbel uniforms JAX takes from
its keys (``greedy.py``: ``fold_in(key0, it)`` split into four); the
candidate partitions and slots and the state after the iteration must be
equal (floats within rtol 1e-5). A whole ``swap_polish`` run must keep
every broker's replica count exactly, never end lexicographically worse
than it started, and with the TRD guard never raise TopicReplicaDistribution.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccx.common.resources import Resource
from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.goals.stack import DEFAULT_GOAL_ORDER as GOALS
from ccx.model.fixtures import RandomClusterSpec, random_cluster
from ccx.search import greedy as jgreedy
from ccx.search import state as jst
from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.optimizer import _lex_better
from ccx_torch.search import greedy as tgreedy
from ccx_torch.search import state as tst
from test_torch_state import carry
from test_torch_swap import assert_chain_matches

SPEC = RandomClusterSpec(n_brokers=24, n_racks=4, n_topics=12, n_partitions=300,
                         n_dead_brokers=1, seed=21)
OPTS = dict(n_swap_candidates=16, n_lead_candidates=16, batch_moves=8, seed=3)


@functools.cache
def _jax_side():
    jm = random_cluster(SPEC)
    max_pt = jst.max_partitions_per_topic(jm)
    opts = jgreedy.SwapPolishOptions(**OPTS)
    state0 = jgreedy._descent_init(jm, jax.random.PRNGKey(opts.seed), goal_names=GOALS,
                                   cfg=JaxGoalConfig(), max_pt=max_pt)
    key0 = jax.random.PRNGKey(opts.seed + 1)
    _, body = jgreedy._make_swap_iter(
        jm, key0, jnp.int32(100), jnp.int32(100), jnp.asarray(True),
        goal_names=GOALS, cfg=JaxGoalConfig(), opts=opts, max_pt=max_pt,
    )
    return jm, state0, key0, jax.jit(body)


def _jax_uniforms(key0, it, P, N, D):
    k_gh, k_gc, k_gl, k_d = jax.random.split(jax.random.fold_in(key0, it), 4)

    def u(k, shape):
        return jax.random.uniform(k, shape, minval=1e-12, maxval=1.0)

    return (u(k_gh, (P,)), u(k_gc, (P,)), u(k_gl, (P,)),
            jax.vmap(lambda k: u(k, (2, D)))(jax.random.split(k_d, N)))


def _jax_candidates(js, jm, uniforms, k_sw, k_ld):
    """The JAX iteration's candidates (``_make_swap_iter``'s scoring and
    Gumbel top-k, on its state)."""
    B, R, P = jm.B, jm.R, jm.P
    press = jst.broker_pressure(jm, js.agg, JaxGoalConfig())
    uw = jst.usage_weights()
    u_lead_p, u_foll_p = uw @ jm.leader_load, uw @ jm.follower_load
    lbytes = jm.leader_load[Resource.NW_IN]
    n_valid = jnp.maximum(jnp.sum(jm.partition_valid), 1)
    avg_lb = jnp.sum(jnp.where(jm.partition_valid, lbytes, 0.0)) / n_valid
    a, lead = js.assignment, js.leader_slot
    valid = (a >= 0) & jm.partition_valid[:, None]
    movable = valid & ~jm.partition_immovable[:, None]
    b = jnp.clip(a, 0, B - 1)
    is_l = jnp.arange(R)[None, :] == lead[:, None]
    u = jnp.where(is_l, u_lead_p[:, None], u_foll_p[:, None])
    hot_sc = press.usage_over[b] * u * movable
    cold_sc = press.usage_under[b] * (1.0 / (1.0 + u)) * movable
    lsafe = jnp.clip(lead, 0, R - 1)
    lb = jnp.take_along_axis(b, lsafe[:, None], axis=1)[:, 0]
    has_lead = jnp.take_along_axis(valid, lsafe[:, None], axis=1)[:, 0]
    lead_allowed = jm.broker_valid & jm.broker_alive & ~jm.broker_excl_leadership
    dest_sc = (press.lead_under[b] + 0.3 * press.lbi_under[b]) * (movable & ~is_l & lead_allowed[b])
    u_delta = jnp.maximum(u_lead_p - u_foll_p, 0.0)
    avg_du = jnp.sum(jnp.where(jm.partition_valid, u_delta, 0.0)) / n_valid
    damp = 1.0 / (1.0 + u_delta / jnp.maximum(avg_du, 1e-9))
    lead_score = (
        (press.lead_over[lb] * damp + press.lbi_over[lb] * (lbytes / jnp.maximum(avg_lb, 1e-9)))
        * jnp.max(dest_sc, axis=1) * has_lead * movable[jnp.arange(P), lsafe]
    )

    def topk(score, k, uu):
        return jax.lax.top_k(jnp.log(score + 1e-12) - jnp.log(-jnp.log(uu)), k)[1]

    hot = topk(jnp.max(hot_sc, axis=1), k_sw, uniforms[0])
    cold = topk(jnp.max(cold_sc, axis=1), k_sw, uniforms[1])
    lead_ps = topk(lead_score, k_ld, uniforms[2])
    return (np.concatenate([hot, lead_ps]), np.concatenate([cold, lead_ps]),
            np.concatenate([jnp.argmax(hot_sc, 1)[hot], jnp.argmax(dest_sc, 1)[lead_ps]]),
            np.concatenate([jnp.argmax(cold_sc, 1)[cold], np.zeros(k_ld, np.int32)]))


def test_swap_polish_iterations_match_jax_given_its_draws():
    jm, js, key0, body = _jax_side()
    tm = carry(jm)
    step = tgreedy.SwapPolishIteration(tm, GoalConfig(), GOALS, tgreedy.SwapPolishOptions(**OPTS))
    ts = tst.init_search_state(tm, GoalConfig(), GOALS, group=step.group)
    assert_chain_matches(js, ts)
    carry_j = (js, jnp.int32(0), jnp.int32(0), jnp.int32(0))
    applied = 0
    for it in range(3):
        uniforms = _jax_uniforms(key0, it, tm.P, step.N, tm.D)
        d = tgreedy.SwapPolishDraws(*(torch.from_numpy(np.array(x)) for x in uniforms))
        got = step.candidates(ts, d)
        want = _jax_candidates(carry_j[0], jm, uniforms, step.k_sw, step.k_ld)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        n = step(ts, d, guard_on=True)
        carry_j = body(carry_j)
        assert int(carry_j[3]) - applied == n
        applied += n
        assert_chain_matches(carry_j[0], ts)
    assert applied > 0


@pytest.mark.parametrize("guard", [True, False])
def test_swap_polish_keeps_counts_and_never_regresses(guard):
    tm = carry(random_cluster(SPEC))
    cfg = GoalConfig()
    res = tgreedy.swap_polish(tm, cfg, GOALS, tgreedy.SwapPolishOptions(
        **OPTS, max_iters=25, trd_guard=guard))
    assert res.n_moves > 0 and res.n_iters > 0
    before, after = broker_aggregates(tm), broker_aggregates(res.model)
    assert torch.equal(before.replica_count, after.replica_count)
    assert not _lex_better(res.stack_before, res.stack_after)
    assert _lex_better(res.stack_after, res.stack_before)
    trd = GOALS.index("TopicReplicaDistributionGoal")
    if guard:
        assert float(res.stack_after.costs[trd]) <= float(res.stack_before.costs[trd]) * (1 + 1e-6) + 1e-6
    prop, acc = res.n_prop_kind, res.n_acc_kind
    assert prop[2] == acc[2] == 0 and acc[0] + acc[1] == res.n_moves
