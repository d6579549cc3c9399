"""The port's incremental search state against the JAX package.

Both packages start from the identical cluster (carried with
``model_from_arrays``). Moves are chosen with numpy — replica relocations,
leadership transfers and intra-broker disk moves — and handed to both
scorers and both ``apply_move``s; the scored cost vectors and the state
after each application must agree (counts and integer accumulators exactly,
float costs within rtol 1e-5: the aggregate float sums are taken in another
order). ``lex_accept`` gets the very uniform JAX drew from its key.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.goals.stack import DEFAULT_GOAL_ORDER as JAX_ORDER
from ccx.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx.search import annealer as jann
from ccx.search import state as jst
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.search import annealer as tann
from ccx_torch.search import state as tst
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays

JBOD_GOALS = DEFAULT_GOAL_ORDER + ("IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal")
CASES = {
    "dead-brokers": (RandomClusterSpec(
        n_brokers=16, n_racks=4, n_topics=8, n_partitions=200, n_dead_brokers=2, seed=5
    ), DEFAULT_GOAL_ORDER),
    "jbod": (bench_spec("B4"), JBOD_GOALS),
}


def carry(jm):
    arrays = {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}
    return model_from_arrays(arrays, jm.num_topics, jm.num_racks, "cpu")


@functools.cache
def _jax_states(case):
    """The JAX side of ``_states`` (immutable, so built once per process)."""
    spec, goals = CASES[case]
    jm = random_cluster(spec)
    max_pt = jst.max_partitions_per_topic(jm)
    jgroup = jax.jit(jst.make_topic_group, static_argnums=1)(jm, max_pt)
    js = jax.jit(
        lambda m, k, g: jst.init_search_state(m, JaxGoalConfig(), goals, k, group=g)
    )(jm, jax.random.PRNGKey(0), jgroup)
    return jm, goals, max_pt, jgroup, js


def _states(case):
    jm, goals, max_pt, jgroup, js = _jax_states(case)
    tm = carry(jm)
    assert tst.max_partitions_per_topic(tm) == max_pt
    tgroup = tst.make_topic_group(tm, max_pt)
    np.testing.assert_array_equal(tgroup.members.numpy(), np.asarray(jgroup.members))
    np.testing.assert_array_equal(tgroup.member_slot.numpy(), np.asarray(jgroup.member_slot))
    ts = tst.init_search_state(tm, GoalConfig(), goals, group=tgroup)
    return jm, tm, goals, jgroup, tgroup, js, ts


def _assert_states_match(js, ts):
    np.testing.assert_array_equal(ts.assignment[0].numpy(), np.asarray(js.assignment))
    np.testing.assert_array_equal(ts.leader_slot[0].numpy(), np.asarray(js.leader_slot))
    np.testing.assert_array_equal(ts.replica_disk[0].numpy(), np.asarray(js.replica_disk))
    np.testing.assert_array_equal(ts.grouped_assign[0].numpy(), np.asarray(js.grouped_assign))
    np.testing.assert_array_equal(ts.grouped_leader[0].numpy(), np.asarray(js.grouped_leader))
    for f in ("part_sums", "topic_totals", "mtl_sum", "trd_sum"):
        np.testing.assert_array_equal(getattr(ts, f)[0].numpy(), np.asarray(getattr(js, f)), err_msg=f)
    for f in ("replica_count", "leader_count"):
        np.testing.assert_array_equal(getattr(ts.agg, f)[0].numpy(), np.asarray(getattr(js.agg, f)))
    for f in ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load"):
        np.testing.assert_allclose(
            getattr(ts.agg, f)[0].numpy(), np.asarray(getattr(js.agg, f)), rtol=1e-5, atol=1e-3
        )
    np.testing.assert_allclose(ts.cost_vec[0].numpy(), np.asarray(js.cost_vec), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_init_search_state_matches_jax(case):
    *_, js, ts = _states(case)
    _assert_states_match(js, ts)
    assert ts.hard_mask == js.hard_mask


def _choose_move(rng, m, row, leader, disk, kind):
    """A numpy-chosen move of ``kind`` on one partition's rows, or None."""
    valid = np.nonzero(row >= 0)[0]
    new_row, new_leader, new_disk = row.copy(), leader, disk.copy()
    if kind == "replica":
        r = int(rng.choice(valid))
        free = np.setdiff1d(np.arange(m.B)[np.asarray(m.broker_valid)], row)
        new_row[r] = int(rng.choice(free))
        new_disk[r] = int(rng.integers(0, m.D))
    elif kind == "leadership":
        others = [int(s) for s in valid if s != leader]
        if not others:
            return None
        new_leader = int(rng.choice(others))
    else:
        r = int(rng.choice(valid))
        new_disk[r] = (disk[r] + 1 + int(rng.integers(0, m.D - 1))) % m.D
    return new_row.astype(np.int32), np.int32(new_leader), new_disk.astype(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_scorer_and_apply_move_match_jax(case):
    jm, tm, goals, jgroup, tgroup, js, ts = _states(case)
    jcfg, tcfg = JaxGoalConfig(), GoalConfig()
    jscore = jst.make_move_scorer(jm, goals, jcfg)
    tscore = tst.make_move_scorer(tm, goals, tcfg)
    rng = np.random.default_rng(1)
    p_real = int(np.asarray(jm.partition_valid).sum())
    kinds = ["replica", "leadership"] + (["disk"] if jm.D > 1 else [])
    zero = torch.zeros(1, dtype=torch.long)
    n_checked = 0
    for i in range(24):
        kind = kinds[i % len(kinds)]
        p = int(rng.integers(0, p_real))
        row = np.asarray(js.assignment[p])
        move = _choose_move(rng, jm, row, int(js.leader_slot[p]), np.asarray(js.replica_disk[p]), kind)
        if move is None:
            continue
        accept = bool(i % 5 != 4)   # every fifth move is scored and rejected
        jview = jst.gather_view(js, jm, jnp.int32(p))
        jold = (jview.assign, jview.leader, jview.disk)
        jnew = tuple(jnp.asarray(x) for x in move)
        jd = jscore(js, jview, jold, jnew)
        js = jst.apply_move(js, jm, jnp.int32(p), jview, jold, jnew, jd, jnp.asarray(accept), group=jgroup)

        tp = torch.tensor([p])
        tview = tst.gather_views(ts, tm, zero, tp)
        told = (tview.assign, tview.leader, tview.disk)
        tnew = (torch.from_numpy(move[0])[None], torch.tensor([int(move[1])], dtype=torch.int32),
                torch.from_numpy(move[2])[None])
        td = tscore(ts, zero, tview, told, tnew)
        np.testing.assert_allclose(td.cost_vec[0].numpy(), np.asarray(jd.cost_vec), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(td.part_sums[0].numpy(), np.asarray(jd.part_sums))
        for f in ("d_mtl", "d_trd", "d_total"):
            assert float(getattr(td, f)[0]) == float(getattr(jd, f)), f
        tst.apply_move(ts, tm, zero, tp, tview, told, tnew, td, torch.tensor([accept]), group=tgroup)
        _assert_states_match(js, ts)
        n_checked += 1
    assert n_checked >= 18


@pytest.mark.parametrize("case", list(CASES))
def test_broker_pressure_matches_jax(case):
    jm, tm, goals, _, _, js, ts = _states(case)
    want = jst.broker_pressure(jm, js.agg, JaxGoalConfig())
    got = tst.broker_pressure(tm, ts.agg, GoalConfig())
    for f in ("usage_over", "usage_under", "lead_over", "lead_under", "lbi_over", "lbi_under"):
        np.testing.assert_allclose(
            getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-6, err_msg=f
        )


def test_lex_accept_matches_jax_given_its_uniform():
    rng = np.random.default_rng(3)
    hard = np.array([True, True, False, False, False, False])
    weights = np.array(jann.soft_weights(tuple(hard)))
    n = 64
    cur = rng.random((n, 6)).astype(np.float32)
    step = rng.normal(0, 0.05, (n, 6)).astype(np.float32)
    step[rng.random((n, 6)) < 0.5] = 0.0       # untouched goals
    new = cur + step
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    temps = np.geomspace(0.3, 1e-4, n)
    want = [
        bool(jann.lex_accept(jnp.asarray(cur[i]), jnp.asarray(new[i]), jnp.asarray(hard),
                             jnp.asarray(weights), jnp.float32(temps[i]), keys[i]))
        for i in range(n)
    ]
    got = []
    for i in range(n):
        u = float(jax.random.uniform(keys[i], minval=1e-12, maxval=1.0))
        got.append(bool(tann.lex_accept(
            torch.from_numpy(cur[i:i + 1]), torch.from_numpy(new[i:i + 1]),
            torch.from_numpy(hard), torch.from_numpy(weights), float(temps[i]),
            torch.tensor([u], dtype=torch.float32),
        )[0]))
    assert got == want
    assert 0 < sum(want) < n


def test_goal_tols_and_order_match_jax():
    v = np.array([0.0, 1.0, 1e6, 3.5], np.float32)
    np.testing.assert_array_equal(
        tann.goal_tols(torch.from_numpy(v)).numpy(), np.asarray(jann.goal_tols(jnp.asarray(v)))
    )
    assert DEFAULT_GOAL_ORDER == JAX_ORDER
