"""The port's replica-exchange ladder against the JAX package.

* The ladder helpers (rungs, exponent fractions, end temperatures, the
  chain rounding) equal JAX's.
* ``exchange_permutation`` fed the uniforms ``jax.random.uniform`` draws
  from JAX's key gives JAX's permutation and attempted/accepted counts, on
  seeded cost vectors with hard tiers, for both parities.
* A sweep is an involution (hence a permutation); the lex-best chain never
  leaves the cold rung and is always promoted; hard tiers decide before the
  Metropolis test; remainder chains never move.
* With ``n_temps=1`` a chunked run equals the one-loop run exactly (any
  ``exchange_interval``), and the plateau exit still fires under the
  ladder.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccx.search import annealer as jann
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, soft_weights
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.search import annealer as tann

CFG = GoalConfig()
HARD = tuple(GOAL_REGISTRY[g].hard for g in DEFAULT_GOAL_ORDER)
SPEC = RandomClusterSpec(n_brokers=8, n_racks=4, n_topics=6, n_partitions=96, seed=11)


@pytest.mark.parametrize("K,n", [(1, 4), (2, 8), (4, 8), (4, 10), (3, 16)])
def test_ladder_helpers_equal_jax(K, n):
    np.testing.assert_array_equal(tann.ladder_rungs(K, n), jann.ladder_rungs(K, n))
    np.testing.assert_array_equal(tann.ladder_fracs(K, n), jann.ladder_fracs(K, n))
    for t0, t1 in ((0.3, 1e-4), (1e-8, 1e-9)):
        tops = tann.AnnealOptions(t0=t0, t1=t1, n_temps=K)
        jops = jann.AnnealOptions(t0=t0, t1=t1, n_temps=K)
        assert tann.ladder_end_temps(tops) == jann.ladder_end_temps(jops)
    for ranks in (1, 2, 3):
        assert tann.round_up_chains(n, ranks, "t", n_temps=K) == jann.round_up_chains(n, ranks, "t", n_temps=K)


def _costs(seed: int, n: int, hard_hits: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    G = len(HARD)
    cost = rng.uniform(0.0, 10.0, size=(n, G)).astype(np.float32)
    hard = np.asarray(HARD)
    cost[:, hard] = (rng.uniform(size=(n, int(hard.sum()))) > (0.85 if hard_hits else 2.0)).astype(np.float32)
    # soft ties between some pairs exercise the lex tie-break
    cost[3] = cost[1] if n > 3 else cost[0]
    return cost


@pytest.mark.parametrize("hard_hits", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K,n", [(2, 8), (4, 16), (4, 10)])
def test_exchange_permutation_equals_jax_on_its_uniforms(K, n, seed, hard_hits):
    cost = _costs(seed, n, hard_hits)
    fr = jann.ladder_fracs(K, n)
    temps = (0.3 * (1e-3 ** fr)).astype(np.float32)
    hard = np.asarray(HARD)
    w = soft_weights(HARD)
    for parity in (0, 1):
        key = jax.random.PRNGKey(seed * 10 + parity)
        jp, ja, jc = jann.exchange_permutation(
            jnp.asarray(cost), jnp.asarray(temps), key, n_temps=K,
            hard_arr=jnp.asarray(hard), weights=jnp.asarray(w.numpy()), parity=parity,
        )
        u = torch.from_numpy(np.array(jax.random.uniform(key, (n,), minval=1e-12, maxval=1.0)))
        tp, ta, tc = tann.exchange_permutation(
            torch.from_numpy(cost), torch.from_numpy(temps), u, n_temps=K,
            hard_arr=torch.from_numpy(hard), weights=w, parity=parity,
        )
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert (int(ta), int(tc)) == (int(ja), int(jc))


def _perm(cost, temps, *, n_temps, parity=0, hard=None, seed=0):
    n, G = cost.shape
    gen = torch.Generator().manual_seed(seed)
    perm, att, acc = tann.exchange_permutation(
        torch.as_tensor(cost, dtype=torch.float32), torch.as_tensor(temps, dtype=torch.float32),
        tann.draw_exchange(gen, n, "cpu"), n_temps=n_temps,
        hard_arr=torch.zeros(G, dtype=torch.bool) if hard is None else torch.tensor(hard),
        weights=torch.ones(G), parity=parity,
    )
    return perm.numpy(), int(att), int(acc)


TEMPS = np.repeat([0.001, 0.01, 0.1, 0.3], 2)


def test_exchange_is_an_involution_and_a_permutation():
    cost = np.random.default_rng(0).uniform(0.0, 10.0, size=(8, 3))
    for parity in (0, 1):
        for seed in range(5):
            perm, att, acc = _perm(cost, TEMPS, n_temps=4, parity=parity, seed=seed)
            assert sorted(perm) == list(range(8))
            np.testing.assert_array_equal(perm[perm], np.arange(8))
            assert acc <= att
    assert _perm(cost, TEMPS, n_temps=4, parity=0)[1] == 4
    assert _perm(cost, TEMPS, n_temps=4, parity=1)[1] == 2


def test_lex_best_never_leaves_the_cold_rung_and_is_promoted():
    cost = np.full((8, 3), 5.0)
    cost[0] = 0.0
    cost[1:] += np.arange(7)[:, None]
    for parity in (0, 1):
        for seed in range(8):
            assert _perm(cost, TEMPS, n_temps=4, parity=parity, seed=seed)[0][0] == 0
    cost = np.full((8, 3), 5.0)
    cost[2] = 0.0
    cost[[0, 1, 3, 4, 5, 6, 7]] += np.arange(7)[:, None]
    for seed in range(8):
        perm, _, acc = _perm(cost, TEMPS, n_temps=4, parity=0, seed=seed)
        assert perm[0] == 2 and perm[2] == 0 and acc >= 1


def test_hard_tiers_decide_before_metropolis():
    cost = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 9.0, 9.0], [1.0, 9.0, 9.0]])
    temps = np.array([0.001, 0.001, 0.3, 0.3])
    for seed in range(8):
        perm, _, _ = _perm(cost, temps, n_temps=2, parity=0, hard=[True, False, False], seed=seed)
        assert perm[0] == 2 and perm[2] == 0
        assert perm[1] == 1 and perm[3] == 3


def test_remainder_chains_sit_outside_the_ladder():
    cost = np.random.default_rng(1).uniform(0.0, 10.0, size=(10, 3))
    cost[8] = cost[9] = 0.0
    temps = np.concatenate([TEMPS, [0.3, 0.3]])
    for parity in (0, 1):
        for seed in range(4):
            perm, _, _ = _perm(cost, temps, n_temps=4, parity=parity, seed=seed)
            assert perm[8] == 8 and perm[9] == 9
            assert sorted(perm) == list(range(10))


@pytest.fixture(scope="module")
def model():
    return random_cluster(SPEC, device="cpu")


FLAT = tann.AnnealOptions(n_chains=4, n_steps=50, seed=3)


def test_k1_chunked_equals_one_loop_exactly(model):
    flat = tann.anneal(model, CFG, DEFAULT_GOAL_ORDER, FLAT)
    for chunk, interval in ((7, 3), (50, 1)):
        k1 = tann.anneal(model, CFG, DEFAULT_GOAL_ORDER, dataclasses.replace(
            FLAT, chunk_steps=chunk, n_temps=1, exchange_interval=interval))
        for f in ("assignment", "leader_slot", "replica_disk"):
            assert torch.equal(getattr(flat.model, f), getattr(k1.model, f)), f
        assert torch.equal(flat.stack_after.costs, k1.stack_after.costs)
        assert (flat.n_accepted, flat.n_prop_kind, flat.n_acc_kind) == (
            k1.n_accepted, k1.n_prop_kind, k1.n_acc_kind)
        assert k1.convergence["chunks"] == -(-FLAT.n_steps // chunk)
        assert "exchange" not in k1.convergence


def test_ladder_run_keeps_invariants_and_exchanges(model):
    res = tann.anneal(model, CFG, DEFAULT_GOAL_ORDER, dataclasses.replace(
        FLAT, n_chains=8, chunk_steps=10, n_temps=4))
    assert res.n_chains == 8
    assert float(res.stack_after.hard_violations) <= float(res.stack_before.hard_violations)
    # whole chains swap: every partition keeps its replication factor
    assert torch.equal((res.model.assignment >= 0).sum(1), (model.assignment >= 0).sum(1))
    ex = res.convergence["exchange"]
    assert sum(ex["attempted"]) > 0 and res.convergence["ladder"]["nTemps"] == 4


def test_plateau_exit_fires_under_the_ladder(model):
    res = tann.anneal(model, CFG, DEFAULT_GOAL_ORDER, dataclasses.replace(
        FLAT, n_chains=8, n_steps=1200, chunk_steps=20, n_temps=4, plateau_window=2))
    assert res.plateau is not None and res.plateau["exited"]
    assert res.plateau["chunksRun"] < res.plateau["chunksBudget"] == 60
