"""Every Propose option of the JAX sidecar on the port, on the CPU.

* ``options_from_wire`` takes every key of ``wire.PROPOSE_OPTION_KEYS`` at
  every value the JAX sidecar takes, refuses what it refuses, and lands each
  on the field the JAX sidecar lands it on.
* ``hard_repair``'s two backend names give bit-equal placements and equal
  move counts; an unknown name raises; the repair span names the backend.
* ``overlap_repair`` (JAX's ``test_optimize_overlap_repair_merges_and_verifies``
  rebuilt on the port): the overlapped run reaches zero hard violations,
  verifies and records both overlap phases; an exception in the repair
  thread surfaces on the join with its own traceback.
* ``GreedyOptions.swap_fraction``: polish iterations fed JAX's draws (its
  keys split in its order) give JAX's state, with and without pair
  candidates; with ``swap_fraction=0`` an iteration is bit-identical to the
  single-move iteration the port ran before pair candidates existed; a
  mixed run keeps the lexicographic order and proposes both swap kinds.
* ``IncrementalOptions`` defaults and ``configure`` match JAX's.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.goals.stack import DEFAULT_GOAL_ORDER as GOALS
from ccx.model.fixtures import RandomClusterSpec as JaxSpec
from ccx.model.fixtures import random_cluster as jax_random_cluster
from ccx.search import annealer as jann
from ccx.search import greedy as jgreedy
from ccx.search import incremental as jinc
from ccx.search import state as jst
from ccx_torch import optimizer as topt
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx_torch.optimizer import OptimizeOptions, _lex_better, optimize
from ccx_torch.search import annealer as tann
from ccx_torch.search import greedy as tgreedy
from ccx_torch.search import incremental as tinc
from ccx_torch.search import repair as trep
from ccx_torch.search import state as tst
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from ccx_torch.sidecar import wire
from ccx_torch.sidecar.server import options_from_wire
from test_torch_sidecar import _flat, _jax_opts
from test_torch_state import carry
from test_torch_swap import (
    _t,
    assert_chain_matches,
    jax_partition_draws,
    jax_single_draws,
    jax_swap_draws,
    to_draws,
)

#: values tried for every option key: the JAX sidecar takes some of them
#: for each key and refuses the rest
VALUES = (0, 3, 0.25, 1.5, True, False, "host", "device", "gpu", None, -1)


# ----- the wire options ------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(wire.PROPOSE_OPTION_KEYS))
def test_option_key_takes_every_value_the_jax_sidecar_takes(key, monkeypatch):
    base_j = _flat(_jax_opts({}, monkeypatch))
    base_t = _flat(options_from_wire({}, False))
    taken = 0
    for value in VALUES:
        try:
            want = _flat(_jax_opts({key: value}, monkeypatch))
        except (TypeError, ValueError):
            with pytest.raises((TypeError, ValueError)):
                options_from_wire({key: value}, False)
            continue
        got = _flat(options_from_wire({key: value}, False))
        changed_j = {k: v for k, v in want.items() if v != base_j[k]}
        changed_t = {k: v for k, v in got.items() if v != base_t[k]}
        assert changed_t == changed_j, (key, value)
        taken += 1
    assert taken > 0, key


def test_the_three_options_once_refused_land_on_their_fields():
    o = options_from_wire({"repair_backend": "host", "overlap_repair": True,
                           "polish_swap_fraction": 0.25}, False)
    assert (o.repair_backend, o.overlap_repair, o.polish.swap_fraction) == ("host", True, 0.25)
    with pytest.raises(ValueError, match="repair_backend"):
        options_from_wire({"repair_backend": "gpu"}, False)


# ----- the repair backends ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    bench_spec("B3"),
    RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=5, n_partitions=300,
                      n_dead_brokers=3, capacity_headroom=1.4, seed=8),
    RandomClusterSpec(n_brokers=16, n_racks=4, n_topics=6, n_partitions=150,
                      n_dead_brokers=3, seed=2),
], ids=["B3", "tight-capacity", "dead-brokers"])
def test_hard_repair_backends_are_bit_equal(spec):
    m = random_cluster(spec, device="cpu")
    out = {b: trep.hard_repair(m, GoalConfig(), GOALS, backend=b) for b in trep.REPAIR_BACKENDS}
    (host, n_host), (dev, n_dev) = out["host"], out["device"]
    assert n_host == n_dev > 0
    for f in ("assignment", "leader_slot", "replica_disk"):
        assert torch.equal(getattr(host, f), getattr(dev, f)), f
    with pytest.raises(ValueError, match="backend"):
        trep.hard_repair(m, GoalConfig(), GOALS, backend="gpu")


SMALL = RandomClusterSpec(n_brokers=12, n_racks=4, n_topics=6, n_partitions=96, seed=11,
                          n_dead_brokers=1)


def _overlap_opts(**kw) -> OptimizeOptions:
    return OptimizeOptions(
        anneal=AnnealOptions(n_chains=4, n_steps=100, moves_per_step=2, chunk_steps=50, seed=7),
        polish=GreedyOptions(n_candidates=64, max_iters=60),
        run_cold_greedy=False, topic_rebalance_rounds=0, **kw,
    )


@pytest.mark.parametrize("backend", ["device", "host"])
def test_repair_span_names_its_backend(backend):
    res = optimize(random_cluster(SMALL, device="cpu"), GoalConfig(), GOALS,
                   _overlap_opts(repair_backend=backend))
    repair = next(c for c in res.span_tree["children"] if c["name"] == "repair")
    counters = {"sweeps", "movedReplicas", "structuralOffenders"}
    assert {k: v for k, v in repair["attrs"].items() if k not in counters} == {
        "backend": backend, "overlap": False}
    assert counters <= set(repair["attrs"])
    assert "repair-join" not in res.phase_seconds


def test_optimize_overlap_repair_merges_and_verifies():
    res = optimize(random_cluster(SMALL, device="cpu"), GoalConfig(), GOALS,
                   _overlap_opts(overlap_repair=True))
    assert float(res.stack_after.hard_violations) == 0
    assert res.verification.ok, res.verification.failures
    assert "repair-join" in res.phase_seconds
    assert "repair-concurrent" in res.phase_seconds
    assert res.phase_seconds["repair"] < res.phase_seconds["anneal"] + 1.0
    repair = next(c for c in res.span_tree["children"] if c["name"] == "repair")
    assert repair["attrs"]["overlap"] is True
    assert "hot-list" not in res.phase_seconds


def test_overlap_needs_more_steps_than_one_chunk():
    opts = _overlap_opts(overlap_repair=True)
    opts = dataclasses.replace(opts, anneal=dataclasses.replace(opts.anneal, n_steps=50))
    m = random_cluster(SMALL, device="cpu")
    res = optimize(m, GoalConfig(), GOALS, opts)
    plain = optimize(m, GoalConfig(), GOALS, dataclasses.replace(opts, overlap_repair=False))
    assert "repair-join" not in res.phase_seconds
    # skipped: the run is the plain pipeline's, placement for placement
    for f in ("assignment", "leader_slot", "replica_disk"):
        assert torch.equal(getattr(res.model, f), getattr(plain.model, f)), f


def test_an_exception_in_the_repair_thread_surfaces_on_join(monkeypatch):
    def boom_repair(*args, **kwargs):
        raise RuntimeError("repair thread failed")

    monkeypatch.setattr(topt, "hard_repair_counted", boom_repair)
    with pytest.raises(RuntimeError, match="repair thread failed") as e:
        optimize(random_cluster(SMALL, device="cpu"), GoalConfig(), GOALS,
                 _overlap_opts(overlap_repair=True))
    assert any(entry.name == "boom_repair" for entry in e.traceback)


# ----- the mixed-proposal polish ---------------------------------------------------


PSPEC = dict(n_brokers=24, n_racks=4, n_topics=12, n_partitions=300, n_dead_brokers=1, seed=21)


@functools.cache
def _jax_polish(swap_fraction: float):
    """JAX's polish body at ``swap_fraction`` and its start (built once)."""
    jm = jax_random_cluster(JaxSpec(**PSPEC))
    opts = jgreedy.GreedyOptions(n_candidates=32, batch_moves=8, swap_fraction=swap_fraction,
                                 seed=3)
    tm = carry(jm)
    tpp = tgreedy.polish_params(tm, GoalConfig(), GOALS, GreedyOptions(
        n_candidates=32, batch_moves=8, swap_fraction=swap_fraction, seed=3))
    jfields = {f.name for f in dataclasses.fields(jann.ProposalParams)}
    jpp = jann.ProposalParams(**{k: v for k, v in dataclasses.asdict(tpp).items() if k in jfields})
    evac, n_evac = jann.hot_partition_list(jm, GOALS, JaxGoalConfig())
    max_pt = jst.max_partitions_per_topic(jm)
    state0 = jgreedy._descent_init(jm, jax.random.PRNGKey(opts.seed), goal_names=GOALS,
                                   cfg=JaxGoalConfig(), max_pt=max_pt)
    key0 = jax.random.PRNGKey(opts.seed + 1)
    _, body = jgreedy._make_greedy_iter(
        jm, jnp.asarray(evac), jnp.asarray(n_evac, jnp.int32), key0, jnp.int32(100),
        jnp.int32(100), jnp.asarray(False), goal_names=GOALS, cfg=JaxGoalConfig(), pp=jpp,
        opts=opts, max_pt=max_pt,
    )
    return jm, state0, key0, jax.jit(body), jpp, int(n_evac)


def _jax_polish_draws(key0, it, n_single, n_swap, jm, jpp, n_evac) -> tgreedy.PolishDraws:
    """One iteration's draws, re-derived from JAX's keys in its split order
    (``greedy._make_greedy_iter``: ``fold_in(key0, it)`` split into the
    singles' keys, then the swaps')."""
    keys = jax.random.split(jax.random.fold_in(key0, it), n_single + max(n_swap, 1))

    def single(k):
        k_plan, k_p, k_ev, k_evi = jax.random.split(k, 4)
        return dict(part=jax_partition_draws(k_p, k_ev, k_evi, jpp, n_evac),
                    single=jax_single_draws(k_plan, jm, jpp))

    def swap(k):
        k_p1, k_p2, k_plan = jax.random.split(k, 3)
        return dict(p1=jax.random.randint(k_p1, (), 0, jpp.p_real),
                    p2=jax.random.randint(k_p2, (), 0, jpp.p_real),
                    plan=jax_swap_draws(k_plan, jm))

    s = jax.vmap(single)(keys[:n_single])
    d = tgreedy.PolishDraws(part=to_draws(tann.PartitionDraws, s["part"], (n_single,)),
                            single=to_draws(tann.SingleDraws, s["single"], (n_single,)))
    if n_swap:
        w = jax.vmap(swap)(keys[n_single:])
        d.swap = tann.SwapProposalDraws(p1=_t(w["p1"]), p2=_t(w["p2"]),
                                        plan=to_draws(tann.SwapDraws, w["plan"], (n_swap,)))
    return d


@pytest.mark.parametrize("swap_fraction", [0.25, 0.0])
def test_polish_iterations_match_jax_given_its_draws(swap_fraction):
    jm, js, key0, body, jpp, n_evac = _jax_polish(swap_fraction)
    tm = carry(jm)
    cfg = GoalConfig()
    opts = GreedyOptions(n_candidates=32, batch_moves=8, swap_fraction=swap_fraction, seed=3)
    pp = tgreedy.polish_params(tm, cfg, GOALS, opts)
    evac, tn = tann.hot_partition_list(tm, GOALS, cfg)
    assert tn == n_evac
    group = tst.make_topic_group(tm, tst.max_partitions_per_topic(tm))
    step = tgreedy.PolishIteration(tm, cfg, GOALS, opts, pp, evac, tn, False, group)
    assert (step.n_single, step.n_swap) == ((24, 8) if swap_fraction else (32, 0))
    ts = tst.init_search_state(tm, cfg, GOALS, group=group)
    assert_chain_matches(js, ts)
    carry_j = (js, jnp.int32(0), jnp.int32(0), jnp.int32(0))
    live = torch.ones((), dtype=torch.bool)
    applied = 0
    for it in range(3):
        d = _jax_polish_draws(key0, it, step.n_single, step.n_swap, jm, jpp, n_evac)
        n = int(step(ts, d, live))
        carry_j = body(carry_j)
        assert int(carry_j[3]) - applied == n
        applied += n
        assert_chain_matches(carry_j[0], ts)
    assert applied > 0
    if swap_fraction:
        prop = ts.n_prop_kind[0].tolist()
        assert prop[0] == 3 * step.n_single and prop[1] + prop[2] == 3 * step.n_swap
        assert prop[1] > 0 and prop[2] > 0


def _single_move_iteration(ss, m, cfg, opts, gen, evac, n_evac, group, live):
    """The polish iteration as the port ran it before pair candidates (the
    reference for ``swap_fraction=0``)."""
    p_real, b_real = tann.real_sizes(m)
    pp = tann.ProposalParams(
        p_real=p_real, b_real=b_real, p_leadership=opts.p_leadership, p_disk=opts.p_disk,
        p_biased_dest=opts.p_biased_dest, p_evac=opts.p_evac,
        target_rack=bool(tann.RACK_TARGET_GOALS & set(GOALS)), allow_inter=True,
        target_capacity=bool(tann.CAPACITY_GOALS & set(GOALS)),
        cap_thresholds=tuple(cfg.capacity_threshold),
    )
    N = max(opts.n_candidates, 1)
    chain = torch.zeros(N, dtype=torch.long)
    ps, use_evac = tann._draw_partition(tann.draw_partitions(gen, N, pp, n_evac, m.device), pp,
                                        evac, n_evac)
    view = tst.gather_views(ss, m, chain, ps)
    old, new, feas = tann._single_plan(tann.draw_single(gen, N, m, pp), ss, chain, m, pp, view,
                                       use_evac)
    deltas = tst.make_move_scorer(m, GOALS, cfg)(ss, chain, view, old, new)
    hard_arr = torch.tensor([GOAL_REGISTRY[g].hard for g in GOALS])
    guard_cols = torch.tensor([g == "TopicReplicaDistributionGoal" for g in GOALS])
    _, write_a = tgreedy._descend(
        ss, m, group, tgreedy.Pairs(pa=ps, va=view, olda=old, newa=new, deltas=deltas), feas,
        hard_arr, False, guard_cols, tst.make_cost_vector_fn(m, GOALS, cfg),
        max(min(opts.batch_moves, N), 1), dual=None, live=live,
    )
    n_acc = write_a.sum().int()
    tst.bump_kind_counters(ss, chain[:1], tst.KIND_SINGLE, (live.int() * N).reshape(1),
                           n_acc.reshape(1))
    return n_acc


def test_swap_fraction_zero_keeps_the_single_move_iteration():
    m = random_cluster(RandomClusterSpec(**PSPEC), device="cpu")
    cfg = GoalConfig()
    opts = GreedyOptions(n_candidates=32, batch_moves=8, seed=3)
    evac, n_evac = tann.hot_partition_list(m, GOALS, cfg)
    group = tst.make_topic_group(m, tst.max_partitions_per_topic(m))
    step = tgreedy.PolishIteration(m, cfg, GOALS, opts, tgreedy.polish_params(m, cfg, GOALS, opts),
                                   evac, n_evac, False, group)
    live = torch.ones((), dtype=torch.bool)
    states, gens = [], []
    for _ in range(2):
        states.append(tst.init_search_state(m, cfg, GOALS, group=group))
        gens.append(torch.Generator().manual_seed(4))
    for _ in range(4):
        n_new = step(states[0], step.draw(gens[0]), live)
        n_old = _single_move_iteration(states[1], m, cfg, opts, gens[1], evac, n_evac, group, live)
        assert int(n_new) == int(n_old)
    for f in ("assignment", "leader_slot", "replica_disk", "cost_vec", "part_sums", "n_prop_kind",
              "n_acc_kind", "n_accepted"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f
    assert int(states[0].n_accepted.sum()) > 0


def test_mixed_polish_run_keeps_the_lex_order_and_proposes_both_swap_kinds():
    m = random_cluster(RandomClusterSpec(**PSPEC), device="cpu")
    res = tgreedy.greedy_optimize(m, GoalConfig(), GOALS, GreedyOptions(
        n_candidates=32, max_iters=12, batch_moves=8, swap_fraction=0.25, chunk_iters=4, seed=5))
    assert not _lex_better(res.stack_before, res.stack_after)
    assert float(res.stack_after.hard_violations) <= float(res.stack_before.hard_violations)
    prop, acc = res.n_prop_kind, res.n_acc_kind
    assert prop[0] == 24 * res.n_iters and prop[1] > 0 and prop[2] > 0
    assert sum(acc) == res.n_moves > 0
    lead = tgreedy.greedy_optimize(m, GoalConfig(), GOALS, GreedyOptions(
        n_candidates=32, max_iters=4, swap_fraction=0.25, leadership_only=True, seed=5))
    # in leadership-only mode every swap is a leadership rotation
    assert lead.n_prop_kind[1] == 0 and lead.n_prop_kind[2] == 8 * lead.n_iters
    assert torch.equal(lead.model.assignment.sort(1).values, m.assignment.sort(1).values)


# ----- the warm store's cap --------------------------------------------------------


def test_incremental_options_and_configure_match_jax():
    assert dataclasses.asdict(tinc.IncrementalOptions()) == dataclasses.asdict(jinc.IncrementalOptions())
    assert tinc.IncrementalOptions().max_sessions == jinc.STORE.max_sessions == 32
    was = tinc.STORE.max_sessions
    try:
        for value in (5, None, 0):
            tinc.configure(max_sessions=value)
            jinc.configure(max_sessions=value)
            assert tinc.STORE.max_sessions == jinc.STORE.max_sessions == 5
    finally:
        tinc.configure(max_sessions=was)
        jinc.configure(max_sessions=was)
