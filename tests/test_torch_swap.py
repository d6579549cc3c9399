"""The port's two-partition swap engine against the JAX package.

Both packages start from the identical cluster (carried with
``model_from_arrays``). Swap candidates chosen with numpy go through both
swap scorers and both ``apply_swap``s; the swap plan, the sequential
two-partition SA step and the batched SA step run in both packages on the
very draws JAX takes from its keys, re-derived here in JAX's split order.
Placements, the topic-grouped mirror, integer aggregates and counters must
be equal; float costs agree within rtol 1e-5 / atol 1e-6 and float
aggregates within rtol 1e-5 / atol 1e-3 (sums taken in another order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.goals.stack import DEFAULT_GOAL_ORDER as JAX_ORDER
from ccx.model.fixtures import RandomClusterSpec, random_cluster
from ccx.search import annealer as jann
from ccx.search import state as jst
from ccx_torch.goals.base import GoalConfig
from ccx_torch.search import annealer as tann
from ccx_torch.search import state as tst
from test_torch_state import CASES, _states, carry

STEP_IDX, TEMP = 7, 0.3
#: wide enough for the batched engine at 4 moves per step (64 >= 4 * R * 4)
WIDE = RandomClusterSpec(n_brokers=64, n_racks=8, n_topics=16, n_partitions=400,
                         n_dead_brokers=2, seed=11)


def assert_chain_matches(js, ts, c: int = 0) -> None:
    """Chain ``c`` of the port's state against one JAX chain state."""
    for f in ("assignment", "leader_slot", "replica_disk", "grouped_assign", "grouped_leader",
              "part_sums", "topic_totals", "mtl_sum", "trd_sum", "n_accepted",
              "n_prop_kind", "n_acc_kind"):
        np.testing.assert_array_equal(getattr(ts, f)[c].numpy(), np.asarray(getattr(js, f)), err_msg=f)
    for f in ("replica_count", "leader_count"):
        np.testing.assert_array_equal(getattr(ts.agg, f)[c].numpy(), np.asarray(getattr(js.agg, f)), err_msg=f)
    for f in ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load"):
        np.testing.assert_allclose(getattr(ts.agg, f)[c].numpy(), np.asarray(getattr(js.agg, f)),
                                   rtol=1e-5, atol=1e-3, err_msg=f)
    np.testing.assert_allclose(ts.cost_vec[c].numpy(), np.asarray(js.cost_vec), rtol=1e-5, atol=1e-6)


def _t(x, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x)) if dtype is None else torch.from_numpy(np.array(x)).to(dtype)


# --------------------------------------------------------------------------
# (a) the swap scorer and apply_swap on hand-picked candidates
# --------------------------------------------------------------------------


def _swap_rows(rng, jm, js, kind, p1, p2):
    """Old and new rows of both partitions for a candidate of ``kind``, or
    None where the pair admits none."""
    a1, a2 = np.asarray(js.assignment[p1]), np.asarray(js.assignment[p2])
    l1, l2 = int(js.leader_slot[p1]), int(js.leader_slot[p2])
    d1, d2 = np.asarray(js.replica_disk[p1]), np.asarray(js.replica_disk[p2])
    n1, n2 = a1.copy(), a2.copy()
    nd1, nd2 = d1.copy(), d2.copy()
    nl1, nl2 = l1, l2
    if kind in ("replica", "same-topic"):
        pairs = [(r1, r2) for r1 in np.nonzero(a1 >= 0)[0] for r2 in np.nonzero(a2 >= 0)[0]
                 if a1[r1] != a2[r2] and a2[r2] not in a1 and a1[r1] not in a2]
        if not pairs:
            return None
        r1, r2 = pairs[int(rng.integers(len(pairs)))]
        n1[r1], n2[r2] = a2[r2], a1[r1]
        nd1[r1], nd2[r2] = int(rng.integers(jm.D)), int(rng.integers(jm.D))
    elif kind == "leadership":
        o1 = [s for s in np.nonzero(a1 >= 0)[0] if s != l1]
        o2 = [s for s in np.nonzero(a2 >= 0)[0] if s != l2]
        if not o1 or not o2:
            return None
        nl1, nl2 = int(rng.choice(o1)), int(rng.choice(o2))
    else:   # inert partner: a single replica move of p1
        free = np.setdiff1d(np.arange(jm.B)[np.asarray(jm.broker_valid)], a1)
        r1 = int(rng.choice(np.nonzero(a1 >= 0)[0]))
        n1[r1] = int(rng.choice(free))
        neg = np.full_like(a2, -1)
        return ((a1, l1, d1), (n1, l1, nd1), (neg, -1, neg), (neg, -1, neg))
    return ((a1, l1, d1), (n1, nl1, nd1), (a2, l2, d2), (n2, nl2, nd2))


def _as_jax(rows):
    return tuple(jnp.asarray(x, jnp.int32) for x in rows)


def _as_torch(rows):
    return (_t(rows[0], torch.int32)[None], torch.tensor([rows[1]], dtype=torch.int32),
            _t(rows[2], torch.int32)[None])


@pytest.mark.parametrize("case", list(CASES))
def test_swap_scorer_and_apply_swap_match_jax(case):
    jm, tm, goals, jgroup, tgroup, js, ts = _states(case)
    jscore = jax.jit(jst.make_swap_scorer(jm, goals, JaxGoalConfig()))
    japply = jax.jit(jst.apply_swap)
    tscore = tst.make_swap_scorer(tm, goals, GoalConfig())
    rng = np.random.default_rng(2)
    p_real = int(np.asarray(jm.partition_valid).sum())
    topic = np.asarray(jm.partition_topic)
    zero = torch.zeros(1, dtype=torch.long)
    kinds = ["replica", "same-topic", "leadership", "inert", "inert-same"]
    seen = dict.fromkeys(kinds, 0)
    for i in range(30):
        kind = kinds[i % len(kinds)]
        p1 = int(rng.integers(p_real))
        if kind == "same-topic":
            mates = np.nonzero((topic[:p_real] == topic[p1]) & (np.arange(p_real) != p1))[0]
            if not mates.size:
                continue
            p2 = int(rng.choice(mates))
        elif kind == "inert-same":
            p2 = p1     # a single move whose inert partner is drawn equal to it
        else:
            p2 = int(rng.integers(p_real))
        rows = _swap_rows(rng, jm, js, kind, p1, p2)
        if rows is None or p1 == p2 and kind != "inert-same":
            continue
        accept = bool(i % 4 != 3)
        active2 = not kind.startswith("inert")
        jv1, jv2 = jst.gather_view(js, jm, jnp.int32(p1)), jst.gather_view(js, jm, jnp.int32(p2))
        jrows = [_as_jax(r) for r in rows]
        jd = jscore(js, jv1, jrows[0], jrows[1], jv2, jrows[2], jrows[3])
        js = japply(js, jm, jnp.int32(p1), jv1, jrows[0], jrows[1], jnp.int32(p2), jv2,
                            jrows[2], jrows[3], jd, jnp.asarray(accept), group=jgroup,
                            active2=jnp.asarray(active2))

        tp1, tp2 = torch.tensor([p1]), torch.tensor([p2])
        tv1, tv2 = tst.gather_views(ts, tm, zero, tp1), tst.gather_views(ts, tm, zero, tp2)
        trows = [_as_torch(r) for r in rows]
        td = tscore(ts, zero, tv1, trows[0], trows[1], tv2, trows[2], trows[3])
        np.testing.assert_allclose(td.cost_vec[0].numpy(), np.asarray(jd.cost_vec), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(td.part_sums[0].numpy(), np.asarray(jd.part_sums))
        for f in ("d_mtl", "d_trd", "d_total", "d_total2"):
            assert float(getattr(td, f)[0]) == float(getattr(jd, f)), f
        tst.apply_swap(ts, tm, zero, tp1, tv1, trows[0], trows[1], tp2, tv2, trows[2], trows[3],
                       td, torch.tensor([accept]), group=tgroup, active2=torch.tensor([active2]))
        assert_chain_matches(js, ts)
        seen[kind] += 1
    assert all(n >= 3 for n in seen.values()), seen


# --------------------------------------------------------------------------
# JAX's draws, re-derived from its keys in its split order
# --------------------------------------------------------------------------


def _uniform_lo(k, shape=()):
    return jax.random.uniform(k, shape, minval=1e-12, maxval=1.0)


def jax_single_draws(k, m, pp) -> dict:
    """``_single_plan``'s draws (``annealer.py``: split into 7 keys)."""
    k_kind, k_r, k_dst, k_dstu, k_disk, k_bias, k_pref = jax.random.split(k, 7)
    p_cuml = jnp.cumsum(jnp.asarray([1.0 - pp.p_leadership - pp.p_disk, pp.p_leadership, pp.p_disk]))
    return dict(
        # jax.random.choice's uniform, scaled as choice scales it
        u_kind=p_cuml[-1] * (1 - jax.random.uniform(k_kind, (), dtype=p_cuml.dtype)),
        r=jax.random.randint(k_r, (), 0, m.R),
        u_prefer=jax.random.uniform(k_pref),
        u_dst=_uniform_lo(k_dst, (m.B,)),
        dst_uniform=jax.random.randint(k_dstu, (), 0, pp.b_real),
        u_bias=jax.random.uniform(k_bias),
        u_disk=_uniform_lo(k_disk, (m.D,)),
    )


def jax_swap_draws(k, m) -> dict:
    """``_swap_plan``'s draws (split into 5 keys)."""
    k_r1, k_r2, k_d1, k_d2, k_kind = jax.random.split(k, 5)
    return dict(
        r1=jax.random.randint(k_r1, (), 0, m.R), r2=jax.random.randint(k_r2, (), 0, m.R),
        u_d1=_uniform_lo(k_d1, (m.D,)), u_d2=_uniform_lo(k_d2, (m.D,)),
        u_kind=jax.random.uniform(k_kind),
    )


def jax_partition_draws(k_p, k_ev, k_evi, pp, n_evac) -> dict:
    return dict(
        p=jax.random.randint(k_p, (), 0, pp.p_real),
        u_evac=jax.random.uniform(k_ev),
        evac_i=jax.random.randint(k_evi, (), 0, max(n_evac, 1)),
    )


def to_draws(cls, d: dict, lead: tuple = ()):
    """A port draws dataclass from stacked JAX arrays (leading axes
    ``lead`` flattened into one)."""
    out = {}
    for f in dataclasses.fields(cls):
        x = np.asarray(d[f.name])
        out[f.name] = torch.from_numpy(x.reshape((-1,) + x.shape[len(lead):]).copy())
    return cls(**out)


def _pp_pair(jm, tm, opts, goals):
    p_real, b_real = tann.real_sizes(tm)
    tpp = tann.proposal_params(opts, goals, GoalConfig(), p_real, b_real)
    jfields = {f.name for f in dataclasses.fields(jann.ProposalParams)}
    jpp = jann.ProposalParams(**{k: v for k, v in dataclasses.asdict(tpp).items() if k in jfields})
    return jpp, tpp


# --------------------------------------------------------------------------
# (b) the swap plan on JAX's own draws
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["drawn", "given-lead", "coupled"])
@pytest.mark.parametrize("case", list(CASES))
def test_swap_plan_matches_jax_given_its_draws(case, variant):
    jm, tm, goals, _, _, js, ts = _states(case)
    jpp, tpp = _pp_pair(jm, tm, tann.AnnealOptions(), goals)
    K = 96
    keys = jax.random.split(jax.random.PRNGKey(4), K)
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, jpp.p_real, K).astype(np.int32)
    p2 = rng.integers(0, jpp.p_real, K).astype(np.int32)
    p2[:8] = p1[:8]                        # equal partitions are infeasible
    # partners that admit a leadership rotation: p2 has a replica on p1's
    # leader broker and p1 one on p2's
    a = np.asarray(js.assignment)[:jpp.p_real]
    lb = a[np.arange(jpp.p_real), np.asarray(js.leader_slot)[:jpp.p_real]]
    for i in range(8, 40):
        fits = np.nonzero((a == lb[p1[i]]).any(1) & (a[p1[i]] == lb[:, None]).any(1)
                          & (lb != lb[p1[i]]))[0]
        if fits.size:
            p2[i] = rng.choice(fits)
    use_lead = rng.random(K) < 0.5
    use_couple = rng.random(K) < 0.5
    r1c = rng.integers(0, jm.R, K).astype(np.int32)
    r2c = rng.integers(0, jm.R, K).astype(np.int32)

    def one(k, a, b, ul, uc, x1, x2):
        v1, v2 = jst.gather_view(js, jm, a), jst.gather_view(js, jm, b)
        kw = {}
        if variant != "drawn":
            kw["use_lead"] = ul
        if variant == "coupled":
            kw["couple"] = (uc, x1, x2)
        return jann._swap_plan(k, jm, jpp, a, v1, b, v2, **kw)

    want = jax.vmap(one)(keys, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(use_lead),
                         jnp.asarray(use_couple), jnp.asarray(r1c), jnp.asarray(r2c))
    d = to_draws(tann.SwapDraws, jax.vmap(lambda k: jax_swap_draws(k, jm))(keys), (K,))
    zero = torch.zeros(K, dtype=torch.long)
    tp1, tp2 = torch.from_numpy(p1).long(), torch.from_numpy(p2).long()
    v1, v2 = tst.gather_views(ts, tm, zero, tp1), tst.gather_views(ts, tm, zero, tp2)
    kw = {}
    if variant != "drawn":
        kw["use_lead"] = torch.from_numpy(use_lead)
    if variant == "coupled":
        kw["couple"] = (torch.from_numpy(use_couple), torch.from_numpy(r1c), torch.from_numpy(r2c))
    got = tann._swap_plan(d, tm, tpp, tp1, v1, tp2, v2, **kw)
    old1, new1, old2, new2, ok, is_lead = got
    for g, w in zip((*old1, *new1, *old2, *new2, ok, is_lead), (*want[0], *want[1], *want[2], *want[3], want[4], want[5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lead = np.asarray(want[5])
    assert 0 < lead.sum() < K
    assert np.asarray(want[4])[lead].any() and np.asarray(want[4])[~lead].any()


def test_propose_swap_matches_jax_given_its_draws():
    jm, tm, goals, _, _, js, ts = _states("dead-brokers")
    jpp, tpp = _pp_pair(jm, tm, tann.AnnealOptions(), goals)
    K = 64
    keys = jax.random.split(jax.random.PRNGKey(6), K)
    want = jax.vmap(lambda k: jann.propose_swap(k, js, jm, jpp))(keys)

    def draws(k):
        k_p1, k_p2, k_plan = jax.random.split(k, 3)
        return dict(p1=jax.random.randint(k_p1, (), 0, jpp.p_real),
                    p2=jax.random.randint(k_p2, (), 0, jpp.p_real), plan=jax_swap_draws(k_plan, jm))

    raw = jax.vmap(draws)(keys)
    d = tann.SwapProposalDraws(p1=_t(raw["p1"]), p2=_t(raw["p2"]),
                               plan=to_draws(tann.SwapDraws, raw["plan"], (K,)))
    got = tann.propose_swap(d, ts, torch.zeros(K, dtype=torch.long), tm, tpp)
    p1, _, old1, new1, p2, _, old2, new2, ok, is_lead = got
    wp1, _, wold1, wnew1, wp2, _, wold2, wnew2, wok, wlead = want
    for g, w in zip((p1, p2, *old1, *new1, *old2, *new2, ok, is_lead),
                    (wp1, wp2, *wold1, *wnew1, *wold2, *wnew2, wok, wlead)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(wok).any()


# --------------------------------------------------------------------------
# (c) one sequential two-partition step and one batched step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    """The wide cluster in both packages, its search-state start, hot list
    and the JAX step functions (compiled once for the module)."""
    jm = random_cluster(WIDE)
    tm = carry(jm)
    goals = JAX_ORDER
    max_pt = jst.max_partitions_per_topic(jm)
    jgroup = jax.jit(jst.make_topic_group, static_argnums=1)(jm, max_pt)
    tgroup = tst.make_topic_group(tm, max_pt)
    js0 = jax.jit(lambda m, k, g: jst.init_search_state(m, JaxGoalConfig(), goals, k, group=g))(
        jm, jax.random.PRNGKey(0), jgroup)
    jidx, jn = jann.hot_partition_list(jm, goals, JaxGoalConfig())
    tidx, tn = tann.hot_partition_list(tm, goals, GoalConfig())
    assert tn == jn > 0
    np.testing.assert_array_equal(tidx[:tn].numpy(), jidx[:jn])
    jev, jn = jnp.asarray(jidx), jnp.asarray(jn, jnp.int32)
    p_real = int(np.asarray(jm.partition_valid).sum())
    bv = np.asarray(jm.broker_valid)
    b_real = int(np.max(np.where(bv, np.arange(jm.B), -1))) + 1
    steps = {}
    for name, kw in (("sequential", dict(moves_per_step=3, batched=False)),
                     ("batched", dict(moves_per_step=4))):
        opts = jann.AnnealOptions(p_swap=0.5, **kw)
        step, _ = jann._build_step(jm, goals, JaxGoalConfig(), opts, p_real, b_real, max_pt)
        steps[name] = (step.func, jax.jit(
            lambda s, i, step=step: step(s, jnp.float32(TEMP), i, jev, jn)))
    return dict(jm=jm, tm=tm, goals=goals, tgroup=tgroup, js0=js0, tev=tidx, tn=tn, steps=steps)


def _chains(wide, n_chains):
    keys = jax.random.split(jax.random.PRNGKey(9), n_chains)
    jstates = [wide["js0"].replace(key=keys[c]) for c in range(n_chains)]
    ts = tst.init_search_state(wide["tm"], GoalConfig(), wide["goals"], group=wide["tgroup"],
                               n_chains=n_chains)
    return jstates, ts


def test_sequential_swap_step_matches_jax_given_its_draws(wide):
    C, M = 2, 3
    jm, tm, goals, tev, tn = (wide[k] for k in ("jm", "tm", "goals", "tev", "tn"))
    jstates, ts = _chains(wide, C)
    opts = tann.AnnealOptions(n_chains=C, moves_per_step=M, batched=False, p_swap=0.5)
    func, run = wide["steps"]["sequential"]
    assert func is jann._anneal_step
    jpp, tpp = _pp_pair(jm, tm, opts, goals)
    after = [run(js, jnp.int32(STEP_IDX)) for js in jstates]

    def move_draws(key, i):
        k = jax.random.fold_in(key, STEP_IDX * M + i)
        k_sel, k_p, k_ev, k_evi, k_p1, k_p2, k_single, k_swap, k_acc = jax.random.split(k, 9)
        return dict(
            u_sel=jax.random.uniform(k_sel), part=jax_partition_draws(k_p, k_ev, k_evi, jpp, tn),
            p1=jax.random.randint(k_p1, (), 0, jpp.p_real), p2=jax.random.randint(k_p2, (), 0, jpp.p_real),
            single=jax_single_draws(k_single, jm, jpp), swap=jax_swap_draws(k_swap, jm),
            u_acc=_uniform_lo(k_acc),
        )

    kw = tann.step_kwargs(tm, GoalConfig(), goals, tpp, "sequential", M, wide["tgroup"])
    derive = jax.jit(jax.vmap(move_draws, in_axes=(0, None)), static_argnums=1)
    for i in range(M):
        raw = derive(jnp.stack([js.key for js in jstates]), i)
        d = tann.UnifiedDraws(
            u_sel=_t(raw["u_sel"]), part=to_draws(tann.PartitionDraws, raw["part"], (C,)),
            p1=_t(raw["p1"]), p2=_t(raw["p2"]),
            single=to_draws(tann.SingleDraws, raw["single"], (C,)),
            swap=to_draws(tann.SwapDraws, raw["swap"], (C,)), u_acc=_t(raw["u_acc"]),
        )
        tann._unified_move(ts, d, TEMP, tpp.p_swap, tev, tn, **kw)
    for c in range(C):
        assert_chain_matches(after[c], ts, c)
    prop = ts.n_prop_kind.sum(0).tolist()
    assert prop[0] > 0 and prop[1] + prop[2] > 0
    assert int(ts.n_accepted.sum()) > 0


@pytest.mark.parametrize("n_chains", [1, 3])
def test_batched_step_matches_jax_given_its_draws(wide, n_chains):
    C, K = n_chains, 4
    jm, tm, goals, tev, tn = (wide[k] for k in ("jm", "tm", "goals", "tev", "tn"))
    states, ts = _chains(wide, C)
    opts = tann.AnnealOptions(n_chains=C, moves_per_step=K, p_swap=0.5)
    func, run = wide["steps"]["batched"]
    assert func is jann._anneal_step_batched
    jpp, tpp = _pp_pair(jm, tm, opts, goals)
    assert tann.step_engine(opts, tpp, tm.R, False) == "batched"
    pool = tann.couple_pool_size(tpp)
    assert pool == 4
    kw = tann.step_kwargs(tm, GoalConfig(), goals, tpp, "batched", K, wide["tgroup"])

    def move_draws(k):
        (k_sel, k_p, k_ev, k_evi, k_pa, k_pb, k_s, k_w, k_acc, k_lead,
         k_cpl, k_ga, k_gb) = jax.random.split(k, 13)
        return dict(
            u_sel=jax.random.uniform(k_sel), part=jax_partition_draws(k_p, k_ev, k_evi, jpp, tn),
            pool_a=jax.random.randint(k_pa, (pool,), 0, jpp.p_real),
            pool_b=jax.random.randint(k_pb, (pool,), 0, jpp.p_real),
            u_lead=jax.random.uniform(k_lead), u_cpl=jax.random.uniform(k_cpl),
            u_ga=_uniform_lo(k_ga, (pool,)), u_gb=_uniform_lo(k_gb, (pool,)),
            single=jax_single_draws(k_s, jm, jpp), swap=jax_swap_draws(k_w, jm),
            u_acc=_uniform_lo(k_acc),
        )

    def flat(x):
        x = np.asarray(x)
        return torch.from_numpy(x.reshape((C * K,) + x.shape[2:]).copy())

    derive = jax.jit(lambda keys, i: jax.vmap(lambda key: jax.vmap(move_draws)(
        jax.random.split(jax.random.fold_in(key, i), K)))(keys))
    for i in range(STEP_IDX, STEP_IDX + 8):     # steps in a row, each on the state the last left
        raw = derive(jnp.stack([s.key for s in states]), jnp.int32(i))
        d = tann.BatchedDraws(
            u_sel=flat(raw["u_sel"]), part=to_draws(tann.PartitionDraws, raw["part"], (C, K)),
            pool_a=flat(raw["pool_a"]), pool_b=flat(raw["pool_b"]),
            u_lead=flat(raw["u_lead"]), u_cpl=flat(raw["u_cpl"]),
            u_ga=flat(raw["u_ga"]), u_gb=flat(raw["u_gb"]),
            single=to_draws(tann.SingleDraws, raw["single"], (C, K)),
            swap=to_draws(tann.SwapDraws, raw["swap"], (C, K)), u_acc=flat(raw["u_acc"]),
        )
        tann._anneal_step_batched(ts, d, TEMP, tpp.p_swap, tev, tn, **kw)
        states = [run(s, jnp.int32(i)) for s in states]
        for c in range(C):
            assert_chain_matches(states[c], ts, c)
    prop, acc = ts.n_prop_kind.sum(0).numpy(), ts.n_acc_kind.sum(0).numpy()
    assert (prop > 0).all() and acc[0] > 0
    if C > 1:
        assert acc[1] + acc[2] > 0


# --------------------------------------------------------------------------
# (d) masked placement writes with repeated indices
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rejected_first", [True, False])
def test_placement_updates_drop_rejected_rows_at_a_shared_index(rejected_first):
    """A rejected row naming the same (chain, partition) as an accepted one
    must not write its old value back over the accepted row, whatever the
    order of the two."""
    _, tm, goals, _, tgroup, _, ts = _states("dead-brokers")
    p = 5
    old_row, old_lead = ts.assignment[0, p].clone(), ts.leader_slot[0, p].clone()
    old_disk = ts.replica_disk[0, p].clone()
    valid = torch.nonzero(old_row >= 0)[:, 0]
    new_row = old_row.clone()
    free = [b for b in range(tm.B) if bool(tm.broker_ok[b]) and b not in old_row.tolist()]
    new_row[valid[0]] = free[0]
    new_lead = valid[-1].int()
    rows = [new_row, old_row]
    leads = [new_lead, old_lead]
    write = [True, False]
    if rejected_first:
        rows, leads, write = rows[::-1], leads[::-1], write[::-1]
    t = tm.partition_topic[p]
    tst._placement_updates(
        ts, tgroup, torch.zeros(2, dtype=torch.long), torch.tensor([p, p]), torch.stack([t, t]),
        write=torch.tensor(write), mirror=torch.tensor(write),
        rows=torch.stack(rows), leads=torch.stack(leads), disks=torch.stack([old_disk, old_disk]),
    )
    assert torch.equal(ts.assignment[0, p], new_row)
    assert int(ts.leader_slot[0, p]) == int(new_lead)
    j = int(tgroup.member_slot[p])
    assert torch.equal(ts.grouped_assign[0, int(t), j], new_row)
    assert int(ts.grouped_leader[0, int(t), j]) == int(new_lead)


def test_single_move_keeps_its_row_when_the_inert_partner_is_itself():
    """The sequential engine's inert partner is a uniform draw that can
    equal the moved partition: the accepted move's row survives."""
    _, tm, goals, _, tgroup, _, ts = _states("dead-brokers")
    score = tst.make_swap_scorer(tm, goals, GoalConfig())
    zero = torch.zeros(1, dtype=torch.long)
    p = torch.tensor([3])
    v = tst.gather_views(ts, tm, zero, p)
    old = (v.assign, v.leader, v.disk)
    row = v.assign.clone()
    free = [b for b in range(tm.B) if bool(tm.broker_ok[b]) and b not in row[0].tolist()]
    row[0, 0] = free[0]
    new = (row, v.leader, v.disk)
    inert = tann._inert(torch.tensor([False]), old)
    d = score(ts, zero, v, old, new, v, inert, inert)
    tst.apply_swap(ts, tm, zero, p, v, old, new, p, v, inert, inert, d, torch.tensor([True]),
                   group=tgroup, active2=torch.tensor([False]))
    assert torch.equal(ts.assignment[0, 3], row[0])
    t, j = int(tm.partition_topic[3]), int(tgroup.member_slot[3])
    assert torch.equal(ts.grouped_assign[0, t, j], row[0])


# --------------------------------------------------------------------------
# the host-launch budget of the SA engines
# --------------------------------------------------------------------------


def _top_level_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None)


def test_batched_step_puts_fewer_ops_on_the_device():
    """The SA engines are bound by host launches on the card: count the
    top-level torch ops of 1- and 2-step ``anneal`` windows (16 chains, 8
    moves, 128 brokers; each window includes the init and the two stack
    evaluations) per engine. A step's ops do not depend on the data, so the
    counts are linear in the steps; the 10-step window is printed too. The
    batched step pays its gather, scatter and scoring once per step, not
    once per proposal."""
    from ccx_torch.model.fixtures import RandomClusterSpec as TorchSpec
    from ccx_torch.model.fixtures import random_cluster as torch_cluster

    m = torch_cluster(TorchSpec(n_brokers=128, n_racks=8, n_topics=32, n_partitions=4000, seed=5),
                      device="cpu")
    per_step = {}
    for p_swap in (0.0, 0.15):
        n = {k: _top_level_ops(lambda k=k: tann.anneal(m, opts=tann.AnnealOptions(
            n_chains=16, n_steps=k, moves_per_step=8, p_swap=p_swap))) for k in (1, 2)}
        per_step[p_swap] = n[2] - n[1]
        print(f"p_swap={p_swap}: window of 10 steps {n[1] + 9 * per_step[p_swap]} ops, "
              f"{per_step[p_swap]} per step")
    assert per_step[0.15] < per_step[0.0] / 2
