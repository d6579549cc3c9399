"""The port's warm pipeline against the JAX package.

* The drift scan's pieces equal JAX's on the same clusters: ``warm_model``
  and its merge of new partition rows, ``_pressure_stack`` (floats within
  rtol 1e-5 / atol 1e-3), ``_touched_mask``, ``drift_hot_list`` and the
  fused init's stack (integers exact).
* The store: generations, the count LRU, stats and device bytes.
* End to end on the port: a warm re-proposal after a metrics drift is
  verified, warm-started, a minimal diff, never significantly lex-worse
  than its base, and banks the pressure of the placement it ships; a shape
  mismatch starts cold and names the reason; a dead broker takes the
  structural path and leaves nothing on it; both revert guards ship the
  base; disarmed, ``warm_start`` is ignored.
* ``rungs.steady_options`` and ``rungs.drift_metrics`` equal the bench's.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.model.fixtures import RandomClusterSpec, random_cluster
from ccx.search import incremental as jinc
from ccx_torch import optimizer as topt
from ccx_torch import rungs
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_arrays, model_from_arrays
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search import incremental as tinc
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from test_torch_state import carry

CFG = GoalConfig()
GOALS = DEFAULT_GOAL_ORDER
SPEC = RandomClusterSpec(n_brokers=24, n_racks=4, n_topics=12, n_partitions=300,
                         n_dead_brokers=2, seed=21)


@pytest.fixture(autouse=True)
def _clean_store():
    tinc.STORE.clear()
    yield
    tinc.STORE.clear()


def _drift_arrays(jm, seed: int, frac: float = 0.2) -> dict:
    arrays = {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}
    p_real = int(arrays["partition_valid"].sum())
    return rungs.drift_metrics(arrays, np.random.default_rng(seed), p_real, int(p_real * frac))


@pytest.fixture(scope="module")
def pair():
    """A JAX cluster as the warm base, a drifted snapshot of it whose first
    rows the base does not hold (new partitions), in both packages."""
    jbase = random_cluster(SPEC)
    drifted = _drift_arrays(jbase, 4)
    a = np.asarray(jbase.assignment).copy()
    a[:5] = -1  # rows created since the bank
    jbank = jbase.replace(assignment=jnp.asarray(a))
    jsnap = jbase.replace(**{k: jnp.asarray(drifted[k]) for k in ("leader_load", "follower_load")})
    return jbank, jsnap, carry(jbank), carry(jsnap)


def test_warm_model_and_its_merge_equal_jax(pair):
    jbank, jsnap, tbank, tsnap = pair
    jw = jinc.WarmStart(session="s", generation=1, assignment=jbank.assignment,
                        leader_slot=jbank.leader_slot, replica_disk=jbank.replica_disk)
    tw = tinc.WarmStart(session="s", generation=1, assignment=tbank.assignment,
                        leader_slot=tbank.leader_slot, replica_disk=tbank.replica_disk)
    jm, tm = jinc.warm_model(jsnap, jw), tinc.warm_model(tsnap, tw)
    for f in ("assignment", "leader_slot", "replica_disk"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    # the new rows keep the snapshot's placement
    assert torch.equal(tm.assignment[:5], tsnap.assignment[:5])
    np.testing.assert_array_equal(tm.leader_load.numpy(), np.asarray(jsnap.leader_load))
    small = carry(random_cluster(RandomClusterSpec(n_brokers=8, n_racks=4, n_topics=4,
                                                   n_partitions=64, seed=11)))
    assert tinc.warm_model(small, tw) is None


def test_pressure_touched_mask_and_hot_list_equal_jax(pair):
    jbank, jsnap, tbank, tsnap = pair
    jcfg = JaxGoalConfig()
    jp_old, jp_new = jinc._pressure_stack(jbank, jcfg), jinc._pressure_stack(jsnap, jcfg)
    tp_old, tp_new = tinc._pressure_stack(tbank, CFG), tinc._pressure_stack(tsnap, CFG)
    np.testing.assert_allclose(tp_new.numpy(), np.asarray(jp_new), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tp_old.numpy(), np.asarray(jp_old), rtol=1e-5, atol=1e-3)
    jmask, jn = jinc._touched_mask(jp_new, jp_old)
    tmask, tn = tinc._touched_mask(torch.from_numpy(np.array(jp_new)), torch.from_numpy(np.array(jp_old)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tinc._touched_mask(tp_new, tp_old)[0].numpy(), np.asarray(jmask))
    # the base holds replicas on dead brokers: structural offenders join
    # the drift set
    jevac, jne, jns = jinc.drift_hot_list(jsnap, np.asarray(jmask), GOALS, jcfg)
    tevac, tne, tns = tinc.drift_hot_list(tsnap, tmask, GOALS, CFG)
    np.testing.assert_array_equal(tevac.numpy(), np.asarray(jevac))
    assert (tne, tns) == (int(jne), jns) and tns > 0


def test_fused_init_and_finish_equal_the_separate_passes(pair):
    _, _, tbank, tsnap = pair
    state, stack, press, mask, count = tinc.warm_init(tsnap, tinc._pressure_stack(tbank, CFG), CFG, GOALS)
    ref = topt.evaluate_stack(tsnap, CFG, GOALS)
    assert torch.equal(stack.violations, ref.violations) and torch.equal(stack.costs, ref.costs)
    assert torch.equal(press, tinc._pressure_stack(tsnap, CFG))
    assert int(count) == int(mask.sum()) and state.n_chains == 1
    stack2, press2 = tinc.warm_finish(tsnap, CFG, GOALS)
    assert torch.equal(stack2.costs, ref.costs) and torch.equal(press2, press)
    _, _, _, mask_all, count_all = tinc.warm_init(tsnap, None, CFG, GOALS)
    assert bool(mask_all.all()) and int(count_all) == tsnap.B


def test_store_generations_lru_and_bytes():
    m = carry(random_cluster(SPEC))
    store = tinc.PlacementStore(max_sessions=2)
    for i, sid in enumerate(("a", "b", "c")):
        store.put(tinc.WarmStart(session=sid, generation=i + 1, assignment=m.assignment,
                                 leader_slot=m.leader_slot, replica_disk=m.replica_disk))
    st = store.stats()
    assert st["sessions"] == 2 and st["evictions"] == 1
    assert store.get("a") is None
    assert store.get("b", base_generation=2) is not None
    assert store.get("b", base_generation=1) is None
    assert store.get("c").generation == 3
    assert store.generation("c") == 3 and store.generation("zz") is None
    per = m.assignment.nbytes + m.leader_slot.nbytes + m.replica_disk.nbytes
    assert store.device_bytes() == 2 * per
    store.drop("b")
    assert store.stats()["sessions"] == 1
    warm = tinc.remember("s-bank", 4, m, CFG)
    assert tinc.STORE.get("s-bank", 4) is warm and warm.assignment is m.assignment
    assert tuple(warm.pressure.shape) == (6, m.B)


def test_touched_brokers_localizes_drift(pair):
    _, _, tbank, _ = pair
    warm = tinc.remember("s-touch", 1, tbank, CFG)
    assert not bool(tinc.touched_brokers(warm, tbank, CFG)[0].any())
    drifted = model_from_arrays(_drift_arrays(random_cluster(SPEC), 9, 0.3) | {
        k: v for k, v in model_arrays(tbank).items() if k not in ("leader_load", "follower_load")},
        tbank.num_topics, tbank.num_racks, "cpu")
    assert bool(tinc.touched_brokers(warm, drifted, CFG)[0].any())
    assert bool(tinc.touched_brokers(dataclasses.replace(warm, pressure=None), tbank, CFG)[0].all())


# ----- the warm pipeline end to end ---------------------------------------------

SMALL = RandomClusterSpec(n_brokers=32, n_racks=4, n_topics=8, n_partitions=240,
                          n_dead_brokers=1, seed=5)
COLD = OptimizeOptions(
    anneal=AnnealOptions(n_chains=2, n_steps=12, moves_per_step=2, seed=1),
    polish=GreedyOptions(n_candidates=32, max_iters=10), run_cold_greedy=False,
    topic_rebalance_rounds=0, leader_pass_max_iters=6,
)
WARM = dataclasses.replace(COLD, incremental=dataclasses.replace(
    rungs.steady_options(), warm_steps=8, warm_chunk_steps=4), plan_enabled=True)


@pytest.fixture(scope="module")
def cold():
    jm = random_cluster(SMALL)
    m = carry(jm)
    res = optimize(m, CFG, GOALS, COLD)
    assert res.verification.ok
    return m, res


def _snapshot(m, res, seed: int):
    arrays = model_arrays(res.model)
    p_real = int(m.partition_valid.sum())
    drifted = rungs.drift_metrics(arrays, np.random.default_rng(seed), p_real, p_real // 20)
    return model_from_arrays({**model_arrays(res.model), **{
        k: drifted[k] for k in ("leader_load", "follower_load")}}, m.num_topics, m.num_racks, "cpu")


def test_warm_reproposal_end_to_end(cold):
    m, res0 = cold
    warm = tinc.remember("s-warm", 1, res0.model, CFG)
    snap = _snapshot(m, res0, 3)
    res = optimize(snap, CFG, GOALS, WARM, warm_start=warm)
    assert res.verification.ok, res.verification.failures
    info = res.incremental
    assert info["warmStart"] and not info["coldStart"] and info["session"] == "s-warm"
    assert info["baseGeneration"] == 1 and info["diffSize"] == res.diff.n < int(m.P) // 4
    assert not tinc._significantly_lex_worse(res.stack_after, res.stack_before)
    assert {"drift-scan", "swap-polish", "diff", "verify", "plan"} <= set(res.phase_seconds)
    assert res.plan is not None and res.plan.wave.shape[0] == res.diff.n
    if res.warm_pressure is not None:
        torch.testing.assert_close(res.warm_pressure, tinc._pressure_stack(res.model, CFG),
                                   rtol=1e-5, atol=1e-6)
    assert res.input_model is snap


def test_shape_mismatch_starts_cold_with_the_reason(cold):
    m, _ = cold
    other = carry(random_cluster(RandomClusterSpec(n_brokers=8, n_racks=4, n_topics=4,
                                                   n_partitions=64, seed=11)))
    warm = tinc.remember("s-shape", 1, other, CFG)
    res = optimize(m, CFG, GOALS, WARM, warm_start=warm)
    assert res.verification.ok
    assert res.incremental["coldStart"] and "shape mismatch" in res.incremental["reason"]


def test_a_dead_broker_takes_the_structural_path(cold):
    m, res0 = cold
    warm = tinc.remember("s-dead", 1, res0.model, CFG)
    snap = _snapshot(m, res0, 5)
    victim = int(torch.nonzero(snap.broker_ok)[0, 0])
    alive = snap.broker_alive.clone()
    alive[victim] = False
    res = optimize(snap.replace(broker_alive=alive), CFG, GOALS, WARM, warm_start=warm)
    assert res.verification.ok, res.verification.failures
    info = res.incremental
    assert info["warmStart"] and info["structuralOffenders"] > 0 and info["plateau"] is not None
    assert {"repair", "anneal", "swap-polish"} <= set(res.phase_seconds)
    assert not bool((res.model.assignment == victim).any())


def test_the_lex_revert_guard_ships_the_base(cold, monkeypatch):
    m, res0 = cold
    warm = tinc.remember("s-lex", 1, res0.model, CFG)
    snap = _snapshot(m, res0, 6)
    monkeypatch.setattr(tinc, "_significantly_lex_worse", lambda after, before: True)
    res = optimize(snap, CFG, GOALS, WARM, warm_start=warm)
    assert res.incremental["structuralOffenders"] == 0
    assert res.incremental["reverted"] == "lex" and res.warm_pressure is None
    assert torch.equal(res.model.assignment, tinc.warm_model(snap, warm).assignment)
    assert res.n_polish_moves == 0 and res.verification.ok


def test_the_verification_revert_guard_ships_the_base(cold, monkeypatch):
    m, res0 = cold
    warm = tinc.remember("s-ver", 1, res0.model, CFG)
    snap = _snapshot(m, res0, 8)
    base = tinc.warm_model(snap, warm)
    real = topt.verify_optimization

    def verify(before, after, *a, **k):
        v = real(before, after, *a, **k)
        if not torch.equal(after.assignment, base.assignment) or not torch.equal(
                after.leader_slot, base.leader_slot):
            return dataclasses.replace(v, ok=False, failures=["rejected by the test"])
        return v

    monkeypatch.setattr(topt, "verify_optimization", verify)
    res = optimize(snap, CFG, GOALS, WARM, warm_start=warm)
    assert res.incremental["reverted"] == "verification"
    assert res.verification.ok and torch.equal(res.model.assignment, base.assignment)


def test_disarmed_warm_start_runs_the_cold_pipeline(cold, monkeypatch):
    m, res0 = cold
    warm = tinc.remember("s-off", 1, res0.model, CFG)
    plain = optimize(m, CFG, GOALS, COLD)
    res = optimize(m, CFG, GOALS, COLD, warm_start=warm)
    assert res.incremental is None and torch.equal(res.model.assignment, plain.model.assignment)
    monkeypatch.setenv(tinc.ENV_INCREMENTAL, "0")
    assert not WARM.incremental.armed
    assert optimize(m, CFG, GOALS, WARM, warm_start=warm).incremental is None


def test_steady_options_and_drift_rule_equal_the_bench():
    opts = rungs.steady_options()
    names = {"warm_moves": "warm_moves_per_step"}
    for key, value in bench._steady_options().items():
        assert getattr(opts, names.get(key, key)) == value, key
    assert opts.enabled
    jshared = {f.name for f in dataclasses.fields(jinc.IncrementalOptions)}
    for f in dataclasses.fields(tinc.IncrementalOptions):
        if f.name in jshared:
            assert getattr(tinc.IncrementalOptions(), f.name) == getattr(jinc.IncrementalOptions(), f.name)
    arrays = {"leader_load": np.random.default_rng(0).uniform(size=(4, 50)).astype(np.float32),
              "follower_load": np.random.default_rng(1).uniform(size=(4, 50)).astype(np.float32),
              "other": np.arange(3)}
    got = rungs.drift_metrics(arrays, np.random.default_rng(123), 40, 7)
    want = bench.drift_metrics(arrays, np.random.default_rng(123), 40, 7)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("goals", [GOALS, ("StructuralFeasibility", "CpuCapacityGoal")],
                         ids=["default-stack", "capacity-only"])
def test_device_hot_list_equals_jax(pair, goals):
    from ccx.search import annealer as jann
    from ccx_torch.search import annealer as tann

    _, jsnap, _, tsnap = pair
    for jm, tm in ((jsnap, tsnap), (jsnap.replace(broker_alive=jnp.ones_like(jsnap.broker_alive)),
                                   tsnap.replace(broker_alive=torch.ones_like(tsnap.broker_alive)))):
        jidx, jn = jann.hot_partition_list_device(jm, goal_names=goals, cfg=JaxGoalConfig())
        tidx, tn = tann.hot_partition_list_device(tm, goals, CFG)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        assert int(tn) == int(jn)
