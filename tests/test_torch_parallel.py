"""The port's device-mesh sharding (``ccx_torch.parallel.sharding``) against
the JAX package's (``ccx.parallel.sharding``, ``tests/test_parallel.py``).

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's on a virtual mesh of logical CPU devices
(``ccx_torch.common.vmesh.forced``, restored after each test). Both build
their models from the same numpy arrays.

* Stack evaluation is deterministic: violations equal exactly, costs within
  the repo's rtol 1e-5 / atol 1e-3, against JAX's ``sharded_stack_eval`` and
  the port's own ``evaluate_stack``, on every searchable stack.
* The port's sharded anneal draws once for all chains from the controller's
  ``torch.Generator``, in the unsharded engine's order, and runs the
  unsharded engine's steps; only the starting aggregates are summed in
  another order (per block, then psummed). On the CPU both runs are
  deterministic, and at these sizes that order decides no acceptance, so the
  placements are equal, bit for bit, for every step engine: these tests
  hold them to that. A size or a card where the float order parts them
  would be held to equal lex quality within the tolerance instead.
* Against JAX's sharded anneal the random streams differ (threefry against
  torch's), so the comparison is quality at an equal budget.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ccx.goals.base import GoalConfig as JaxGoalConfig
from ccx.model.fixtures import RandomClusterSpec, random_cluster as jax_random_cluster
from ccx.parallel import sharding as jsh
from ccx.search.annealer import AnnealOptions as JaxAnnealOptions
from ccx_torch.common import vmesh
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, INTRA_BROKER_GOAL_ORDER, evaluate_stack
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays
from ccx_torch.parallel import sharding
from ccx_torch.search.annealer import AnnealOptions, anneal, round_up_chains
from ccx_torch.search.state import check_searchable
from ccx_torch.verify import verify_model_consistency

RTOL, ATOL = 1e-5, 1e-3
KAFKA_ASSIGNER = (
    "StructuralFeasibility",
    "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal",
)
SMALL = RandomClusterSpec(n_brokers=8, n_racks=2, n_topics=6, n_partitions=200, seed=7)
#: wide enough for the batched engine (b_real >= 4 * R * moves)
WIDE = RandomClusterSpec(n_brokers=64, n_racks=4, n_topics=8, n_partitions=256, seed=11)


def _pair(spec):
    jm = jax_random_cluster(spec)
    tm = model_from_arrays({k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS},
                           jm.num_topics, jm.num_racks, "cpu")
    return jm, tm


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


@pytest.fixture(scope="module")
def wide():
    return _pair(WIDE)


@pytest.fixture
def mesh8():
    """8 logical CPU devices for the test, the previous list restored."""
    with vmesh.forced(8, "cpu") as devs:
        yield devs


def _same_placement(a, b):
    assert torch.equal(a.model.assignment, b.model.assignment)
    assert torch.equal(a.model.leader_slot, b.model.leader_slot)
    assert torch.equal(a.model.replica_disk, b.model.replica_disk)


@pytest.mark.parametrize("parts", [None, 1, 2, 4, 8])
def test_mesh_shape_matches_jax(parts, mesh8):
    mesh = sharding.make_mesh(parts=parts)
    jmesh = jsh.make_mesh(jax.devices(), parts=parts)
    assert mesh.shape == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    assert mesh.size == jmesh.size == 8
    assert mesh.axis_names == tuple(jmesh.axis_names)


def test_mesh_refuses_a_parts_that_does_not_divide(mesh8):
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_mesh(parts=3)
    with pytest.raises(ValueError, match="not divisible"):
        jsh.make_mesh(jax.devices(), parts=3)


def test_model_pspecs_match_jax(small):
    jm, tm = small
    jspecs = jsh.model_pspecs(jm)
    specs = sharding.model_pspecs(tm)
    assert set(specs) == set(TENSOR_FIELDS)
    for name in TENSOR_FIELDS:
        assert specs[name] == tuple(getattr(jspecs, name)), name


def test_shard_model_cuts_contiguous_blocks(small, mesh8):
    _, tm = small
    mesh = sharding.make_mesh(parts=4)
    sm = sharding.shard_model(tm, mesh)
    assert sm.P_local * 4 == tm.P and sm.offsets == tuple(i * sm.P_local for i in range(4))
    joined = sharding.unshard(sm, "cpu")
    for name in TENSOR_FIELDS:
        assert torch.equal(getattr(joined, name), getattr(tm, name)), name
    assert len(sharding.replicate(tm.broker_capacity, mesh)) == mesh.size
    with pytest.raises(ValueError, match="not divisible"):
        sharding.shard_model(tm, sharding.make_mesh([torch.device("cpu")] * 3, parts=3))


def test_blocks_of_one_model_get_their_own_topic_index(small, mesh8):
    from ccx_torch.ops import broker_aggregates as agg_op

    _, tm = small
    sm = sharding.shard_model(tm, sharding.make_mesh(parts=2))
    a, b = (agg_op.topic_index(blk) for blk in sm.blocks[0])
    assert a is not b
    assert int(a.order.numel()) + int(b.order.numel()) == int(tm.partition_valid.sum())
    assert agg_op.topic_index(sm.blocks[0][0]) is a


def _searchable_stacks():
    stacks = [DEFAULT_GOAL_ORDER, KAFKA_ASSIGNER, INTRA_BROKER_GOAL_ORDER]
    out = []
    for s in stacks:
        try:
            check_searchable(s)
        except ValueError:
            continue
        out.append(s)
    return out


@pytest.mark.parametrize("stack,parts", [
    pytest.param(s, p, id=f"{s[1]}-parts{p}")
    for s, p in [(s, 2) for s in _searchable_stacks()] + [(DEFAULT_GOAL_ORDER, 4)]])
def test_sharded_stack_eval_matches_jax_and_the_local_stack(small, stack, parts, mesh8):
    jm, tm = small
    jmesh = jsh.make_mesh(jax.devices(), parts=parts)
    jres = jsh.sharded_stack_eval(jsh.shard_model(jm, jmesh), JaxGoalConfig(), stack, mesh=jmesh)
    res = sharding.sharded_stack_eval(tm, GoalConfig(), stack, sharding.make_mesh(parts=parts))
    local = evaluate_stack(tm, GoalConfig(), stack)
    np.testing.assert_array_equal(res.violations.numpy(), np.asarray(jres.violations))
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(jres.costs), rtol=RTOL, atol=ATOL)
    assert torch.equal(res.violations, local.violations)
    torch.testing.assert_close(res.costs, local.costs, rtol=RTOL, atol=ATOL)
    assert res.hard_mask == tuple(GOAL_REGISTRY[n].hard for n in stack)


@pytest.mark.parametrize("engine", ["sequential", "batched", "single"])
def test_sharded_anneal_equals_the_unsharded_anneal(small, wide, engine, mesh8):
    """parts 4 x chains 2 against the unsharded anneal on the same seed:
    equal placements (module docstring)."""
    _, tm = wide if engine == "batched" else small
    opts = AnnealOptions(n_chains=4, n_steps=40, seed=3,
                         moves_per_step=4 if engine == "batched" else 2,
                         p_swap=0.0 if engine == "single" else 0.15)
    mesh = sharding.make_mesh(parts=4)
    rs = sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts, mesh)
    ru = anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts)
    assert rs.engine == ru.engine == engine
    assert ru.n_accepted > 0
    _same_placement(rs, ru)
    assert rs.best_chain == ru.best_chain and rs.n_accepted == ru.n_accepted
    torch.testing.assert_close(rs.stack_after.costs, ru.stack_after.costs, rtol=RTOL, atol=ATOL)
    # anneal(mesh=) with a parts axis hands the run to the sharded engine
    _same_placement(anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts, mesh=mesh), rs)


def _span_reading(run) -> tuple:
    """(the ``engine`` attributes, the ``subSteps`` and the ``sa-step``
    entries) a run leaves in the tree of the span it runs under."""
    with TRACER.span("run") as s:
        run()
    engines, sub_steps, steps = [], 0, 0
    todo = [s.to_json()]
    while todo:
        node = todo.pop()
        attrs = node.get("attrs", {})
        if "engine" in attrs:
            engines.append(attrs["engine"])
        sub_steps += attrs.get("subSteps", 0)
        if node["name"] == "sa-step":
            steps += node["calls"]
        todo.extend(node.get("children", []))
    return engines, sub_steps, steps


@pytest.mark.parametrize("engine", ["sequential", "batched", "single"])
def test_sharded_and_unsharded_runs_report_the_same_spans(small, wide, engine, mesh8):
    """One SA driver: on the same seed a sharded run sets the span's
    ``engine`` and ``subSteps`` and opens as many ``sa-step`` entries as
    the unsharded run."""
    _, tm = wide if engine == "batched" else small
    moves = 4 if engine == "batched" else 2
    opts = AnnealOptions(n_chains=4, n_steps=12, seed=3, chunk_steps=5, moves_per_step=moves,
                         p_swap=0.0 if engine == "single" else 0.15)
    mesh = sharding.make_mesh(parts=4)
    got = _span_reading(
        lambda: sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts, mesh))
    ref = _span_reading(lambda: anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts))
    assert ref == ([engine], 12 * (moves if engine == "sequential" else 1), 12)
    assert got == ref


def test_sharded_chunked_equals_the_one_shot_run(small, mesh8):
    _, tm = small
    mesh = sharding.make_mesh(parts=4)
    opts = AnnealOptions(n_chains=4, n_steps=45, seed=3)
    one = sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts, mesh)
    chunked = sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER,
                                      dataclasses.replace(opts, chunk_steps=20), mesh)
    _same_placement(chunked, one)
    assert chunked.convergence is not None and one.convergence is None


def test_a_retune_adds_no_program_cache_entry(small, mesh8):
    _, tm = small
    mesh = sharding.make_mesh(parts=4)
    base = AnnealOptions(n_chains=4, n_steps=20, seed=3, chunk_steps=10)
    sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, base, mesh)
    before = sharding.program_cache_stats()
    sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER,
                            dataclasses.replace(base, n_steps=30, t1=2e-4, seed=4), mesh)
    assert sharding.program_cache_stats() == before
    assert before["max"] == jsh.program_cache_stats()["max"]
    assert set(before) == set(jsh.program_cache_stats())


def test_sharded_chunk_heartbeats(small, mesh8):
    from ccx_torch.common.tracing import TRACER

    _, tm = small
    recs = []
    TRACER.add_listener(recs.append)
    try:
        sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER,
                                AnnealOptions(n_chains=4, n_steps=30, seed=3, chunk_steps=10),
                                sharding.make_mesh(parts=4))
    finally:
        TRACER.remove_listener(recs.append)
    beats = [r for r in recs if r.get("ev") == "chunk" and "sharded-anneal" in (r.get("span") or "")]
    assert len(beats) == 3, [r.get("ev") for r in recs]
    assert any(r.get("ev") == "end" and (r.get("span") or "").endswith("sharded-anneal")
               for r in recs)


def test_chains_are_rounded_up_to_the_chain_ranks(small, mesh8):
    _, tm = small
    r = sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER,
                                AnnealOptions(n_chains=5, n_steps=10, seed=3, chunk_steps=5),
                                sharding.make_mesh(parts=4))
    assert r.n_chains == 6
    # chains-only data parallelism rounds by the whole mesh, as JAX's does
    assert anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, AnnealOptions(n_chains=5, n_steps=5),
                  mesh=sharding.make_mesh(parts=1)).n_chains == 8
    assert round_up_chains(9, 4, "test") == 12 and round_up_chains(2, 1, "test") == 2


def test_quality_parity_with_jax_sharded_anneal(wide, mesh8):
    """Equal budget on a (chains 2 x parts 4) mesh in both packages: both
    improve the stack and produce sound models, and land within max(10,
    25%) of each other on every goal's count (SA alone, no repair, so the
    hard tiers are counts too)."""
    from ccx.verify import verify_model_consistency as jax_consistency

    jm, tm = wide
    kw = dict(n_chains=4, n_steps=60, moves_per_step=4, seed=11, batched=True, chunk_steps=20)
    jres = jsh.sharded_anneal(jm, JaxGoalConfig(), DEFAULT_GOAL_ORDER, JaxAnnealOptions(**kw),
                              jsh.make_mesh(jax.devices(), parts=4))
    res = sharding.sharded_anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, AnnealOptions(**kw),
                                  sharding.make_mesh(parts=4))
    assert float(res.stack_after.soft_scalar) < float(res.stack_before.soft_scalar)
    assert not verify_model_consistency(res.model)
    assert not jax_consistency(jres.model)
    va = res.stack_after.violations.numpy()
    vj = np.asarray(jres.stack_after.violations)
    for i, name in enumerate(DEFAULT_GOAL_ORDER):
        assert abs(va[i] - vj[i]) <= max(10.0, 0.25 * max(va[i], vj[i])), (name, va[i], vj[i])


def test_optimize_mesh_key_equals_jax(small, mesh8):
    """``optimize(mesh_enabled=True)`` over the forced 8-device mesh gives
    the ``mesh`` key JAX's optimize gives for the same mesh (its run mesh
    from the same options, keyed as ``ccx/optimizer.py`` keys it), and runs
    the sharded engine; fewer than two devices run single-device."""
    from ccx.optimizer import OptimizeOptions as JaxOptimizeOptions
    from ccx.optimizer import _make_run_mesh as jax_run_mesh
    from ccx_torch.optimizer import OptimizeOptions, optimize
    from ccx_torch.search.greedy import GreedyOptions

    _, tm = small
    opts = OptimizeOptions(
        anneal=AnnealOptions(n_chains=4, n_steps=20, seed=3, chunk_steps=10),
        polish=GreedyOptions(n_candidates=32, max_iters=10), run_cold_greedy=False,
        topic_rebalance_rounds=0, leader_pass_max_iters=5, mesh_enabled=True, mesh_parts=2)
    res = optimize(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts)
    jmesh = jax_run_mesh(JaxOptimizeOptions(mesh_enabled=True, mesh_parts=2))
    want = {"meshShape": dict(zip(jmesh.axis_names, jmesh.devices.shape)),
            "devices": int(jmesh.size), "shardedPrograms": jsh.program_cache_stats()}
    assert set(res.mesh) == set(want)
    assert res.mesh["meshShape"] == want["meshShape"] == {"chains": 4, "parts": 2}
    assert res.mesh["devices"] == want["devices"] == 8
    assert set(res.mesh["shardedPrograms"]) == set(want["shardedPrograms"])
    assert res.mesh["shardedPrograms"]["run"] >= 1
    assert res.to_json(include_proposals=False)["mesh"] == res.mesh
    assert res.verification.ok
    with vmesh.forced(1, "cpu"):
        assert optimize(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts).mesh is None


def test_facade_under_a_two_device_mesh_answers_a_dry_run(tmp_path):
    """The façade under a 2-device virtual mesh: no refusal, the state's
    mesh block equal to the JAX façade's rule for two devices, and a dry run
    whose result carries the mesh it ran on."""
    import types

    from ccx.service.facade import CruiseControl as JaxCruiseControl
    from test_torch_facade import FAST, make_cc

    keys = {"optimizer.mesh.enabled": True, "optimizer.mesh.devices": 2,
            "optimizer.mesh.parts": 1}
    with vmesh.forced(2, "cpu"):
        cc, _, _ = make_cc(tmp_path, **keys, **FAST)
        try:
            state = cc.state(("analyzer",))["AnalyzerState"]["observability"]["mesh"]
            jstate = JaxCruiseControl._mesh_state(types.SimpleNamespace(config=keys))
            assert {k: v for k, v in state.items() if k != "shardedPrograms"} == {
                k: v for k, v in jstate.items() if k != "shardedPrograms"}
            assert state["meshShape"] == {"chains": 2, "parts": 1}
            res = cc.rebalance(dryrun=True)
        finally:
            cc.shutdown()
    assert res["verified"]
    assert res["mesh"]["meshShape"] == state["meshShape"] and res["mesh"]["devices"] == 2


@pytest.mark.parametrize("devices,parts", [(0, 1), (0, 2), (0, 4), (0, 3), (1, 1), (6, 4), (2, 2)])
def test_run_mesh_follows_the_jax_rule(devices, parts, mesh8):
    """The optimizer's run mesh from ``mesh_devices``/``mesh_parts``: the
    JAX package's shape, None below two devices, chains-only where parts
    does not divide the devices."""
    from ccx.optimizer import OptimizeOptions as JaxOptimizeOptions
    from ccx.optimizer import _make_run_mesh as jax_run_mesh
    from ccx_torch.optimizer import OptimizeOptions, _make_run_mesh

    kw = dict(mesh_enabled=True, mesh_devices=devices, mesh_parts=parts)
    mesh = _make_run_mesh(OptimizeOptions(**kw), torch.device("cpu"))
    jmesh = jax_run_mesh(JaxOptimizeOptions(**kw))
    if jmesh is None:
        assert mesh is None
    else:
        assert mesh.shape == dict(zip(jmesh.axis_names, jmesh.devices.shape))


def test_a_parts_axis_that_does_not_divide_p_runs_chains_only(small):
    """``anneal(mesh=)`` with a parts axis that does not divide the padded P
    runs chains-only data parallelism (chains rounded to the mesh), as
    JAX's does, and equals the unsharded run at that chain count."""
    _, tm = small
    with vmesh.forced(6, "cpu"):
        mesh = sharding.make_mesh(parts=3)
    assert tm.P % 3
    opts = AnnealOptions(n_chains=4, n_steps=10, seed=3)
    r = anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER, opts, mesh=mesh)
    assert r.n_chains == 6
    _same_placement(r, anneal(tm, GoalConfig(), DEFAULT_GOAL_ORDER,
                              dataclasses.replace(opts, n_chains=6)))
