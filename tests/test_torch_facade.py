"""The port's service façade against the JAX package's, on the CPU.

Both façades take the JAX package's test recipe (``tests/test_facade.py``
``make_cc``: a 4-broker simulated cluster, the synthetic sampler, the static
capacity resolver, 5 sampled windows), the port's with ``device="cpu"``:

* the monitor's model arrays are equal (integers and masks exactly, floats
  within rtol 1e-5 / atol 1e-3), as are ``load()``, ``partition_load()``
  and ``kafka_cluster_state()``; ``state()`` has the same keys in every
  substate; the optimizer options built from the config are the same;
* a dry-run ``rebalance`` verifies with zero hard violations and has the
  JAX result's keys (the proposals themselves may differ: the random
  streams do).

Every façade here runs a smaller SA budget than the recipe's 8 chains x
300 steps (``FAST``; the port's SA steps cost ~0.1 s each on the CPU), the
same on both sides. The JAX side runs once, in a module fixture (its first
verb compiles for tens of seconds). Each verb's own property runs on the
port alone: an execution drains and spreads the replicas, brokers are
removed, added and demoted, offline replicas are moved, the disk rebalance
keeps replicas on their brokers, the greedy backend proposes moves, a mesh
asked for on the CPU runs on one device, and the cost and profile keys
reach the port's modules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ccx.config import CruiseControlConfig as JaxConfig
from ccx.executor.admin import SimulatedAdminClient as JaxAdmin
from ccx.executor.admin import SimulatedCluster as JaxSim
from ccx.service.facade import CruiseControl as JaxCruiseControl
from ccx_torch.common.exceptions import UserRequestException
from ccx_torch.config import CruiseControlConfig
from ccx_torch.executor.admin import SimulatedAdminClient, SimulatedCluster
from ccx_torch.model.tensor_model import TENSOR_FIELDS
from ccx_torch.service.facade import CruiseControl

RTOL, ATOL = 1e-5, 1e-3
#: the SA budget of every façade here (the recipe's is 8 chains x 300 steps)
FAST = {"optimizer.num.chains": 4, "optimizer.num.steps": 40}


def sim_cluster(sim_cls, n_brokers=4, partitions=8, rf=2, skewed=False):
    sim = sim_cls()
    for b in range(n_brokers):
        sim.add_broker(b, rack=f"r{b % 2}", num_disks=2)
    sim.create_topic("t0", partitions, rf, size_mb=10)
    if skewed:
        for part in sim._partitions.values():
            part.replicas = [0, 1][:rf]
            part.leader = 0
            part.dirs = [0] * rf
        sim._generation += 1
    return sim


def recipe(tmp_path, **extra) -> dict:
    props = {
        "metric.sampler.class": "ccx.monitor.sampling.sampler.SyntheticMetricSampler",
        "broker.capacity.config.resolver.class": "ccx.monitor.capacity.StaticCapacityResolver",
        "sample.store.dir": str(tmp_path / "samples"),
        "partition.metrics.window.ms": 1000,
        "num.partition.metrics.windows": 3,
        "broker.metrics.window.ms": 1000,
        "num.broker.metrics.windows": 3,
        "metric.sampling.interval.ms": 1000,
        "execution.progress.check.interval.ms": 50,
        "optimizer.num.chains": 8,
        "optimizer.num.steps": 300,
        "proposal.expiration.ms": 1_000_000,
    }
    props.update(extra)
    return props


def make_cc(tmp_path, sim=None, jax=False, **extra):
    """The recipe's façade over ``sim``: the port's on the CPU, or the JAX
    package's."""
    sim = sim or sim_cluster(JaxSim if jax else SimulatedCluster)
    clock = {"now": 0}
    kw = dict(clock=lambda: clock["now"], executor_waiter=lambda ms: sim.tick(int(ms)))
    if jax:
        cc = JaxCruiseControl(JaxConfig(recipe(tmp_path, **extra)), admin=JaxAdmin(sim), **kw)
    else:
        cc = CruiseControl(CruiseControlConfig(recipe(tmp_path, **extra)),
                           admin=SimulatedAdminClient(sim), device="cpu", **kw)
    cc.start_up(run_background_threads=False)
    for _ in range(5):
        clock["now"] += 1000
        cc.load_monitor.sample_once()
    return cc, sim, clock


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both façades on the recipe's skewed cluster at the same small SA
    budget, and one dry run each."""
    jcc, _, _ = make_cc(tmp_path_factory.mktemp("jax"), sim_cluster(JaxSim, skewed=True),
                        jax=True, **FAST)
    tcc, _, _ = make_cc(tmp_path_factory.mktemp("port"),
                        sim_cluster(SimulatedCluster, skewed=True), **FAST)
    out = {"jax": jcc, "port": tcc, "jax_dry": jcc.rebalance(dryrun=True, reason="parity"),
           "port_dry": tcc.rebalance(dryrun=True, reason="parity")}
    yield out
    jcc.shutdown()
    tcc.shutdown()


def _close(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert np.isclose(a, b, rtol=RTOL, atol=ATOL), (where, a, b)
    else:
        assert a == b, (where, a, b)


#: blocks whose contents are not a schema: the last optimizer run's span
#: tree (the port's spans carry a ``compile`` block only where a kernel
#: build ran; JAX's wherever XLA compiled), and maps keyed by what the
#: process has seen so far (fleet jobs; device-memory classes and reasons)
OPAQUE = {"lastSpanTree", "convergence", "residentBytes", "residentCount", "evictions"}


def _keys(a, b, where):
    """``a`` and ``b`` have the same keys, at every level of nested dicts."""
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict) and isinstance(b[k], dict) and k not in OPAQUE:
            _keys(a[k], b[k], f"{where}.{k}")


def test_monitor_model_arrays_equal(pair):
    jm, jmd, jgen = pair["jax"]._model()
    tm, tmd, tgen = pair["port"]._model()
    assert str(jgen) == str(tgen)
    assert [repr(p) for p in tmd.partitions] == [repr(p) for p in jmd.partitions]
    assert (tm.num_topics, tm.num_racks) == (int(jm.num_topics), int(jm.num_racks))
    for name in TENSOR_FIELDS:
        want, got = np.asarray(getattr(jm, name)), getattr(tm, name).cpu().numpy()
        assert got.shape == want.shape, name
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_load_partition_load_and_cluster_state_agree(pair):
    jcc, tcc = pair["jax"], pair["port"]
    _close(jcc.load(), tcc.load(), "load")
    for kw in ({"max_entries": 5}, {"max_entries": 100, "resource": "DISK", "topic": "t.*"}):
        _close(jcc.partition_load(**kw), tcc.partition_load(**kw), f"partition_load{kw}")
    assert tcc.kafka_cluster_state() == jcc.kafka_cluster_state()
    with pytest.raises(UserRequestException):
        tcc.partition_load(resource="GPU")


def test_state_has_the_jax_keys_in_every_substate(pair):
    jst, tst = pair["jax"].state(), pair["port"].state()
    _keys(jst, tst, "state")
    assert tst["MonitorState"]["state"] == "RUNNING"
    assert tst["ExecutorState"]["state"] == "NO_TASK_IN_PROGRESS"
    assert tst["AnalyzerState"]["backend"] == "tpu"
    from ccx_torch.sidecar.wire import WIRE_VERSION

    assert tst["AnalyzerState"]["sidecarWireVersion"] == WIRE_VERSION
    sub = pair["port"].state(("monitor",))
    assert set(sub) == {"version", "MonitorState"}


@pytest.mark.parametrize("variant", [{}, {"leadership_only": True}, {"disk_only": True}])
def test_optimizer_options_from_the_config_equal_the_jax_facades(pair, variant):
    want = pair["jax"]._optimize_options(**variant)
    got = pair["port"]._optimize_options(**variant)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


def test_dry_run_verifies_with_the_jax_result_keys(pair):
    jdry, tdry = pair["jax_dry"], pair["port_dry"]
    assert tdry["verified"] and tdry["dryRun"] and tdry["numReplicaMovements"] > 0
    assert "executionStarted" not in tdry
    assert not [g for g in tdry["goalSummary"] if g["hard"] and g["violationsAfter"] > 0]
    assert set(tdry) == set(jdry)
    assert [g["goal"] for g in tdry["goalSummary"]] == [g["goal"] for g in jdry["goalSummary"]]
    assert tdry["provisionStatus"].keys() == jdry["provisionStatus"].keys()


def test_rebalance_executes_and_spreads_the_replicas(tmp_path):
    cc, sim, _ = make_cc(tmp_path, sim_cluster(SimulatedCluster, skewed=True), **FAST)
    wet = cc.rebalance(dryrun=False, reason="test")
    assert wet["executionStarted"] and wet["verified"]
    cc.executor.await_completion()
    per_broker = {b: 0 for b in range(4)}
    for p in sim._partitions.values():
        for b in p.replicas:
            per_broker[b] += 1
    assert max(per_broker.values()) - min(per_broker.values()) <= 2


def test_remove_brokers_evacuates(tmp_path):
    cc, sim, _ = make_cc(tmp_path, **FAST)
    res = cc.remove_brokers((3,), dryrun=False, reason="decommission")
    cc.executor.await_completion()
    assert 3 not in {b for p in sim._partitions.values() for b in p.replicas}
    assert res["verified"]


def test_add_brokers_moves_load_onto_the_new_one(tmp_path):
    sim = sim_cluster(SimulatedCluster, n_brokers=3, partitions=9, rf=1)
    sim.add_broker(3, rack="r1")
    sim._generation += 1
    cc, _, _ = make_cc(tmp_path, sim, **FAST)
    res = cc.add_brokers((3,), dryrun=False, reason="scale out")
    cc.executor.await_completion()
    assert sum(1 for p in sim._partitions.values() if 3 in p.replicas) > 0
    for prop in res["proposals"]:
        assert set(prop["newReplicas"]) - set(prop["oldReplicas"]) <= {3}


def test_demote_brokers_sheds_leadership_only(tmp_path):
    cc, sim, _ = make_cc(tmp_path, **FAST)
    res = cc.demote_brokers((0,), dryrun=False, reason="maintenance")
    cc.executor.await_completion()
    assert 0 not in {p.leader for p in sim._partitions.values()}
    for prop in res["proposals"]:
        assert sorted(prop["oldReplicas"]) == sorted(prop["newReplicas"])


def test_fix_offline_replicas_moves_them_off_the_dead_broker(tmp_path):
    cc, sim, clock = make_cc(tmp_path, **FAST)
    sim.kill_broker(2)
    clock["now"] += 1000
    cc.load_monitor.sample_once()
    res = cc.fix_offline_replicas(dryrun=False, reason="broker died")
    cc.executor.await_completion()
    assert res["verified"]
    assert 2 not in {b for p in sim._partitions.values() for b in p.replicas}


def test_rebalance_disk_keeps_replicas_on_their_brokers(tmp_path):
    sim = sim_cluster(SimulatedCluster)
    for part in sim._partitions.values():
        part.dirs = [0] * len(part.replicas)
    sim._generation += 1
    cc, _, _ = make_cc(tmp_path, sim, **FAST)
    res = cc.rebalance(rebalance_disk=True, dryrun=True)
    assert res["verified"] and res["dryRun"]
    for prop in res["proposals"]:
        assert prop["oldReplicas"] == prop["newReplicas"]


def test_greedy_backend_proposes_moves(tmp_path):
    cc, _, _ = make_cc(tmp_path, sim_cluster(SimulatedCluster, skewed=True),
                       **{"goal.optimizer.backend": "greedy"})
    res = cc.rebalance(dryrun=True)
    assert res["numReplicaMovements"] > 0 and res["verified"]


def test_mesh_asked_for_on_the_cpu_runs_on_one_device(tmp_path):
    cc, _, _ = make_cc(tmp_path, sim_cluster(SimulatedCluster, skewed=True),
                       **{"optimizer.mesh.enabled": True}, **FAST)
    mesh = cc.state(("analyzer",))["AnalyzerState"]["observability"]["mesh"]
    assert mesh["enabled"] and mesh["meshShape"] is None
    assert mesh["shardedPrograms"] == {"run": 0, "eval": 0, "max": 0}
    res = cc.rebalance(dryrun=True)
    assert res["verified"] and "mesh" not in res


def test_mesh_over_two_cards_is_refused(tmp_path, monkeypatch):
    from ccx_torch.config.definition import ConfigException

    cc, _, _ = make_cc(tmp_path, **{"optimizer.mesh.enabled": True})
    monkeypatch.setattr(CruiseControl, "_mesh_devices", lambda self: 2)
    mesh = cc.state(("analyzer",))["AnalyzerState"]["observability"]["mesh"]
    assert mesh["meshShape"] == {"chains": 2, "parts": 1} and "sharding" in mesh["refused"]
    with pytest.raises(ConfigException, match="sharding"):
        cc.rebalance(dryrun=True)


def test_cost_and_profile_keys_reach_the_ports_modules(tmp_path, monkeypatch):
    from ccx_torch.common import costmodel, profiling

    traced = []
    real_trace = profiling.trace

    def spy(log_dir):
        traced.append(log_dir)
        return real_trace(None)

    monkeypatch.setattr(profiling, "trace", spy)
    try:
        cc, _, _ = make_cc(tmp_path, **{
            "observability.cost.capture": True, "observability.cost.peak.tflops": 100.0,
            "observability.cost.hbm.gbps": 2000.0, "optimizer.fleet.snapshot.hbm.mb": 512,
            "optimizer.profile.dir": str(tmp_path / "traces"),
            "goal.optimizer.backend": "greedy"})
        assert costmodel.capture_enabled()
        assert costmodel.fleet_snapshot_budget_bytes() == 512_000_000
        assert costmodel.device_spec()["peakFlops"] == 100e12
        assert costmodel.device_spec()["hbmBytesPerSec"] == 2000e9
        cc.rebalance(dryrun=True)
        assert traced == [str(tmp_path / "traces")]
    finally:
        costmodel.set_capture(None)
        costmodel.set_device_override(0.0, 0.0)
        costmodel.set_fleet_hbm_budget(None)
