"""The port's detectors against the JAX package's, on the CPU.

Each scenario of the JAX package's ``tests/test_detector.py`` (its
``make_stack`` fixture: a load monitor over a 4-broker simulated cluster and
an anomaly-detector manager whose façade records the verbs it is asked for)
runs on both packages, the port's monitor on the CPU: every round's
decisions (anomaly type, description and detection time, action), the
façade verbs the manager fires with their arguments, and the manager's
state must be equal. The goal-violation scenarios reach the port's stack
evaluation (``GoalViolationDetector``), the stream scenarios its stream
detector, warm store and tracer. The JAX side runs once, in a module
fixture.
"""

from __future__ import annotations

import pytest

import ccx.config as jconfig
import ccx.detector.anomalies as janomalies
import ccx.detector.manager as jmanager
import ccx.executor.admin as jadmin
import ccx.monitor.load_monitor as jmonitor
import ccx_torch.config as tconfig
import ccx_torch.detector.anomalies as tanomalies
import ccx_torch.detector.manager as tmanager
import ccx_torch.executor.admin as tadmin
import ccx_torch.monitor.load_monitor as tmonitor

PACKAGES = {
    "jax": (jconfig, janomalies, jmanager, jadmin, jmonitor, {}),
    "port": (tconfig, tanomalies, tmanager, tadmin, tmonitor, {"device": "cpu"}),
}


class RecordingFacade:
    """Fake of the façade verbs the fix path invokes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, args, kwargs))
        return record


def make_stack(pkg, tmp_path, n_brokers=4, partitions=8, rf=2, skew=False, **extra):
    config, anomalies, manager, admin, monitor, kw = PACKAGES[pkg]
    sim = admin.SimulatedCluster()
    for b in range(n_brokers):
        sim.add_broker(b, rack=f"r{b % 2}", num_disks=2)
    sim.create_topic("t0", partitions, rf)
    if skew:
        for part in sim._partitions.values():
            part.replicas, part.leader, part.dirs = [0], 0, [0]
        sim._generation += 1
    props = {
        "metric.sampler.class": "ccx.monitor.sampling.sampler.SyntheticMetricSampler",
        "broker.capacity.config.resolver.class": "ccx.monitor.capacity.StaticCapacityResolver",
        "sample.store.dir": str(tmp_path / pkg / "samples"),
        "partition.metrics.window.ms": 1000,
        "num.partition.metrics.windows": 3,
        "broker.metrics.window.ms": 1000,
        "num.broker.metrics.windows": 3,
        "metric.sampling.interval.ms": 1000,
        "target.topic.replication.factor": 2,
        "self.healing.enabled": "true",
        "broker.failure.alert.threshold.ms": 2000,
        "broker.failure.self.healing.threshold.ms": 5000,
        **extra,
    }
    cfg = config.CruiseControlConfig(props)
    clock = {"now": 0}
    lm = monitor.LoadMonitor(cfg, admin.SimulatedAdminClient(sim), clock=lambda: clock["now"],
                             **kw)
    lm.start_up(run_sampling_loop=False)
    facade = RecordingFacade()
    mgr = manager.AnomalyDetectorManager(cfg, lm, facade, clock=lambda: clock["now"])
    return mgr, lm, sim, clock, facade, anomalies.AnomalyType


def run_windows(lm, clock, n=5):
    for _ in range(n):
        clock["now"] += 1000
        lm.sample_once()


def _plain(x):
    """JSON-like values with anomaly ids dropped (they are random)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k != "anomalyId"}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def scenario(pkg: str, name: str, tmp_path) -> dict:
    """One scenario of the JAX package's detector tests: each round's
    decisions, the verbs fired, and the manager's state."""
    rounds = []
    if name == "goal-violation-skewed":
        mgr, lm, sim, clock, facade, T = make_stack(
            pkg, tmp_path, partitions=12, rf=1, skew=True, **{"max.replicas.per.broker": 5})
        run_windows(lm, clock)
        rounds.append(mgr.run_once([T.GOAL_VIOLATION]))
    elif name == "goal-violation-balanced":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path)
        run_windows(lm, clock)
        rounds.append(mgr.run_once([T.GOAL_VIOLATION]))
    elif name == "broker-failure-grace-then-fix":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path)
        run_windows(lm, clock)
        sim.kill_broker(3)
        for step in (0, 3000, 3000):
            clock["now"] += step
            rounds.append(mgr.run_once([T.BROKER_FAILURE]))
    elif name == "broker-recovery":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path)
        run_windows(lm, clock)
        sim.kill_broker(2)
        rounds.append(mgr.run_once([T.BROKER_FAILURE]))
        sim.restart_broker(2)
        clock["now"] += 10_000
        rounds.append(mgr.run_once([T.BROKER_FAILURE]))
    elif name == "disk-failure":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path)
        run_windows(lm, clock)
        sim.fail_disk(1, 0)
        rounds.append(mgr.run_once([T.DISK_FAILURE]))
    elif name == "topic-anomaly":
        mgr, lm, sim, clock, facade, T = make_stack(
            pkg, tmp_path, **{"target.topic.replication.factor": 3})
        run_windows(lm, clock)
        rounds.append(mgr.run_once([T.TOPIC_ANOMALY]))
    elif name == "slow-broker":
        mgr, lm, sim, clock, facade, T = make_stack(
            pkg, tmp_path, **{"slow.broker.bytes.in.rate.detection.threshold": 10.0})
        run_windows(lm, clock, n=4)
        lm.sampler.broker_latency_overrides[2] = 5000.0
        run_windows(lm, clock, n=2)
        rounds.append(mgr.run_once([T.METRIC_ANOMALY]))
    elif name == "maintenance-event":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path, **{
            "maintenance.event.reader.class":
                "ccx.detector.detectors.QueueMaintenanceEventReader"})
        run_windows(lm, clock)
        mgr.detectors[T.MAINTENANCE_EVENT].reader.add({"type": "REMOVE_BROKER",
                                                       "brokers": [1]})
        rounds.append(mgr.run_once([T.MAINTENANCE_EVENT]))
    elif name == "self-healing-disabled":
        mgr, lm, sim, clock, facade, T = make_stack(
            pkg, tmp_path, **{"self.healing.enabled": "false"})
        run_windows(lm, clock)
        sim.fail_disk(0, 1)
        rounds.append(mgr.run_once([T.DISK_FAILURE]))
    elif name == "all-detectors":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path)
        run_windows(lm, clock)
        sim.kill_broker(1)
        rounds.append(mgr.run_once())
    elif name == "stream-verbs":
        mgr, lm, sim, clock, facade, T = make_stack(pkg, tmp_path)
        rounds.append(mgr.observe_stream("c0", {"warm": True, "verified": True, "wall_s": 0.1,
                                                "dead_brokers": (2, 3)}, t_s=1.0))
        rounds.append(mgr.observe_stream("c1", {"verified": False}, t_s=2.0))
    elif name == "stream-poll-rounds":
        mgr, lm, sim, clock, facade, T = make_stack(
            pkg, tmp_path, **{"detector.stream.clean.windows": 1})
        run_windows(lm, clock)
        rounds.append(mgr.run_once([T.BROKER_FAILURE]))
        sim.kill_broker(3)
        rounds.append(mgr.run_once([T.BROKER_FAILURE]))
        clock["now"] += 6000
        rounds.append(mgr.run_once([T.BROKER_FAILURE]))
        sim.restart_broker(3)
        clock["now"] += 1000
        rounds.append(mgr.run_once([T.BROKER_FAILURE]))
    else:
        raise ValueError(name)
    return _plain({"rounds": rounds, "calls": facade.calls, "state": mgr.state(),
                   "started": mgr.num_self_healing_started})


SCENARIOS = ("goal-violation-skewed", "goal-violation-balanced",
             "broker-failure-grace-then-fix", "broker-recovery", "disk-failure",
             "topic-anomaly", "slow-broker", "maintenance-event", "self-healing-disabled",
             "all-detectors", "stream-verbs", "stream-poll-rounds")


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return {name: scenario("jax", name, tmp_path_factory.mktemp(name)) for name in SCENARIOS}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_the_jax_detectors(jax_records, name, tmp_path):
    got = scenario("port", name, tmp_path)
    assert got == jax_records[name]
    if name == "goal-violation-skewed":
        anomaly = got["rounds"][0][0]["anomaly"]
        assert anomaly["type"] == "GOAL_VIOLATION" and "ReplicaCapacityGoal" in anomaly["description"]
        assert got["calls"][0][0] == "rebalance" and got["calls"][0][2]["self_healing"] is True
    if name == "all-detectors":
        assert {d["anomaly"]["type"] for d in got["rounds"][0]} >= {"BROKER_FAILURE"}


def test_stream_healing_records_reach_the_ports_tracer(tmp_path):
    """The stream detector's timeline records go to the port's tracer (its
    sinks swallow errors, so a missing tracer method would pass silently)."""
    from ccx_torch.common.tracing import TRACER

    seen = []
    TRACER.add_listener(seen.append)
    try:
        mgr, *_ = make_stack("port", tmp_path)
        mgr.observe_stream("c0", {"warm": True, "verified": True, "wall_s": 0.1,
                                  "dead_brokers": (2, 3)}, t_s=1.0)
    finally:
        TRACER.remove_listener(seen.append)
    healing = [r for r in seen if r.get("ev") == "healing"]
    assert {"detected", "fired"} <= {r["phase"] for r in healing}
    assert all(r["cluster"] == "c0" for r in healing)
