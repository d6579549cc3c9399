"""The port's cost model, compile counters, profiling hooks and device
probe, on the CPU (rebuilt from the JAX package's ``test_costmodel.py``,
``test_profiling.py`` and ``test_device.py`` where the meaning carries).

* Counting per shape; capture off only counts; capture only inside a cold
  run; a capture error is recorded, never raised.
* Spec resolution (NVIDIA cards only; an unknown card has no roofline),
  the operator override, the roofline; projections count uncaptured calls
  and price the aggregates pass from its work without a capture.
* ``costModel`` rides every result, cold and warm, with or without
  capture; only an armed cold run adds records, with a ``cost-capture``
  phase; a repeat and a warm run add none; the phase spans carry the
  rollup.
* A span in which a kernel build ran carries a ``compile`` block; the
  sidecar's gauges are on the registry.
* ``trace`` writes a Chrome trace on the CPU with the optimizer's phase
  ranges in it, and does nothing without a directory.
* The device probe: healthy passes; failed and hung raise (never a CPU
  fallback); 0 disables it; invalid and negative timeouts give the default.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess

import pytest
import torch

from ccx_torch import device
from ccx_torch.common import compilestats, costmodel, profiling
from ccx_torch.common.metrics import REGISTRY
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.ops import broker_aggregates as agg_op
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search import incremental as tinc
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions

H100_SXM = "NVIDIA H100 80GB HBM3"
GOALS = ("StructuralFeasibility", "RackAwareGoal", "ReplicaDistributionGoal",
         "LeaderReplicaDistributionGoal")
SPEC = RandomClusterSpec(n_brokers=10, n_racks=3, n_topics=4, n_partitions=120, seed=5,
                         n_dead_brokers=1)
OPTS = OptimizeOptions(
    anneal=AnnealOptions(n_chains=2, n_steps=8, moves_per_step=2, chunk_steps=4),
    polish=GreedyOptions(n_candidates=8, max_iters=4, chunk_iters=2),
    require_hard_zero=False, run_cold_greedy=False, topic_rebalance_rounds=0,
)


@pytest.fixture(autouse=True)
def _clean_costmodel():
    """The ledger is process-wide: every test leaves it empty, capture on
    the env default and no override."""
    costmodel.reset()
    costmodel.set_device_override(0, 0)
    yield
    costmodel.reset()
    costmodel.set_capture(None)
    costmodel.set_device_override(0, 0)


# ----- counting and capture --------------------------------------------------------


def test_instrument_counts_per_shape():
    f = costmodel.instrument("unit-prog")(lambda x: (x * 2.0).sum())
    a = torch.ones(8, 8)
    f(a)
    f(a)
    f(torch.ones(16, 4))
    snap = costmodel.exec_snapshot()
    assert sorted(snap.values()) == [1, 2]
    assert all(k.startswith("unit-prog#") for k in snap)
    # a generator's identity never enters the signature
    g = costmodel.instrument("unit-gen")(lambda gen, x: x + 1)
    g(torch.Generator(), a)
    g(torch.Generator(), a)
    assert sorted(v for k, v in costmodel.exec_snapshot().items() if k.startswith("unit-gen")) == [2]


def test_capture_off_only_counts():
    costmodel.set_capture(False)
    f = costmodel.instrument("unit-off")(lambda x: x + 1)
    with costmodel.cold_window():
        f(torch.ones(4))
    assert costmodel.exec_snapshot()
    assert costmodel.pending_count() == 0 and costmodel.records() == {}


def test_capture_only_in_a_cold_window_and_once_per_shape():
    costmodel.set_capture(True)
    f = costmodel.instrument("unit-cap")(lambda x: (x @ x).sum())
    f(torch.ones(32, 32))
    assert costmodel.pending_count() == 0          # not a cold run
    with costmodel.cold_window():
        f(torch.ones(32, 32))
        f(torch.ones(32, 32))
    assert costmodel.pending_count() == 1
    assert costmodel.capture_pending() == 1
    (rec,) = costmodel.records().values()
    assert rec["error"] is None and rec["timer"] == "host-clock" and rec["seconds"] > 0
    assert rec["peakBytes"] is None                # no allocator on the CPU
    with costmodel.cold_window():
        f(torch.ones(32, 32))
    assert costmodel.pending_count() == 0


def test_capture_error_is_recorded_not_raised(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("allocator says no")

    monkeypatch.setattr(torch.cuda, "memory_allocated", fail)
    out = costmodel._capture_call("k#1", "lbl", torch.device("cuda", 0), lambda x: x + 1,
                                  (torch.ones(2),), {})
    assert torch.equal(out, torch.full((2,), 2.0))
    assert costmodel.capture_pending() == 1
    rec = costmodel.records()["k#1"]
    assert "allocator says no" in rec["error"] and rec["seconds"] is None

    def boom(x):
        raise ValueError("the call's own error")

    with pytest.raises(ValueError, match="own error"):
        costmodel._capture_call("k#2", "lbl", torch.device("cpu"), boom, (torch.ones(2),), {})


# ----- specs and projections -------------------------------------------------------


def test_spec_resolution_and_roofline_bounds():
    assert costmodel.spec_for(H100_SXM)["key"] == "h100-sxm"
    assert costmodel.spec_for("NVIDIA H100 PCIe")["key"] == "h100-pcie"
    assert costmodel.spec_for("NVIDIA H100 PCIe")["hbmBytesPerSec"] < costmodel.spec_for(
        H100_SXM)["hbmBytesPerSec"]
    for unknown in ("cpu", "NVIDIA A10", "quantum-abacus"):
        assert costmodel.spec_for(unknown) is None
    cpu = costmodel.device_spec(torch.device("cpu"))
    assert cpu["key"] is None and cpu["source"] == "unknown" and cpu["deviceKind"] == "cpu"
    spec = {"peakFlops": 100.0, "hbmBytesPerSec": 10.0}
    assert costmodel.roofline_seconds(1000.0, 10.0, spec) == (10.0, "compute")
    assert costmodel.roofline_seconds(10.0, 1000.0, spec) == (100.0, "memory")
    assert costmodel.roofline_seconds(None, 1000.0, spec) == (100.0, "memory")
    assert costmodel.roofline_seconds(None, None, spec) == (None, None)
    assert costmodel.roofline_seconds(10.0, 10.0, cpu) == (None, None)


def test_device_override_wins():
    costmodel.set_device_override(peak_tflops=2.0, hbm_gbps=1.0)
    spec = costmodel.device_spec(torch.device("cpu"))
    assert (spec["peakFlops"], spec["hbmBytesPerSec"], spec["source"]) == (2.0e12, 1.0e9, "override")
    costmodel.set_device_override(0, 0)
    assert costmodel.device_spec(torch.device("cpu"))["source"] == "unknown"


def test_projection_counts_uncaptured_calls():
    p = costmodel.projection({"ghost-prog#abc": 3})
    assert p["coverage"] == {"programsExecuted": 1, "programsCaptured": 0, "callsUncaptured": 3}
    assert p["programs"]["ghost-prog"]["captured"] is False
    assert p["totals"]["flops"] is None


def test_aggregates_pass_is_priced_from_its_work_without_capture():
    m = random_cluster(SPEC, device="cpu")
    snap = costmodel.exec_snapshot()
    broker_aggregates(m)
    broker_aggregates(m)
    spec = costmodel.spec_for(H100_SXM)
    p = costmodel.projection(costmodel.exec_delta(snap), {"h100": spec})
    row = p["programs"]["broker-aggregates"]
    flops, nbytes = costmodel.aggregates_work(
        m.P, m.R, m.B, m.num_topics, m.D, int(m.partition_valid.sum()), int(m.replica_valid.sum()))
    assert (row["calls"], row["captured"]) == (2, False)
    assert (row["flops"], row["bytesAccessed"]) == (2 * flops, 2 * nbytes)
    bound_ms, bound_by = costmodel.aggregates_bound_ms(m, spec)
    assert row["boundMsPerCall"] == bound_ms and bound_by == "bytes"
    assert row["projectedSeconds"]["h100"] == pytest.approx(2 * bound_ms / 1e3, rel=1e-12)
    assert p["coverage"]["callsUncaptured"] == 2
    with pytest.raises(ValueError, match="spec"):
        costmodel.aggregates_bound_ms(m)           # the CPU has no roofline


# ----- the result's block -----------------------------------------------------------


def _phases(res) -> list[str]:
    return [c["name"] for c in res.span_tree["children"]]


def test_cost_model_rides_every_result_and_only_an_armed_cold_run_captures():
    m = random_cluster(SPEC, device="cpu")
    cfg = GoalConfig()
    plain = optimize(m, cfg, GOALS, OPTS)          # capture off
    assert plain.cost_model["coverage"]["callsUncaptured"] > 0
    assert "cost-capture" not in plain.phase_seconds and costmodel.records() == {}
    costmodel.set_capture(True)
    cold = optimize(m, cfg, GOALS, OPTS)
    assert "cost-capture" in _phases(cold) and costmodel.pending_count() == 0
    n_records = len(costmodel.records())
    assert n_records > 0
    cm = cold.cost_model
    assert set(cm) == {"device", "totals", "projected", "programs", "coverage", "phases"}
    assert cm["device"]["deviceKind"] == "cpu" and set(cm["projected"]) == {"device"}
    assert {"broker-aggregates", "stack-eval", "sa-chunk", "polish-chunk"} <= set(cm["programs"])
    assert cm["programs"]["sa-chunk"]["captured"] and cm["programs"]["sa-chunk"]["sampleSeconds"] > 0
    assert cm["phases"]["anneal"]["calls"] >= 1
    anneal = next(c for c in cold.span_tree["children"] if c["name"] == "anneal")
    assert anneal["costModel"]["calls"] >= 1
    assert cold.to_json(include_proposals=False)["costModel"] is cm
    repeat = optimize(m, cfg, GOALS, OPTS)         # the same shapes: nothing new
    assert "cost-capture" not in _phases(repeat) and len(costmodel.records()) == n_records
    warm_opts = dataclasses.replace(OPTS, incremental=tinc.IncrementalOptions(enabled=True))
    warm = optimize(cold.model, cfg, GOALS, warm_opts,
                    warm_start=tinc.remember("obs-warm", 1, cold.model, cfg))
    tinc.STORE.drop("obs-warm")
    assert warm.incremental["warmStart"]
    assert "cost-capture" not in _phases(warm) and len(costmodel.records()) == n_records
    assert {"warm-init", "warm-finish"} & set(warm.cost_model["programs"])
    assert "costModel" in warm.to_json(include_proposals=False)


# ----- compile counters and gauges -------------------------------------------------


def test_a_span_in_which_a_build_ran_carries_a_compile_block(tmp_path, monkeypatch):
    monkeypatch.setattr(agg_op, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(agg_op, "_nvcc", lambda: "nvcc")

    def fake_nvcc(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(agg_op.subprocess, "run", fake_nvcc)
    with TRACER.span("kernel-build") as s:
        agg_op.build()
    block = s.to_json()["compile"]
    assert block["backend_compiles"] == 1 and block["persistent_misses"] == 1
    with TRACER.span("kernel-build") as s:
        assert agg_op.build() == ""                # the cache serves it
    assert s.to_json()["compile"] == {"backend_compiles": 0, "backend_compile_secs": 0,
                                      "persistent_hits": 1, "persistent_misses": 0}
    with TRACER.span("no-build") as s:
        pass
    assert "compile" not in s.to_json()
    with compilestats.attributed("unit-build"):
        agg_op.build()
    assert compilestats.attribution()["unit-build"]["persistent_hits"] == 1


def test_sidecar_gauges_are_on_the_registry():
    from ccx_torch.sidecar import server

    server.export_gauges()
    text = REGISTRY.render_prometheus()
    for name in ("compile_backend_compiles", "compile_backend_compile_secs",
                 "compile_persistent_hits", "compile_persistent_misses",
                 "cost_programs_captured", "cost_programs_pending",
                 "cost_projected_device_seconds"):
        assert f"\nccx_{name} " in text, name


# ----- profiling ----------------------------------------------------------------------


def test_trace_noop_without_dir():
    for log_dir in ("", None):
        with profiling.trace(log_dir) as started:
            assert started is False


def test_trace_writes_a_chrome_trace_with_the_phase_ranges(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as started:
        assert started is True
        with profiling.trace(log_dir) as inner:  # nested: the outer keeps going
            assert inner is False
        optimize(random_cluster(SPEC, device="cpu"), GoalConfig(), GOALS, OPTS)
    (path,) = glob.glob(os.path.join(log_dir, "ccx-trace-*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ccx:anneal", "ccx:polish", "ccx:verify"} <= names


# ----- the device probe ----------------------------------------------------------------


class FakeProbe:
    def __init__(self, rc=None, hang=False):
        self._rc = rc
        self._hang = hang
        self.calls = []

    @property
    def returncode(self):
        return self._rc

    def wait(self, timeout=None):
        self.calls.append(("wait", timeout))
        if self._hang and ("terminate",) not in self.calls:
            raise subprocess.TimeoutExpired(cmd="probe", timeout=timeout)
        return self._rc

    def communicate(self, timeout=None):
        self.calls.append(("communicate", timeout))
        if self._hang:
            raise subprocess.TimeoutExpired(cmd="probe", timeout=timeout)
        return "", None

    def poll(self):
        return self._rc

    def terminate(self):
        self.calls.append(("terminate",))
        self._rc = -15

    def kill(self):
        self.calls.append(("kill",))
        self._rc = -9


@pytest.fixture
def probe(monkeypatch):
    monkeypatch.delenv(device.ENV_PROBE_TIMEOUT, raising=False)

    def install(fake):
        monkeypatch.setattr(device.subprocess, "Popen", lambda *a, **k: fake)
        return fake

    return install


def test_healthy_probe_passes(probe):
    fake = probe(FakeProbe(rc=0))
    assert device.ensure_responsive_backend(timeout_s=5) is True
    assert ("terminate",) not in fake.calls


def test_failed_probe_raises(probe):
    probe(FakeProbe(rc=3))
    with pytest.raises(device.DeviceUnresponsive, match="exited with 3"):
        device.ensure_responsive_backend(timeout_s=5)


def test_hung_probe_is_terminated_with_grace_and_raises(probe):
    fake = probe(FakeProbe(hang=True))
    with pytest.raises(device.DeviceUnresponsive, match="hung"):
        device.ensure_responsive_backend(timeout_s=5)
    assert ("terminate",) in fake.calls and ("kill",) not in fake.calls


def test_zero_timeout_disables_the_probe(probe, monkeypatch):
    monkeypatch.setenv(device.ENV_PROBE_TIMEOUT, "0")
    fake = probe(FakeProbe(rc=1))
    assert device.ensure_responsive_backend() is True
    assert fake.calls == []


@pytest.mark.parametrize("raw", ["60s", "-60"])
def test_invalid_or_negative_timeout_gives_the_default(probe, monkeypatch, raw):
    monkeypatch.setenv(device.ENV_PROBE_TIMEOUT, raw)
    fake = probe(FakeProbe(rc=0))
    assert device.ensure_responsive_backend() is True
    assert ("communicate", device.DEFAULT_PROBE_TIMEOUT_S) in fake.calls


def test_a_host_without_a_card_fails_the_real_probe():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: its probe passes")
    with pytest.raises(device.DeviceUnresponsive, match="exited with"):
        device.ensure_responsive_backend(timeout_s=120)
