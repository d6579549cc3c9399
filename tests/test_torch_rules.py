"""Rules of the PyTorch/CUDA port that need no JAX: its import boundary, its
default device, and the kernel wrapper's dispatch.

This file imports only torch and ``ccx_torch``, so on a machine with a card
(where JAX is not installed) its GPU tests run with
``python -m pytest --noconftest tests/test_torch_rules.py -m gpu``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest
import torch

from ccx_torch import device as device_mod
from ccx_torch.model import fixtures
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.model.tensor_model import model_arrays, model_from_arrays
from ccx_torch.ops import broker_aggregates as agg_op

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "ccx")


def _port_sources() -> list[Path]:
    return sorted((ROOT / "ccx_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "time_torch_aggregates.py",
        ROOT / "tools" / "torch_lean_samples.py", ROOT / "tools" / "rehearse_service.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_serving_modules_load_neither_jax_nor_the_jax_package_nor_grpc():
    """Importing the sidecar's server, the fleet scheduler and the tracer
    in a fresh interpreter loads no ``jax`` and no ``ccx.*`` module, and
    the server imports ``grpc`` only when a server is made."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import ccx_torch.sidecar.server, ccx_torch.search.scheduler, ccx_torch.common.tracing\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ccx' or m.startswith('ccx.'))\n"
        "assert not bad, bad\n"
        "assert 'grpc' not in sys.modules, 'grpc imported at import time'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


#: names of TPU parts and their spec rows: no port source may carry a TPU's
#: spec or number (the cost model's table holds NVIDIA cards only)
TPU_SPEC = re.compile(r"(?i)tpu[-_ ]?v\d|\bv[4-7][ep]?\b.*\b(tpu|lite)\b|\bv5[ep]\b|v5 ?lite|\bv6e\b|trillium")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_tpu_spec(path):
    hits = [ln for ln in path.read_text().splitlines() if TPU_SPEC.search(ln)]
    assert not hits, f"{path.relative_to(ROOT)} names a TPU spec: {hits[:3]}"


def test_tpu_spec_scan_sees_the_jax_tables():
    from ccx_torch.common import costmodel

    text = (ROOT / "ccx" / "common" / "costmodel.py").read_text()
    assert sum(bool(TPU_SPEC.search(ln)) for ln in text.splitlines()) >= 4
    assert not any(TPU_SPEC.search(k) for k in costmodel.DEVICE_SPECS)


def test_import_scan_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom ccx.goals import base\nimport ccx_torch\n")
    assert _imported_roots(src) & set(FORBIDDEN) == {"jax", "ccx"}


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        fixtures.small_deterministic()
    with pytest.raises(RuntimeError, match="CUDA"):
        fixtures.random_cluster(fixtures.RandomClusterSpec(n_partitions=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda")
    assert fixtures.small_deterministic(device="cpu").device.type == "cpu"


def test_cpu_model_takes_the_plain_path_without_launching(monkeypatch):
    monkeypatch.setattr(agg_op, "LAUNCHES", 0)
    m = fixtures.random_cluster(fixtures.bench_spec("B4"), device="cpu")
    got = broker_aggregates(m)
    ref = agg_op.broker_aggregates_plain(m)
    assert agg_op.LAUNCHES == 0
    assert torch.equal(got.replica_count, ref.replica_count)
    assert torch.equal(got.broker_load, ref.broker_load)


def test_kernel_wrapper_refuses_a_cpu_model():
    m = fixtures.small_deterministic(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        agg_op.broker_aggregates_cuda(m)
    with pytest.raises(ValueError, match="CUDA"):
        agg_op.plan(m)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


#: sparse clusters: B pads to 4096, and to 8192, where rows in shared memory
#: need broker tiles
WIDE = {
    "4000-brokers": fixtures.RandomClusterSpec(
        n_brokers=4000, n_racks=40, n_topics=64, n_partitions=8000, n_dead_brokers=3, seed=7
    ),
    "8000-brokers": fixtures.RandomClusterSpec(
        n_brokers=8000, n_racks=40, n_topics=64, n_partitions=16000, n_dead_brokers=3, seed=8
    ),
}
INT_FIELDS = ("replica_count", "leader_count", "topic_replica_count", "topic_leader_count")
FLOAT_FIELDS = ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load")


def _assert_matches_plain(got, m):
    ref = agg_op.broker_aggregates_plain(m)
    for f in INT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in FLOAT_FIELDS:
        # atomics sum in a run-dependent order
        torch.testing.assert_close(getattr(got, f), getattr(ref, f), rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["B3", "B4", "4000-brokers", "8000-brokers", "B6"])
def test_kernel_matches_plain_on_card(name):
    dev = _card()
    spec = WIDE[name] if name in WIDE else fixtures.bench_spec(name)
    m = fixtures.random_cluster(spec, device=dev)
    before = agg_op.LAUNCHES
    got = broker_aggregates(m)
    torch.cuda.synchronize()
    assert agg_op.LAUNCHES == before + 1
    _assert_matches_plain(got, m)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["shared", "global"])
@pytest.mark.parametrize("name", ["B3", "B4", "4000-brokers", "8000-brokers"])
def test_kernel_row_ways_match_plain_on_card(name, rows):
    """Each way of summing the per-broker rows, forced: in shared memory
    (broker tiles at 8000 brokers) and straight into the output."""
    dev = _card()
    spec = WIDE[name] if name in WIDE else fixtures.bench_spec(name)
    m = fixtures.random_cluster(spec, device=dev)
    plan = agg_op.plan(m, rows)
    assert plan["rows"] == rows
    if name == "8000-brokers" and rows == "shared":
        assert plan["tiles"] > 1
    got = agg_op.broker_aggregates_cuda(m, rows)
    torch.cuda.synchronize()
    _assert_matches_plain(got, m)


@pytest.mark.gpu
def test_kernel_chooses_its_rows_from_the_input():
    """Shared rows for B5's 100k partitions on 1024 brokers; global rows for
    8000 partitions on 4096."""
    dev = _card()
    b5 = fixtures.random_cluster(fixtures.bench_spec("B5"), device=dev)
    wide = fixtures.random_cluster(WIDE["4000-brokers"], device=dev)
    assert agg_op.plan(b5)["rows"] == "shared"
    assert agg_op.plan(wide)["rows"] == "global"


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["B5-shuffled", "two-in-a-row"])
def test_kernel_matches_plain_on_card_b5(case):
    """B5 with its partition axis in a seeded random order (so the topic
    index groups unsorted topics), and two calls in a row on two B5-shaped
    models, the second reusing the first's freed output buffer."""
    dev = _card()
    b5 = fixtures.random_cluster(fixtures.bench_spec("B5"), device=dev)
    first = broker_aggregates(b5)
    _assert_matches_plain(first, b5)
    if case == "B5-shuffled":
        m = fixtures.shuffled_partitions(b5, seed=5)
        got = broker_aggregates(m)
        for f in INT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(first, f)), f
    else:
        relabel = torch.randperm(b5.B, generator=torch.Generator().manual_seed(5))
        relabel = relabel.int().to(dev)
        m = b5.replace(assignment=torch.where(
            b5.assignment >= 0, relabel[b5.assignment.clamp(min=0).long()], -1).int())
        first_ptr = first.topic_replica_count.data_ptr()
        del first
        # the freed buffer, filled with a non-zero pattern before the second
        # call gets it
        words = agg_op.output_layout(b5.B, b5.num_topics, b5.D)[1]
        junk = torch.full((words,), -7, dtype=torch.int32, device=dev)
        assert junk.data_ptr() == first_ptr
        del junk
        got = broker_aggregates(m)
        assert got.topic_replica_count.data_ptr() == first_ptr
    torch.cuda.synchronize()
    _assert_matches_plain(got, m)


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_inputs_on_card():
    dev = _card()
    m = fixtures.random_cluster(fixtures.bench_spec("B3"), device=dev)
    arrays = model_arrays(m)
    with pytest.raises(ValueError, match="contiguous"):
        agg_op.broker_aggregates_cuda(m.replace(assignment=m.assignment.t().contiguous().t()))
    with pytest.raises(ValueError, match="dtype"):
        agg_op.broker_aggregates_cuda(m.replace(leader_slot=m.leader_slot.long()))
    host = model_from_arrays(arrays, m.num_topics, m.num_racks, "cpu")
    with pytest.raises(ValueError, match="expected cuda"):
        agg_op.broker_aggregates_cuda(m.replace(leader_load=host.leader_load))


#: the JAX package's 1/10-scale B5 lean ceilings (tests/test_quality_b5_shape.py),
#: copied: this file must not import the JAX package
LEAN_CEILINGS = {
    "ReplicaDistributionGoal": 10, "PotentialNwOutGoal": 200, "DiskUsageDistributionGoal": 20,
    "NetworkInboundUsageDistributionGoal": 20, "NetworkOutboundUsageDistributionGoal": 20,
    "CpuUsageDistributionGoal": 30, "TopicReplicaDistributionGoal": 2000,
    "LeaderReplicaDistributionGoal": 30, "LeaderBytesInDistributionGoal": 50,
    "PreferredLeaderElectionGoal": 0,
}


@pytest.mark.gpu
def test_lean_quality_envelope_on_card():
    """The lean stages at 1/10 scale of B5 on the card, with the effort of
    the JAX package's own lean check: verified, hard zero, every tier under
    its ceilings, replica swaps accepted."""
    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.optimizer import OptimizeOptions, optimize
    from ccx_torch.search.annealer import AnnealOptions
    from ccx_torch.search.greedy import GreedyOptions

    dev = _card()
    m = fixtures.random_cluster(fixtures.RandomClusterSpec(
        n_brokers=100, n_racks=10, n_topics=50, n_partitions=10_000, n_dead_brokers=2, seed=7),
        device=dev)
    res = optimize(m, GoalConfig(), opts=OptimizeOptions(
        anneal=AnnealOptions(n_chains=8, n_steps=200, moves_per_step=8, seed=42),
        polish=GreedyOptions(n_candidates=256, max_iters=200, patience=16),
        run_polish=False, run_cold_greedy=False, topic_rebalance_rounds=1,
        topic_rebalance_max_sweeps=1024, topic_rebalance_move_leaders=True,
        topic_rebalance_polish_iters=200, leader_pass_max_iters=60,
        swap_polish_iters=60, swap_polish_post_iters=100,
    ))
    assert res.verification.ok, res.verification.failures
    assert float(res.stack_after.hard_violations) == 0
    assert res.sa_engine == "batched"
    after = {n: float(v) for n, (v, _) in res.stack_after.by_name().items()}
    for goal, ceiling in LEAN_CEILINGS.items():
        assert after[goal] <= ceiling, (goal, after[goal], ceiling)
    assert res.move_counters["replicaSwap"]["accepted"] > 0, res.move_counters


@pytest.mark.slow
def test_b5_lean_rung_on_the_cpu():
    """B5 at the lean rung through the CPU path (the plain aggregates, the
    CPU generator): verified with zero hard violations. Prints the
    violations after, for holding the card's B5 lean result against the
    CPU's (``pytest -s``); minutes of CPU time, so slow."""
    from ccx_torch.optimizer import optimize
    from ccx_torch.rungs import build_opts

    goals, opts, _ = build_opts("B5", "lean")
    m = fixtures.random_cluster(fixtures.bench_spec("B5"), device="cpu")
    res = optimize(m, opts=opts, goal_names=goals)
    after = {n: int(v) for n, (v, _) in res.stack_after.by_name().items()}
    print({"b5_lean_cpu": after, "wall_seconds": res.wall_seconds,
           "move_counters": res.move_counters, "sa_engine": res.sa_engine})
    assert res.verification.ok, res.verification.failures
    assert float(res.stack_after.hard_violations) == 0


@pytest.mark.slow
@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_warm_quality_within_tolerance_of_from_scratch_downscaled_b5(where):
    """The JAX package's warm quality pin at 1/10 scale of B5 (100 brokers,
    10k partitions, the full default stack): after a 1% drift (+-50%), a
    warm re-proposal at the steady budget (``IncrementalOptions()``
    defaults) stays within 8 violations of a from-scratch run on the same
    snapshot on every metric-coupled tier, and TopicReplicaDistribution
    stays within 5% + 16 of the warm base. On the CPU and, where there is
    one, on the card."""
    import dataclasses

    import numpy as np

    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.optimizer import OptimizeOptions, optimize
    from ccx_torch.search import incremental as inc
    from ccx_torch.search.annealer import AnnealOptions
    from ccx_torch.search.greedy import GreedyOptions

    dev = _card() if where == "cuda" else "cpu"
    cfg = GoalConfig()
    cold_opts = OptimizeOptions(
        anneal=AnnealOptions(n_chains=8, n_steps=200, moves_per_step=8, seed=42, chunk_steps=200),
        polish=GreedyOptions(n_candidates=256, max_iters=200, patience=16),
        run_polish=False, run_cold_greedy=False, topic_rebalance_rounds=1,
        topic_rebalance_max_sweeps=1024, topic_rebalance_move_leaders=True,
        topic_rebalance_polish_iters=200, leader_pass_max_iters=60,
        swap_polish_iters=60, swap_polish_post_iters=100,
    )
    m = fixtures.random_cluster(fixtures.RandomClusterSpec(
        n_brokers=100, n_racks=10, n_topics=50, n_partitions=10_000, seed=7), device=dev)
    cold0 = optimize(m, cfg, opts=cold_opts)
    assert cold0.verification.ok, cold0.verification.failures
    inc.STORE.clear()
    warm = inc.remember("s-qual", 1, cold0.model, cfg)

    rng = np.random.default_rng(123)
    p_real = int(m.partition_valid.sum())
    idx = rng.choice(p_real, max(p_real // 100, 1), replace=False)
    ll = cold0.model.leader_load.cpu().numpy().copy()
    fl = cold0.model.follower_load.cpu().numpy().copy()
    s = rng.uniform(0.5, 1.5, size=(1, len(idx))).astype(np.float32)
    ll[:, idx] *= s
    fl[:, idx] *= s
    m2 = cold0.model.replace(leader_load=torch.from_numpy(ll).to(m.device),
                             follower_load=torch.from_numpy(fl).to(m.device))

    wopts = dataclasses.replace(cold_opts, incremental=inc.IncrementalOptions(enabled=True))
    res_w = optimize(m2, cfg, opts=wopts, warm_start=warm)
    assert res_w.verification.ok, res_w.verification.failures
    assert res_w.incremental["warmStart"] is True
    assert float(res_w.stack_after.hard_violations) == 0
    res_c = optimize(m2, cfg, opts=cold_opts)
    assert res_c.verification.ok, res_c.verification.failures

    wa = {n: float(v) for n, (v, _) in res_w.stack_after.by_name().items()}
    ca = {n: float(v) for n, (v, _) in res_c.stack_after.by_name().items()}
    print({"warm_quality": where, "warm": wa, "cold": ca, "warm_wall": res_w.wall_seconds,
           "cold_wall": res_c.wall_seconds, "incremental": res_w.incremental})
    metric_tiers = (
        "ReplicaDistributionGoal", "PotentialNwOutGoal", "DiskUsageDistributionGoal",
        "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
        "CpuUsageDistributionGoal", "LeaderReplicaDistributionGoal",
        "LeaderBytesInDistributionGoal", "PreferredLeaderElectionGoal",
    )
    for goal in metric_tiers:
        assert wa[goal] <= ca[goal] + 8, (goal, wa[goal], ca[goal])
    base_trd = float(res_w.stack_before.by_name()["TopicReplicaDistributionGoal"][0])
    assert wa["TopicReplicaDistributionGoal"] <= base_trd * 1.05 + 16, (
        wa["TopicReplicaDistributionGoal"], base_trd)


#: the JAX package's test recipe for a service, by its ``ccx.*`` class paths
#: (an operator's properties file may carry them too)
_CCX_RECIPE = (
    '{"metric.sampler.class": "ccx.monitor.sampling.sampler.SyntheticMetricSampler", '
    '"broker.capacity.config.resolver.class": "ccx.monitor.capacity.StaticCapacityResolver", '
    '"partition.metrics.window.ms": 1000, "num.partition.metrics.windows": 3, '
    '"broker.metrics.window.ms": 1000, "num.broker.metrics.windows": 3, '
    '"metric.sampling.interval.ms": 1000}'
)


@pytest.mark.parametrize("source", ["properties-file", "ccx-recipe"])
def test_booting_the_service_loads_neither_jax_nor_the_jax_package(source, tmp_path):
    """The port's façade and REST app, booted in a fresh interpreter from
    the repo's properties file or from a recipe naming ``ccx.*`` classes,
    answer ``state`` and load no ``jax`` and no ``ccx.*`` module."""
    import subprocess
    import sys

    if source == "properties-file":
        make_cfg = ("cfg = CruiseControlConfig.from_properties_file("
                    "'config/cruisecontrol.properties')\n")
    else:
        make_cfg = f"cfg = CruiseControlConfig({_CCX_RECIPE})\n"
    code = (
        "import sys\n"
        "from ccx_torch.config import CruiseControlConfig\n"
        "from ccx_torch.main import build_demo_admin\n"
        "from ccx_torch.service.facade import CruiseControl\n"
        "from ccx_torch.servlet.server import CruiseControlApp\n"
        "from ccx_torch.client import CruiseControlClient\n"
        + make_cfg +
        f"cfg = cfg.with_overrides(**{{'sample.store.dir': {str(tmp_path)!r},\n"
        "                             'webserver.http.port': 0})\n"
        "cc = CruiseControl(cfg, admin=build_demo_admin(), device='cpu')\n"
        "cc.start_up(run_background_threads=False)\n"
        "cc.load_monitor.sample_once()\n"
        "app = CruiseControlApp(cfg, cc)\n"
        "host, port = app.start()\n"
        "try:\n"
        "    st = CruiseControlClient(f'http://{host}:{port}').state()\n"
        "finally:\n"
        "    app.stop(); cc.shutdown()\n"
        "assert st['MonitorState']['state'] == 'RUNNING', st\n"
        "assert type(cc.load_monitor.capacity_resolver).__module__.startswith('ccx_torch.')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ccx'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300)


def test_resolve_class_maps_the_jax_packages_paths_to_the_port():
    from ccx_torch.config.definition import ConfigException, resolve_class
    from ccx_torch.monitor.capacity import StaticCapacityResolver

    assert resolve_class("ccx.monitor.capacity.StaticCapacityResolver") is StaticCapacityResolver
    assert resolve_class("ccx_torch.monitor.capacity.StaticCapacityResolver") is (
        StaticCapacityResolver)
    with pytest.raises(ConfigException):  # no counterpart in the port
        resolve_class("ccx.parallel.sharding.program_cache_stats")


def test_service_main_without_a_card_raises_and_serves_nothing(monkeypatch):
    from ccx_torch import main as main_mod

    served = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(main_mod.CruiseControlApp, "start", lambda self: served.append(self))
    with pytest.raises(RuntimeError, match="CUDA"):
        main_mod.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        main_mod.main(["--device", "cuda"])
    assert not served


def test_python_m_ccx_torch_on_the_cpu_serves_state(tmp_path):
    """``python -m ccx_torch PROPS --device cpu`` serves the REST API over
    the demo cluster and stops on SIGTERM."""
    import json
    import re
    import signal
    import subprocess
    import sys
    import urllib.request

    props = tmp_path / "cc.properties"
    props.write_text(
        "metric.sampler.class=ccx.monitor.sampling.sampler.SyntheticMetricSampler\n"
        "broker.capacity.config.resolver.class=ccx.monitor.capacity.StaticCapacityResolver\n"
        f"sample.store.dir={tmp_path / 'samples'}\n"
        "webserver.http.address=127.0.0.1\nwebserver.http.port=0\n")
    proc = subprocess.Popen([sys.executable, "-m", "ccx_torch", str(props), "--device", "cpu"],
                            cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        url = None
        for line in proc.stderr:
            m = re.search(r"listening on (http://\S+/kafkacruisecontrol/state) \(device cpu\)",
                          line)
            if m:
                url = m.group(1)
                break
        assert url, "the service never said where it listens"
        with urllib.request.urlopen(url, timeout=60) as resp:
            assert resp.status == 200
            assert "MonitorState" in json.loads(resp.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
