"""Rules of the PyTorch/CUDA port that need no JAX: its import boundary, its
default device, and the kernel wrapper's dispatch.

This file imports only torch and ``ccx_torch``, so on a machine with a card
(where JAX is not installed) its GPU tests run with
``python -m pytest --noconftest tests/test_torch_rules.py -m gpu``.
"""

from __future__ import annotations

import ast
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
        ROOT / "chip_smoke.py", ROOT / "tools" / "time_torch_aggregates.py"]


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
