"""The port's movement planner against the JAX package.

The same columnar diffs (JAX's ``diff_columnar`` of a seeded cluster and a
shifted copy) go through JAX's numpy oracle and through the port's device
loop (here on the CPU) and numpy oracle: wave assignments, per-wave bytes
and peaks, overflow rows and wave counts must be equal, under count caps,
byte budgets and a wave cap small enough to overflow. ``movement_cost``
equals JAX's. A planner failure propagates out of ``optimize``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ccx.common.resources import Resource
from ccx.model.fixtures import RandomClusterSpec, random_cluster
from ccx.proposals import diff_columnar
from ccx.search import movement as jmv
from ccx_torch.goals.base import GoalConfig
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search import movement as tmv
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from test_torch_state import carry

SPECS = {
    "small": RandomClusterSpec(n_brokers=8, n_racks=4, n_topics=6, n_partitions=96, seed=11),
    "wide": RandomClusterSpec(n_brokers=64, n_racks=8, n_topics=16, n_partitions=600,
                              n_dead_brokers=2, seed=7),
}


def _shifted(m, every: int, shift: int):
    a = np.asarray(m.assignment).copy()
    sel = np.arange(a.shape[0]) % every == 0
    a[sel] = np.where(a[sel] >= 0, (a[sel] + shift) % int(m.B), -1)
    return m.replace(assignment=jnp.asarray(a))


def _case(name: str, every: int):
    before = random_cluster(SPECS[name])
    after = _shifted(before, every, 1 + every % 3)
    cols = {k: np.asarray(v) for k, v in diff_columnar(before, after).items()}
    return before, after, cols, np.asarray(before.leader_load[Resource.DISK], np.float32)


def _assert_same(a, b) -> None:
    np.testing.assert_array_equal(a.wave, b.wave)
    for f in ("wave_bytes", "wave_inflow_peak", "wave_outflow_peak", "moves", "move_bytes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.n_waves, a.overflow_rows) == (b.n_waves, b.overflow_rows)


OPTIONS = [
    {},
    {"broker_cap": 2},
    {"wave_bytes": "median2", "max_waves": 256},
    {"broker_cap": 1, "max_waves": 3},
]


@pytest.mark.parametrize("kw", OPTIONS, ids=["default", "cap2", "budget", "overflow"])
@pytest.mark.parametrize("name,every", [("small", 2), ("wide", 3)])
def test_device_loop_equals_jax_numpy_oracle(name, every, kw):
    _, _, cols, bpp = _case(name, every)
    kw = dict(kw)
    if kw.get("wave_bytes") == "median2":
        kw["wave_bytes"] = float(np.median(bpp[bpp > 0])) * 2.0
    B = len(np.asarray(random_cluster(SPECS[name]).broker_valid))
    want = jmv.plan_movement(cols, bpp, B, jmv.PlanOptions(backend="numpy", **kw))
    got = tmv.plan_movement(cols, bpp, B, tmv.PlanOptions(backend="device", **kw))
    host = tmv.plan_movement(cols, bpp, B, tmv.PlanOptions(backend="numpy", **kw))
    assert got.backend == "device" and host.backend == "numpy"
    _assert_same(got, want)
    _assert_same(host, want)
    assert got.summary_json() == {**want.summary_json(), "backend": "device"}
    if kw.get("max_waves") == 3:
        assert want.overflow_rows > 0


def test_backend_rule_and_empty_diff(monkeypatch):
    _, _, cols, bpp = _case("small", 2)
    B = 8
    monkeypatch.delenv(tmv.ENV_DEVICE_PLAN, raising=False)
    assert tmv.plan_movement(cols, bpp, B).backend == "numpy"  # below DEVICE_PLAN_MIN_ROWS
    monkeypatch.setenv(tmv.ENV_DEVICE_PLAN, "1")
    assert tmv.plan_movement(cols, bpp, B).backend == "device"
    monkeypatch.setenv(tmv.ENV_DEVICE_PLAN, "0")
    assert tmv.plan_movement(cols, bpp, B, tmv.PlanOptions(backend="device")).backend == "device"
    empty = {k: v[:0] for k, v in cols.items()}
    assert tmv.plan_movement(empty, bpp, B).backend == "empty"
    assert tmv.DEVICE_PLAN_MIN_ROWS == jmv.DEVICE_PLAN_MIN_ROWS


def test_naive_schedule_equals_jax():
    _, _, cols, bpp = _case("wide", 3)
    for cap, rate in ((5, 0.0), (2, 50.0)):
        assert tmv.naive_schedule(cols, bpp, 64, cap, rate) == jmv.naive_schedule(cols, bpp, 64, cap, rate)


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_movement_cost_equals_jax(backend):
    before, after, _, _ = _case("wide", 3)
    want = jmv.movement_cost(before, after, backend="numpy")
    got = tmv.movement_cost(carry(before), carry(after), backend=backend)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tmv.movement_cost(carry(before), carry(before), backend=backend) == (0.0, 0.0)


def test_a_planner_failure_propagates_out_of_optimize(monkeypatch):
    m = carry(random_cluster(SPECS["small"]))
    opts = OptimizeOptions(anneal=AnnealOptions(n_chains=2, n_steps=4), polish=GreedyOptions(
        n_candidates=8, max_iters=2), run_cold_greedy=False, topic_rebalance_rounds=0,
        leader_pass_max_iters=2, plan_enabled=True)
    assert optimize(m, GoalConfig(), opts=opts).plan is not None

    def broken(*a, **k):
        raise RuntimeError("planner failed")

    monkeypatch.setattr(tmv, "_plan_numpy", broken)
    monkeypatch.setattr(tmv, "_plan_device", broken)
    with pytest.raises(RuntimeError, match="planner failed"):
        optimize(m, GoalConfig(), opts=opts)
    assert optimize(m, GoalConfig(), opts=dataclasses.replace(opts, plan_enabled=False)).plan is None
