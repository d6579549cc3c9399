"""The port's chaos run and the two serving repairs it needs.

* ``CHAOS_SCENARIOS`` is the JAX bench's schedule.
* The ``device.diff`` seam fires in the port's ``columnar_diff`` when armed,
  and never when disarmed. Through the sidecar, a warm Propose under that
  fault fails with the retryable internal error and recovers by exactly one
  client retry, with the columns of an unfaulted call on the same placement
  (the JAX package degrades to its numpy diff inside the Propose instead;
  the port has no host diff to fall back to).
* ``run_chaos`` on the CPU at a small size (one cycle of seven windows)
  fires every seam of the schedule, recovers every window, leaks no session
  and leaves no job stuck.
* ``freeze_gc_steady_state`` freezes the heap, and the sidecar's ``main``
  calls it once the server has started.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest

import bench
from ccx_torch.bench import runs
from ccx_torch.common import costmodel
from ccx_torch.common.faults import FAULTS, InjectedFault
from ccx_torch.model.fixtures import random_cluster
from ccx_torch.model.snapshot import delta_encode, model_to_arrays, pack_arrays
from ccx_torch.proposals import columnar_diff
from ccx_torch.rungs import drift_metrics, steady_wire_options, wire_options
from ccx_torch.search import incremental as tinc
from ccx_torch.sidecar import server as sserver
from test_torch_scenarios import GOALS, WARM_WIRE, base_spec, small_opts


@pytest.fixture(autouse=True)
def _disarmed():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def test_chaos_schedule_is_the_jax_benchs():
    assert runs.CHAOS_SCENARIOS == bench.CHAOS_SCENARIOS


def test_warm_wire_options_are_the_jax_benchs():
    assert steady_wire_options() == bench._steady_options()


def test_columnar_diff_fires_the_device_diff_seam_only_when_armed():
    m = random_cluster(base_spec(), device="cpu")
    moved = m.replace(leader_slot=(m.leader_slot + 1) % 2)
    clean = columnar_diff(m, moved)
    assert clean.n > 0
    FAULTS.arm("device.diff:raise@1", seed=1)
    with pytest.raises(InjectedFault, match="device.diff"):
        columnar_diff(m, moved)
    # the schedule fired on the first hit only: the retry's diff goes through
    again = columnar_diff(m, moved)
    assert FAULTS.stats()["fired"] == {"device.diff:raise": 1}
    FAULTS.disarm()
    assert all(np.array_equal(again.cols[k], clean.cols[k]) for k in clean.cols)
    assert columnar_diff(m, moved).n == clean.n


def test_warm_propose_under_a_diff_fault_recovers_by_one_client_retry():
    """Two sessions seeded alike take the same delta; the warm Propose of one
    runs with ``device.diff:raise@1`` armed. It takes one retry, and its
    columns equal the unfaulted session's."""
    from ccx_torch.sidecar.client import SidecarClient

    m = random_cluster(base_spec(), device="cpu")
    arrays = model_to_arrays(m)
    p_real = int(m.partition_valid.sum())
    new = drift_metrics(arrays, np.random.default_rng(3), p_real, p_real // 5)
    sidecar = sserver.OptimizerSidecar(device="cpu")
    server, port = sserver.make_grpc_server(sidecar, "127.0.0.1:0")
    server.start()
    warm = {**wire_options(small_opts()), **WARM_WIRE}
    results = {}
    try:
        with SidecarClient(f"127.0.0.1:{port}", retries=2, backoff_s=0.01,
                           retry_seed=1) as client:
            for session in ("faulted", "clean"):
                client.put_snapshot(None, session, 1, packed=pack_arrays(arrays))
                tinc.remember(session, 1, m, sidecar.goal_config)
                client.put_snapshot(None, session, 2, is_delta=True, base_generation=1,
                                    packed=pack_arrays(delta_encode(arrays, new)))
            for session in ("faulted", "clean"):
                if session == "faulted":
                    FAULTS.arm("device.diff:raise@1", seed=1)
                r0 = client.stats["retries"]
                res = client.propose(session=session, goals=GOALS, columnar=True,
                                     warm_start=True, base_generation=1, **warm)
                results[session] = (res, client.stats["retries"] - r0, FAULTS.stats()["fired"])
                FAULTS.disarm()
    finally:
        server.stop(0)
        tinc.STORE.clear()
    (faulted, retries, fired), (clean, clean_retries, _) = results["faulted"], results["clean"]
    assert fired == {"device.diff:raise": 1}
    assert (retries, clean_retries) == (1, 0)
    for res in (faulted, clean):
        assert res["verified"] and res["incremental"]["warmStart"]
    got, want = faulted["proposalsColumnar"], clean["proposalsColumnar"]
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_run_chaos_fires_every_seam_and_recovers_every_window():
    served = runs.serve_cold("B3", "cpu", spec=base_spec(), goals=GOALS, opts=small_opts(),
                             warm_wire=WARM_WIRE)
    try:
        out = runs.run_chaos("B3", n_iters=len(runs.CHAOS_SCENARIOS), served=served)
    finally:
        served.close()
        tinc.STORE.clear()
    assert not FAULTS.armed
    seams = {rule.split("@")[0] for spec, _ in runs.CHAOS_SCENARIOS for rule in spec.split(";")}
    assert set(out["faults_fired"]) == seams and min(out["faults_fired"].values()) >= 1
    assert out["recovered"]["recovered"] == out["n_iters"] == 7
    assert out["leaks_ok"] and out["scheduler"]["stuckJobs"] == 0
    assert out["recovery"]["bounded"] and out["disarmed"]["ok"]
    assert out["verified"]
    by_seam = {w["scenario"]: w for w in out["windows"]}
    # the diff fault is recovered by one retry, warm
    assert by_seam["device.diff:raise@1"]["retries"] == 1 and by_seam["device.diff:raise@1"]["warm"]
    # after the killed bank the window cold-starts, and the cold entry's
    # fault is recovered by one retry
    assert by_seam["compile:raise@1"]["cold_fallback"] and by_seam["compile:raise@1"]["retries"] == 1


def test_freeze_gc_steady_state_returns_the_freeze_count(monkeypatch):
    calls = []
    monkeypatch.setattr(gc, "collect", lambda: calls.append("collect"))
    monkeypatch.setattr(gc, "freeze", lambda: calls.append("freeze"))
    monkeypatch.setattr(gc, "get_freeze_count", lambda: 7)
    assert sserver.freeze_gc_steady_state() == 7
    assert calls == ["collect", "freeze"]
    monkeypatch.undo()
    # for real: other threads may free frozen objects at any time, so only
    # the sign of the count is stable
    try:
        assert sserver.freeze_gc_steady_state() > 0
    finally:
        gc.unfreeze()


def test_sidecar_main_freezes_the_heap_after_the_server_starts(monkeypatch):
    calls = []

    class Server:
        def start(self):
            calls.append("start")

        def wait_for_termination(self):
            calls.append("wait")

    def freeze():
        calls.append("freeze")
        return 0

    monkeypatch.setattr(sserver, "make_grpc_server", lambda *a, **k: (Server(), 0))
    monkeypatch.setattr(sserver, "freeze_gc_steady_state", freeze)
    try:
        assert sserver.main(["--device", "cpu", "--address", "127.0.0.1:0"]) == 0
    finally:
        costmodel.set_capture(None)
        gc.unfreeze()
    assert calls == ["start", "freeze", "wait"]
