"""The port's fleet scheduler, device-memory ledger and priced warm store.

The cases of the JAX package's ``tests/test_scheduler.py`` and
``tests/test_devmem.py`` that need no JAX, run on the port's modules
(``ccx_torch.search.scheduler``, ``ccx_torch.common.devmem``), plus the
port's own seams: ``drive_chunks`` under a fleet job (one grant per chunk,
a cancelled job raising at its next grant), ``optimize(job=...)`` equal to
the unscheduled run, two concurrent optimize jobs interleaving their
grants, and ``PlacementStore`` bases priced on the ledger with the
``placement.bank`` fault seam. Everything runs on the CPU at small sizes.
"""

from __future__ import annotations

import gc
import re
import threading
import time

import pytest
import torch

from ccx_torch.common import devmem
from ccx_torch.common.devmem import DEVMEM, DeviceMemoryManager
from ccx_torch.common.faults import FAULTS, InjectedFault
from ccx_torch.common.metrics import REGISTRY, MetricsRegistry
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search import incremental as inc
from ccx_torch.search.annealer import AnnealOptions, drive_chunks
from ccx_torch.search.greedy import GreedyOptions
from ccx_torch.search.scheduler import FLEET, ChunkScheduler, JobCancelled

GOALS = (
    "StructuralFeasibility",
    "RackAwareGoal",
    "ReplicaDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
)
SMALL = RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=4, n_partitions=220, seed=11)


def small_opts(seed=3):
    return OptimizeOptions(
        anneal=AnnealOptions(n_chains=4, n_steps=60, moves_per_step=2, seed=seed, chunk_steps=20),
        polish=GreedyOptions(n_candidates=48, max_iters=24, patience=6, chunk_iters=8),
        run_cold_greedy=False,
        topic_rebalance_rounds=0,
    )


# ----- pure scheduler semantics --------------------------------------------------


def _fake_job(s, jid, n_chunks, grants, priority=0, chunk_s=0.002, registered_evt=None):
    with s.job(jid, priority) as h:
        if registered_evt is not None:
            registered_evt.set()
        for i in range(n_chunks):
            with s.chunk(h):
                grants.append((jid, i, time.monotonic()))
                time.sleep(chunk_s)


def _join(threads):
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_round_robin_fairness_no_starvation():
    s = ChunkScheduler(dispatch_width=1)
    grants: list = []
    ths = [threading.Thread(target=_fake_job, args=(s, f"c{k}", 8, grants)) for k in range(3)]
    # a gate job holds the one dispatch slot until all three jobs wait for
    # a grant, so the rotation starts from a full run queue
    with s.job("gate", 0) as gate:
        with s.chunk(gate):
            for t in ths:
                t.start()
            deadline = time.monotonic() + 10
            while sum(j.waiting for j in s._jobs) < 3 and time.monotonic() < deadline:
                time.sleep(0.001)
    _join(ths)
    ids = [j for j, _, _ in grants]
    assert sorted(ids.count(f"c{k}") for k in range(3)) == [8, 8, 8]
    # every window of three consecutive grants holds three distinct jobs
    for w in range(len(ids) - 2):
        assert len(set(ids[w:w + 3])) == 3, (w, ids)


def test_priority_preemption_within_one_chunk_boundary():
    s = ChunkScheduler(dispatch_width=1)
    grants: list = []
    urgent_registered = threading.Event()
    go_urgent = threading.Event()

    def low():
        with s.job("dryrun", 0) as h:
            for i in range(40):
                with s.chunk(h):
                    grants.append(("dryrun", i, time.monotonic()))
                    time.sleep(0.003)
                if i == 4:
                    go_urgent.set()
                    urgent_registered.wait(timeout=5)

    def high():
        go_urgent.wait(timeout=5)
        _fake_job(s, "fix-offline", 5, grants, priority=10, registered_evt=urgent_registered)

    ths = [threading.Thread(target=low), threading.Thread(target=high)]
    for t in ths:
        t.start()
    _join(ths)
    ids = [j for j, _, _ in grants]
    first_urgent = ids.index("fix-offline")
    assert first_urgent <= 7, ids[:10]
    last_urgent = len(ids) - 1 - ids[::-1].index("fix-offline")
    assert ids[first_urgent:last_urgent + 1].count("dryrun") <= 1


def test_admission_cap_bounds_device_residency():
    s = ChunkScheduler(max_concurrent=2, dispatch_width=1)
    grants: list = []
    peak = {"n": 0}
    lock = threading.Lock()

    def job(jid):
        with s.job(jid, 0) as h:
            for _ in range(4):
                with s.chunk(h):
                    with lock:
                        peak["n"] = max(peak["n"], sum(1 for j in s._jobs if j.resident))
                    grants.append(jid)
                    time.sleep(0.002)

    ths = [threading.Thread(target=job, args=(f"c{k}",)) for k in range(4)]
    for t in ths:
        t.start()
    _join(ths)
    assert sorted(grants.count(f"c{k}") for k in range(4)) == [4, 4, 4, 4]
    assert peak["n"] <= 2


def test_occupancy_and_depth_stats():
    s = ChunkScheduler()
    s.reset_stats()

    def job(jid):
        with s.job(jid, 0) as h:
            with s.drive(h):
                for _ in range(3):
                    with s.chunk(h):
                        time.sleep(0.01)

    ths = [threading.Thread(target=job, args=(f"c{k}",)) for k in range(2)]
    for t in ths:
        t.start()
    _join(ths)
    st = s.stats()
    assert 0.0 < st["occupancy"] <= 1.0
    assert st["chunksGranted"] == 6 and st["jobsCompleted"] == 2


def test_cancel_mid_wave_frees_grant_within_one_chunk():
    s = ChunkScheduler(dispatch_width=1)
    cancel = threading.Event()
    grants: list = []
    at_cancel: list = []
    outcome: dict = {}

    def run():
        try:
            with s.job("doomed", 0, cancel_event=cancel) as h:
                for i in range(200):
                    with s.chunk(h):
                        grants.append(i)
                        if i == 4:
                            cancel.set()
                            at_cancel.append(len(grants))
                            s.kick()
                        time.sleep(0.001)
        except JobCancelled as e:
            outcome["err"] = e

    t = threading.Thread(target=run)
    t.start()
    _join([t])
    assert outcome["err"].job_id == "doomed"
    assert len(grants) <= at_cancel[0] + 1
    assert s.stats()["activeJobs"] == [] and len(s._granted) == 0


def test_cancelled_admission_leaves_no_queue_entry():
    s = ChunkScheduler(max_concurrent=1, dispatch_width=1)
    cancel = threading.Event()
    holder_in = threading.Event()
    release_holder = threading.Event()
    outcome: dict = {}

    def holder():
        with s.job("holder", 0) as h:
            with s.chunk(h):
                holder_in.set()
                release_holder.wait(timeout=10)

    def blocked():
        holder_in.wait(timeout=10)
        try:
            with s.job("blocked", 0, cancel_event=cancel):
                outcome["admitted"] = True
        except JobCancelled as e:
            outcome["err"] = e

    t1, t2 = threading.Thread(target=holder), threading.Thread(target=blocked)
    t1.start()
    t2.start()
    holder_in.wait(timeout=10)
    time.sleep(0.05)
    cancel.set()
    s.kick()
    t2.join(timeout=10)
    release_holder.set()
    _join([t1, t2])
    assert "admitted" not in outcome and outcome["err"].job_id == "blocked"
    assert s.stats()["activeJobs"] == []


def test_scheduler_grant_fault_releases_the_grant():
    s = ChunkScheduler(dispatch_width=1)
    FAULTS.arm("scheduler.grant:raise@2")
    try:
        with pytest.raises(InjectedFault):
            with s.job("chaos", 0) as h:
                for _ in range(4):
                    with s.chunk(h):
                        pass
    finally:
        FAULTS.disarm()
    assert s.stats()["activeJobs"] == [] and len(s._granted) == 0


# ----- drive_chunks under the fleet -----------------------------------------------


def test_unscheduled_drive_is_untouched():
    out = drive_chunks(lambda c, off: (c + [off], None), [], total=10, chunk=4)
    assert out == [0, 4, 8]
    assert FLEET.current() is None


def test_drive_takes_one_grant_per_chunk_and_labels_heartbeats(tmp_path):
    import json

    rec_path = tmp_path / "rec.jsonl"
    TRACER.arm(str(rec_path))
    before = FLEET.stats()["chunksGranted"]
    try:
        with FLEET.job("analytics-prod", 3) as h:
            assert FLEET.current() is h
            with TRACER.span("anneal", kind="phase"):
                drive_chunks(lambda c, off: (c, None), None, total=5, chunk=2)
            assert h.chunks == 3
    finally:
        TRACER.disarm()
    assert FLEET.stats()["chunksGranted"] - before == 3
    records = [json.loads(ln) for ln in rec_path.read_text().splitlines() if ln]
    chunk_recs = [r for r in records if r.get("ev") == "chunk"]
    assert [r["chunk"] for r in chunk_recs] == [0, 1, 2]
    assert all(r.get("job") == "analytics-prod" and r["total"] == 5 for r in chunk_recs)
    assert any((r.get("attrs") or {}).get("job") == "analytics-prod"
               for r in records if r.get("ev") == "start")
    # labeled histogram series render as one family with a job label
    reg = MetricsRegistry(prefix="t")
    reg.histogram("phase-anneal-seconds", labels={"job": "analytics-prod"}).observe(0.5)
    reg.histogram("phase-anneal-seconds").observe(1.0)
    text = reg.render_prometheus()
    assert text.count("# TYPE t_phase_anneal_seconds histogram") == 1
    assert 't_phase_anneal_seconds_sum{job="analytics-prod"} 0.500000' in text


def test_drive_probe_energy_rides_the_heartbeat(tmp_path):
    import json

    rec_path = tmp_path / "rec.jsonl"
    TRACER.arm(str(rec_path))
    try:
        drive_chunks(lambda c, off: (c + 1, torch.tensor(c + 1 >= 3)), 0, total=10, chunk=2,
                     probe=lambda c: torch.tensor(float(10 * c)))
    finally:
        TRACER.disarm()
    beats = [json.loads(ln) for ln in rec_path.read_text().splitlines() if '"chunk"' in ln]
    assert [(b["chunk"], b["energy"]) for b in beats] == [(0, 10.0), (1, 20.0), (2, 30.0)]


def test_cancelled_job_raises_from_the_drive():
    cancel = threading.Event()
    seen = []

    def run_one(c, off):
        seen.append(off)
        if off == 4:
            cancel.set()
        return c, None

    with pytest.raises(JobCancelled):
        with FLEET.job("drive-cancel", 0, cancel_event=cancel):
            drive_chunks(run_one, None, total=20, chunk=2)
    assert seen == [0, 2, 4]
    assert all(j["job"] != "drive-cancel" for j in FLEET.stats()["activeJobs"])


# ----- optimize as a fleet job ----------------------------------------------------


def test_single_job_scheduled_optimize_equals_unscheduled():
    m = random_cluster(SMALL, device="cpu")
    a = optimize(m, GoalConfig(), GOALS, small_opts())
    b = optimize(m, GoalConfig(), GOALS, small_opts(), job=("solo", 0))
    assert torch.equal(a.model.assignment, b.model.assignment)
    assert torch.equal(a.model.leader_slot, b.model.leader_slot)
    assert a.stack_after.by_name() == b.stack_after.by_name()
    assert b.verification.ok
    names = [c["name"] for c in b.span_tree["children"]]
    assert names == list(b.phase_seconds)
    assert b.span_tree["attrs"]["job"] == "solo"


def test_two_optimize_jobs_interleave_their_grants():
    m = random_cluster(SMALL, device="cpu")
    order: list = []
    real_chunk = FLEET.chunk

    def spy(h):
        order.append(h.job_id)
        return real_chunk(h)

    results: dict = {}
    barrier = threading.Barrier(2)

    def run(jid, prio):
        barrier.wait(timeout=10)
        results[jid] = optimize(m, GoalConfig(), GOALS, small_opts(seed=prio + 1), job=(jid, prio))

    FLEET.chunk = spy
    try:
        ths = [threading.Thread(target=run, args=(j, p)) for j, p in (("low", 0), ("high", 0))]
        for t in ths:
            t.start()
        _join(ths)
    finally:
        FLEET.chunk = real_chunk
    assert results["low"].verification.ok and results["high"].verification.ok
    # each job got grants while the other was registered
    first = {j: order.index(j) for j in ("low", "high")}
    last = {j: len(order) - 1 - order[::-1].index(j) for j in ("low", "high")}
    assert first["low"] < last["high"] and first["high"] < last["low"]


# ----- the device-memory ledger ---------------------------------------------------


def _mgr(budget=100) -> DeviceMemoryManager:
    return DeviceMemoryManager(budget_bytes=budget)


def test_admission_packs_lru_within_priority():
    m = _mgr()
    evicted = []
    for key in ("a", "b", "c"):
        m.admit("snapshot", key, 40, priority=0, evictor=evicted.append)
    assert evicted == ["a"]
    st = m.stats()
    assert st["residentBytes"]["snapshot"] == 80 and st["withinBudget"]
    assert st["evictions"] == {"budget/p0": 1}


def test_urgent_entry_never_evicted_by_lower_priority_admission():
    m = _mgr()
    evicted = []
    m.admit("warmBase", "urgent-base", 60, priority=10, evictor=evicted.append)
    m.admit("snapshot", "dryrun-model", 60, priority=0, evictor=evicted.append)
    assert evicted == []
    assert m.stats()["overBudgetAdmissions"] == 1


def test_higher_priority_admission_evicts_lower_first():
    m = _mgr()
    evicted = []
    m.admit("snapshot", "old-urgent", 30, priority=10, evictor=evicted.append)
    m.admit("snapshot", "dryrun", 30, priority=0, evictor=evicted.append)
    m.admit("warmBase", "new-urgent", 60, priority=10, evictor=evicted.append)
    assert evicted == ["dryrun"]


def test_last_user_wins_and_touch_job_relabels():
    m = _mgr(budget=1000)
    m.admit("snapshot", "s", 10, priority=10, job="sess")
    m.touch("snapshot", "s", priority=0, job="analytics-prod")
    assert m.entry("snapshot", "s").priority == 0
    m.touch_job("analytics-prod", 10)
    assert m.entry("snapshot", "s").priority == 10


def test_release_and_failing_evictor():
    m = _mgr()
    calls = []
    m.admit("snapshot", "a", 40, priority=0, evictor=calls.append)
    assert m.release("snapshot", "a") and calls == []
    assert m.stats()["evictions"] == {"explicit/p0": 1}

    def boom(key):
        raise RuntimeError("owner died")

    m.admit("snapshot", "x", 60, priority=0, evictor=boom)
    m.admit("snapshot", "y", 60, priority=0)  # evicts "x"; the failure is logged
    assert m.entry("snapshot", "x") is None and m.entry("snapshot", "y") is not None


def test_scheduler_registration_reprices_job_entries():
    key = "test-sched-hook:model"
    try:
        DEVMEM.admit("snapshot", key, 1, priority=0, job="test-sched-hook")
        with FLEET.job("test-sched-hook", 10):
            assert DEVMEM.entry("snapshot", key).priority == 10
        with FLEET.job("test-sched-hook", 0):
            assert DEVMEM.entry("snapshot", key).priority == 0
    finally:
        DEVMEM.release("snapshot", key)


def test_ambient_fleet_priority_prices_admissions():
    m = _mgr(budget=1000)
    with FLEET.job("ambient-test", 7):
        m.admit("warmBase", "b", 10)
    assert m.entry("warmBase", "b").priority == 7
    m.admit("warmBase", "c", 10)
    assert m.entry("warmBase", "c").priority == 0


def test_labeled_gauges_strict_exposition():
    m = DeviceMemoryManager(budget_bytes=100, metrics=True)
    m.admit("snapshot", "a", 60, priority=0)
    m.admit("warmBase", "b", 60, priority=10)
    text = REGISTRY.render_prometheus()
    assert text.count("# TYPE ccx_devmem_resident_bytes gauge") == 1
    assert 'ccx_devmem_resident_bytes{class="warmBase"}' in text
    assert 'ccx_devmem_evictions{priority="0",reason="budget"}' in text
    for line in text.splitlines():
        if line.startswith("ccx_devmem"):
            assert re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+", line), line


def test_budget_resolution(monkeypatch):
    m = DeviceMemoryManager()
    monkeypatch.setenv(devmem.ENV_BUDGET_MB, "123")
    assert m.budget_bytes() == 123_000_000
    monkeypatch.delenv(devmem.ENV_BUDGET_MB)
    devmem.configure(budget_mb=7)
    try:
        assert m.budget_bytes() == 7_000_000
    finally:
        devmem.configure(budget_mb=None)
    monkeypatch.setenv(devmem.ENV_FLEET_HBM_MB, "9")
    assert m.budget_bytes() == 9_000_000
    monkeypatch.delenv(devmem.ENV_FLEET_HBM_MB)
    assert DeviceMemoryManager(budget_bytes=55).budget_bytes() == 55


def test_derived_budget_follows_the_rule_on_a_card(monkeypatch):
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (70 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 10 * gib)
    assert devmem.derived_budget_bytes() == 35 * gib
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 80 * gib)
    assert devmem.derived_budget_bytes() == devmem.MIN_BUDGET_BYTES
    st = DeviceMemoryManager().stats()
    assert st["residentBytes"] == {"program": 80 * gib}


# ----- the warm store on the ledger -----------------------------------------------


def test_store_prices_bases_and_evicts_to_cold_start():
    ledger = DeviceMemoryManager(budget_bytes=1)
    store = inc.PlacementStore(ledger=ledger)
    m = random_cluster(SMALL, device="cpu")
    w1 = inc.WarmStart("s1", 1, m.assignment, m.leader_slot, m.replica_disk, None)
    store.put(w1, priority=0)
    assert ledger.entry("warmBase", store._ledger_key("s1")).nbytes == inc.warm_device_bytes(w1)
    w2 = inc.WarmStart("s2", 1, m.assignment, m.leader_slot, m.replica_disk, None)
    store.put(w2, priority=0)  # over budget: the older base goes
    assert store.get("s1") is None and store.get("s2") is w2
    assert store.stats()["evictions"] == 1
    # an urgent base is not displaced by a dryrun's bank
    store.put(inc.WarmStart("u", 1, m.assignment, m.leader_slot, m.replica_disk, None), priority=10)
    store.put(inc.WarmStart("d", 1, m.assignment, m.leader_slot, m.replica_disk, None), priority=0)
    assert store.get("u") is not None
    store.clear()
    assert ledger.stats()["residentBytes"].get("warmBase", 0) == 0


def test_remember_bank_seam_keeps_the_previous_base():
    m = random_cluster(SMALL, device="cpu")
    inc.STORE.clear()
    try:
        first = inc.remember("bank-seam", 1, m, GoalConfig(), job="cluster-a")
        entry = DEVMEM.entry("warmBase", inc.STORE._ledger_key("bank-seam"))
        assert entry.job == "cluster-a" and entry.nbytes == inc.warm_device_bytes(first)
        FAULTS.arm("placement.bank:raise@1")
        try:
            with pytest.raises(InjectedFault):
                inc.remember("bank-seam", 2, m, GoalConfig())
        finally:
            FAULTS.disarm()
        assert inc.STORE.get("bank-seam") is first and inc.STORE.generation("bank-seam") == 1
    finally:
        inc.STORE.clear()


def test_dropped_store_releases_its_namespace():
    ledger = DeviceMemoryManager(budget_bytes=1 << 30)
    store = inc.PlacementStore(ledger=ledger)
    m = random_cluster(SMALL, device="cpu")
    store.put(inc.WarmStart("gc", 1, m.assignment, m.leader_slot, m.replica_disk, None))
    key = store._ledger_key("gc")
    assert ledger.entry("warmBase", key) is not None
    del store
    gc.collect()
    assert ledger.entry("warmBase", key) is None


def test_store_without_ledger_is_the_count_lru():
    store = inc.PlacementStore(max_sessions=2)
    m = random_cluster(SMALL, device="cpu")
    for s in ("a", "b", "c"):
        store.put(inc.WarmStart(s, 1, m.assignment, m.leader_slot, m.replica_disk, None))
    assert store.get("a") is None and store.stats()["ledger"] is False
