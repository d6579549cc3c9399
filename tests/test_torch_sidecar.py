"""The port's sidecar against the JAX package's, on the CPU.

* Every wire envelope builder of ``ccx_torch.sidecar.wire`` gives the JAX
  package's bytes.
* The fixture requests (``tests/fixtures/sidecar/*_request*.bin``) are fed
  to a live JAX ``OptimizerSidecar`` and to the port's, in process: the
  PutSnapshot acks are byte-equal, Ping differs only in the device count,
  and every Propose result has the JAX result's key set (less ``mesh``,
  which the port never fills; ``costModel`` with the JAX block's keys), its
  goal order and its input-side stats; both verify with zero hard
  violations. The proposals
  themselves may differ: the random streams do.
* Every Propose option key lands on the field the JAX sidecar lands it on.
* The port's registry (device cache, grafts, eviction races, the narrow
  pressure retry), the PutSnapshot retry contract, streamed segments and
  their checksums, cancellation, and the gRPC edge with the port's client.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
import time
import zlib

import msgpack
import numpy as np
import pytest
import torch

import ccx.sidecar.server as jserver
from ccx.sidecar import wire as jwire
from ccx_torch.common.faults import FAULTS, InjectedFault
from ccx_torch.model import snapshot as tsnap
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.search import incremental as inc
from ccx_torch.search.scheduler import FLEET
from ccx_torch.sidecar import wire
from ccx_torch.sidecar import server as tserver
from ccx_torch.sidecar.server import OptimizerSidecar, SnapshotRegistry, options_from_wire

FIXDIR = pathlib.Path(__file__).resolve().parent / "fixtures" / "sidecar"
#: result keys the JAX sidecar fills from modules the port has not ported
JAX_ONLY_KEYS = {"mesh"}
GOALS = ("RackAwareGoal", "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal")
LEAN = dict(
    chains=4, steps=40, chunk_steps=20, moves_per_step=2, polish_max_iters=16,
    polish_candidates=32, leader_pass_max_iters=8, topic_rebalance_rounds=0,
    run_cold_greedy=False,
)
SMALL = RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=4, n_partitions=160, seed=11)


def _fixture(name: str) -> bytes:
    return (FIXDIR / name).read_bytes()


# ----- envelopes ----------------------------------------------------------------


def test_constants_match():
    import ccx.sidecar as jpkg
    import ccx_torch.sidecar as tpkg

    assert tpkg.SERVICE == jpkg.SERVICE
    assert tpkg.GRPC_MESSAGE_OPTIONS == jpkg.GRPC_MESSAGE_OPTIONS
    assert wire.PROPOSE_OPTION_KEYS == jwire.PROPOSE_OPTION_KEYS
    for name in ("WIRE_VERSION", "SUPPORTED_WIRE_VERSIONS", "ERR_UNSUPPORTED_VERSION", "ERR_MALFORMED",
                 "ERR_BAD_SNAPSHOT", "ERR_INVALID", "ERR_INTERNAL", "ERR_CANCELLED",
                 "FIELD_RESULT_SEGMENT", "FIELD_PLAN_COLUMNAR", "FIELD_PLAN_COLUMNAR_CRC32"):
        assert getattr(wire, name) == getattr(jwire, name), name


ENVELOPES = {
    "ping_request": ((), {}),
    "put_full": ("put_snapshot_request", ("s", 3, b"\x01\x02"), {}),
    "put_delta": ("put_snapshot_request", ("s", 4, b"xy"), dict(is_delta=True, base_generation=3,
                                                                 cluster_id="kafka-a")),
    "propose_min": ("propose_request", (), {}),
    "propose_full": ("propose_request", (), dict(
        goals=["RackAwareGoal"], options={"chains": 4, "seed": 7, "p_swap": 0.5},
        snapshot=b"snap", session="s", delta=b"d", base_generation=2, generation=3,
        columnar=True, cluster_id="c", priority=5, warm_start=True, stream_result=True)),
    "ack_response": ((7,), {}),
    "pong_response": (("0.1.0", "cpu", 2), {}),
}


@pytest.mark.parametrize("name", list(ENVELOPES))
def test_envelope_builders_are_byte_equal(name):
    spec = ENVELOPES[name]
    fn, args, kw = (name, *spec) if len(spec) == 2 else spec
    assert getattr(wire, fn)(*args, **kw) == getattr(jwire, fn)(*args, **kw)


@pytest.mark.parametrize("frame", [
    ("progress_frame", ("Optimizing",), {}),
    ("heartbeat_frame", ("anneal chunk 3",), dict(span="optimize/anneal", chunk=3, total=8,
                                                  job="c", energy=1.25)),
    ("heartbeat_frame", ("bare",), {}),
    ("result_frame", ({"verified": True, "b": [1, 2]},), {}),
    ("result_segment_frame", (1, 3, b"abc"), {}),
    ("error_frame", ("boom", "internal"), {}),
])
def test_frames_are_byte_equal(frame):
    fn, args, kw = frame
    got, want = getattr(wire, fn)(*args, **kw), getattr(jwire, fn)(*args, **kw)
    assert got == want
    assert wire.pack_frame(got) == jwire.pack_frame(want)


def test_decoders_and_codes_agree():
    assert wire.decode_frame(jwire.pack_frame(jwire.progress_frame("x"))) == {"progress": "x", "wire": 1}
    with pytest.raises(wire.SidecarError) as e:
        wire.decode_frame(jwire.pack_frame(jwire.error_frame("no", jwire.ERR_CANCELLED)))
    assert e.value.code == wire.ERR_CANCELLED
    with pytest.raises(wire.SidecarError) as e:
        wire.decode_response(msgpack.packb({"wire": 99}))
    assert e.value.code == wire.ERR_UNSUPPORTED_VERSION
    with pytest.raises(wire.WireError) as e:
        wire.unpackb(b"\xc1")
    assert e.value.code == wire.ERR_MALFORMED
    for exc in (wire.WireError(wire.ERR_BAD_SNAPSHOT, "x"), ValueError("v"), RuntimeError("r")):
        assert wire.code_of(exc) == jwire.code_of(
            jwire.WireError(exc.code, "x") if isinstance(exc, wire.WireError) else exc)


# ----- the servicer against a live JAX servicer -----------------------------------


PROPOSES = ("propose_request.bin", "propose_request_warm.bin", "propose_request_fleet.bin")


def _replay(sidecar) -> dict:
    out = {
        "put_full": sidecar.put_snapshot(_fixture("put_full_request.bin")),
        "put_delta": sidecar.put_snapshot(_fixture("put_delta_request.bin")),
        "put_fleet": sidecar.put_snapshot(_fixture("put_full_request_fleet.bin")),
        "ping": sidecar.ping(_fixture("ping_request.bin")),
    }
    for name in PROPOSES:
        out[name] = list(sidecar.propose(_fixture(name)))
    return out


@pytest.fixture(scope="module")
def replays():
    """One replay of the fixture requests through each servicer; the JAX
    replay runs in a thread beside the port's."""
    box: dict = {}

    def jax_side():
        try:
            box["jax"] = _replay(jserver.OptimizerSidecar())
        except BaseException as e:  # re-raised in the test's thread
            box["err"] = e

    t = threading.Thread(target=jax_side)
    t.start()
    port = _replay(OptimizerSidecar(device="cpu"))
    t.join(timeout=600)
    assert not t.is_alive()
    if "err" in box:
        raise box["err"]
    return box["jax"], port


def test_put_acks_are_byte_equal(replays):
    jax, port = replays
    for key, fixture in (("put_full", "put_full_response.bin"), ("put_delta", "put_delta_response.bin"),
                         ("put_fleet", "put_fleet_response.bin")):
        assert port[key] == jax[key] == _fixture(fixture), key


def test_ping_differs_only_in_the_device_count(replays):
    jax, port = replays
    j, t = jwire.unpackb(jax["ping"]), wire.unpackb(port["ping"])
    assert set(t) == set(j) and t["backend"] == j["backend"] == "cpu"
    assert t["version"] == j["version"]
    assert port["ping"] == jwire.pong_response(j["version"], j["backend"], t["num_devices"])


@pytest.mark.parametrize("name", PROPOSES)
def test_propose_results_agree(replays, name):
    jax, port = replays
    jframes, tframes = jax[name], port[name]
    for frames in (jframes, tframes):
        assert all("progress" in f for f in frames[:-1]) and "result" in frames[-1]
    j, t = jframes[-1]["result"], tframes[-1]["result"]
    assert set(t) == set(j) - JAX_ONLY_KEYS
    # the cost block's values are machine-dependent (volatile in JAX's
    # golden fixtures too): its keys must agree
    assert set(t["costModel"]) == set(j["costModel"])
    assert [g["goal"] for g in t["goalSummary"]] == [g["goal"] for g in j["goalSummary"]]
    for res in (j, t):
        assert res["verified"], res["verificationFailures"]
        assert all(g["violationsAfter"] == 0 for g in res["goalSummary"] if g["hard"])
    np.testing.assert_allclose([g["violationsBefore"] for g in t["goalSummary"]],
                               [g["violationsBefore"] for g in j["goalSummary"]], rtol=1e-5, atol=1e-3)
    if "clusterModelStats" in j:
        jb, tb = j["clusterModelStats"]["before"], t["clusterModelStats"]["before"]
        assert tb["metadata"] == jb["metadata"]
        for block in jb["statistics"]:
            js, ts = jb["statistics"][block], tb["statistics"][block]
            assert list(ts) == list(js)
            np.testing.assert_allclose([ts[k] for k in js], [js[k] for k in js], rtol=1e-5, atol=1e-3)
    if "incremental" in j:
        assert set(t["incremental"]) == set(j["incremental"])
        assert t["incremental"]["warmStart"] == j["incremental"]["warmStart"]
    # the phase breadcrumbs name the port's stages, in order, as they start
    phases = [f["progress"] for f in tframes if set(f) == {"progress", "wire"}]
    assert [p for p in phases if p in t["phaseSeconds"]] == list(t["phaseSeconds"])


# ----- option mapping ---------------------------------------------------------------


class _Captured(Exception):
    def __init__(self, opts):
        super().__init__("captured")
        self.opts = opts


def _jax_opts(options: dict, monkeypatch):
    from ccx.model.fixtures import small_deterministic
    from ccx.model.snapshot import to_msgpack

    def capture(model, cfg, goals, opts, **kw):
        raise _Captured(opts)

    monkeypatch.setattr(jserver, "optimize", capture)
    req = jwire.propose_request(options=options, snapshot=to_msgpack(small_deterministic()))
    with pytest.raises(_Captured) as e:
        list(jserver.OptimizerSidecar().propose(req))
    return e.value.opts


def _flat(obj, prefix="") -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def test_every_option_key_lands_on_the_jax_field(monkeypatch):
    base_j = _flat(_jax_opts({}, monkeypatch))
    base_t = _flat(options_from_wire({}, False))
    shared = set(base_j) & set(base_t)
    assert {k: base_t[k] for k in shared} == {k: base_j[k] for k in shared}
    refused = set()
    for key in sorted(wire.PROPOSE_OPTION_KEYS):
        for value in ("host", 7, 0.37, True, False):
            if (key == "repair_backend") != (value == "host"):
                continue
            changed_j = {k: v for k, v in _flat(_jax_opts({key: value}, monkeypatch)).items()
                         if v != base_j[k]}
            if changed_j:
                break
        assert changed_j, key
        try:
            got = _flat(options_from_wire({key: value}, False))
        except ValueError:
            refused.add(key)
            continue
        changed_t = {k: v for k, v in got.items() if v != base_t[k]}
        assert changed_t == changed_j, key
    assert refused == set()
    with pytest.raises(ValueError, match="unknown options keys"):
        options_from_wire({"chians": 4}, False)


@pytest.mark.parametrize("rung", ["target", "lean"])
def test_rung_options_survive_the_wire(rung):
    from ccx_torch import rungs

    _, opts, _ = rungs.build_opts("B5", rung)
    assert options_from_wire(rungs.wire_options(opts), False) == opts
    steady = dataclasses.replace(opts, incremental=rungs.steady_options(), plan_enabled=True)
    assert options_from_wire(rungs.wire_options(steady), True) == steady
    assert set(rungs.wire_options(opts)) <= wire.PROPOSE_OPTION_KEYS


# ----- the registry ---------------------------------------------------------------


def _arrays(seed=77):
    m = random_cluster(RandomClusterSpec(n_brokers=6, n_racks=3, n_topics=3, n_partitions=40,
                                         seed=seed), device="cpu")
    return tsnap.model_to_arrays(m)


def test_registry_caches_and_evicts_under_a_private_budget():
    arrays = _arrays()
    one = tserver.model_device_bytes(tsnap.arrays_to_model(arrays, device="cpu"))
    reg = SnapshotRegistry(hbm_budget_bytes=2 * one + 1, device="cpu")
    for s in ("a", "b", "c"):
        reg.put(s, 1, arrays)
        assert reg.model(s) is not None
    st = reg.stats()
    assert st["deviceResident"] == 2 and st["evictions"] == 1 and not st["unifiedLedger"]
    assert st["deviceBytes"] == 2 * one and st["misses"] == 3
    assert reg.model("c") is reg.model("c") and reg.stats()["hits"] == 2
    assert reg.model("a") is not None and reg.stats()["misses"] == 4  # rebuilt after eviction


def test_metric_delta_grafts_and_structural_delta_rebuilds():
    arrays = _arrays()
    reg = SnapshotRegistry(device="cpu")
    reg.put("s", 1, arrays)
    m1 = reg.model("s")
    new = dict(arrays, leader_load=(arrays["leader_load"] * 2).astype(np.float32))
    reg.put("s", 2, new, changed={"leader_load"})
    assert reg.stats()["deltaGrafts"] == 1
    m2 = reg.model("s")
    assert reg.stats()["misses"] == 1  # served from the graft
    n = arrays["leader_load"].shape[1]
    np.testing.assert_array_equal(m2.leader_load[:, :n].numpy(), new["leader_load"])
    assert torch.all(m2.leader_load[:, n:] == 0) and m2.assignment is m1.assignment
    reg.put("s", 3, dict(new), changed={"assignment"})
    assert reg.stats()["deviceResident"] == 0
    assert reg.model("s") is not None and reg.stats()["misses"] == 2


def test_graft_returns_none_only_for_its_defined_cases(monkeypatch):
    arrays = _arrays()
    reg = SnapshotRegistry(device="cpu")
    reg.put("s", 1, arrays)
    reg.model("s")
    wide = dict(arrays, leader_load=np.ones((4, 4096), np.float32))
    reg.put("s", 2, wide, changed={"leader_load"})
    assert reg.stats()["graftFailures"] == 1 and reg.stats()["deviceResident"] == 0
    reg.put("s", 3, arrays)
    reg.model("s")
    FAULTS.arm("registry.graft:raise@1")
    try:
        reg.put("s", 4, arrays, changed={"follower_load"})
    finally:
        FAULTS.disarm()
    assert reg.stats()["graftFailures"] == 2
    reg.put("s", 5, arrays)
    reg.model("s")

    def broken_pad(*a, **k):
        raise RuntimeError("device copy failed")

    monkeypatch.setattr(torch.nn.functional, "pad", broken_pad)
    with pytest.raises(RuntimeError, match="device copy failed"):
        reg.put("s", 6, arrays, changed={"leader_load"})


def test_build_retries_only_on_allocation_failure(monkeypatch):
    arrays = _arrays()
    reg = SnapshotRegistry(device="cpu")
    reg.put("a", 1, arrays)
    reg.model("a")
    reg.put("b", 1, arrays)
    FAULTS.arm("snapshot.transfer:exhaust@1")
    try:
        assert reg.model("b") is not None
    finally:
        FAULTS.disarm()
    st = reg.stats()
    assert st["pressureEvictions"] == 1 and st["deviceResident"] == 1
    reg.put("c", 1, arrays)
    FAULTS.arm("snapshot.transfer:raise@1")
    try:
        with pytest.raises(InjectedFault):
            reg.model("c")
    finally:
        FAULTS.disarm()
    calls = []

    def oom_once(d, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return tsnap.arrays_to_model(d, **kw)

    monkeypatch.setattr(tserver, "arrays_to_model", oom_once)
    assert reg.model("c") is not None and len(calls) == 2
    assert reg.stats()["pressureEvictions"] == 2


def test_eviction_racing_graft_never_tears():
    arrays = _arrays()
    for trial in range(6):
        reg = SnapshotRegistry(device="cpu")
        reg.put("s", 1, arrays)
        reg.model("s")
        new = dict(arrays, leader_load=(arrays["leader_load"] * (2.0 + trial)).astype(np.float32))
        barrier = threading.Barrier(2)

        def grafting():
            barrier.wait(timeout=10)
            reg.put("s", 2, new, changed={"leader_load"})

        def evicting():
            barrier.wait(timeout=10)
            reg.evict_device()

        ts = [threading.Thread(target=grafting), threading.Thread(target=evicting)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        out = reg.model("s")
        n = new["leader_load"].shape[1]
        np.testing.assert_array_equal(out.leader_load[:, :n].numpy(), new["leader_load"])


# ----- the PutSnapshot contract -----------------------------------------------------


def test_put_delta_retry_is_idempotent_and_desync_fails():
    arrays = _arrays()
    sc = OptimizerSidecar(device="cpu")
    sc.put_snapshot(wire.put_snapshot_request("s", 1, tsnap.pack_arrays(arrays)))
    new = dict(arrays, leader_load=(arrays["leader_load"] * 1.5).astype(np.float32))
    delta = wire.put_snapshot_request("s", 2, tsnap.pack_arrays(tsnap.delta_encode(arrays, new)),
                                      is_delta=True, base_generation=1)
    assert sc.put_snapshot(delta) == sc.put_snapshot(delta) == wire.ack_response(2)
    other = dict(arrays, leader_load=(arrays["leader_load"] * 3).astype(np.float32))
    desync = wire.put_snapshot_request("s", 2, tsnap.pack_arrays(tsnap.delta_encode(arrays, other)),
                                       is_delta=True, base_generation=1)
    with pytest.raises(ValueError, match="desynced"):
        sc.put_snapshot(desync)
    stale = wire.put_snapshot_request("s", 3, tsnap.pack_arrays(tsnap.delta_encode(arrays, other)),
                                      is_delta=True, base_generation=1)
    with pytest.raises(ValueError, match="does not match"):
        sc.put_snapshot(stale)
    with pytest.raises(wire.WireError) as e:
        sc.put_snapshot(wire.put_snapshot_request("t", 1, b"\x92\x01"))
    assert e.value.code == wire.ERR_BAD_SNAPSHOT


# ----- Propose: streaming, the stats memo, cancellation -------------------------------


@pytest.fixture(scope="module")
def session_sidecar():
    m = random_cluster(SMALL, device="cpu")
    sc = OptimizerSidecar(device="cpu")
    sc.put_snapshot(wire.put_snapshot_request("sess", 1, tsnap.to_msgpack(m)))
    yield sc
    inc.STORE.drop("sess")


def test_streamed_segments_reassemble_and_the_memo_hits(session_sidecar, monkeypatch):
    from ccx_torch import optimizer as topt

    sc = session_sidecar
    monkeypatch.setattr(tserver, "RESULT_SEGMENT_BYTES", 512)
    streamed = list(sc.propose(wire.propose_request(GOALS, LEAN, session="sess", columnar=True,
                                                    stream_result=True)))
    res = streamed[-1]["result"]
    segs = [f for f in streamed if wire.FIELD_RESULT_SEGMENT in f]
    assert len(segs) == res["proposalsColumnarSegments"] > 1
    assert [f[wire.FIELD_RESULT_SEGMENT] for f in segs] == list(range(len(segs)))
    blob = b"".join(f["data"] for f in segs)
    assert len(blob) == res["proposalsColumnarBytes"]
    assert zlib.crc32(blob) & 0xFFFFFFFF == res["proposalsColumnarCrc32"]
    calls = []
    real = topt.cluster_model_stats
    monkeypatch.setattr(topt, "cluster_model_stats", lambda m: calls.append(1) or real(m))
    # a repeat of the same generation: the input-side stats come from the memo
    hits = sc.stats_memo_hits
    mono = list(sc.propose(wire.propose_request(GOALS, LEAN, session="sess", columnar=True)))
    assert len(calls) == 1 and sc.stats_memo_hits == hits + 1  # stats after only
    cols = tsnap.decode_msgpack(mono[-1]["result"]["proposalsColumnar"])
    stream_cols = tsnap.decode_msgpack(blob)
    assert sorted(cols) == sorted(stream_cols)
    assert mono[-1]["result"]["clusterModelStats"]["before"] == \
        sc._input_stats["sess"][1].to_json()
    gs = tsnap.decode_msgpack(res["goalSummaryColumnar"])
    assert gs["goal"] == [g for g in ("StructuralFeasibility",) + GOALS]


def test_abandoned_propose_cancels_its_worker():
    m = random_cluster(SMALL, device="cpu")
    sc = OptimizerSidecar(device="cpu")
    req = wire.propose_request(GOALS, dict(LEAN, steps=200_000, run_polish=False,
                                           run_leader_pass=False),
                               snapshot=tsnap.to_msgpack(m), cluster_id="abandoned")
    gen = sc.propose(req)
    deadline = time.monotonic() + 30
    registered = False
    while time.monotonic() < deadline and not registered:
        next(gen)
        registered = any(j["job"] == "abandoned" for j in FLEET.stats()["activeJobs"])
    assert registered
    gen.close()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if not any(j["job"] == "abandoned" for j in FLEET.stats()["activeJobs"]):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("the abandoned worker is still registered")


def test_unknown_goal_and_session_are_invalid_arguments():
    sc = OptimizerSidecar(device="cpu")
    with pytest.raises(ValueError, match="no snapshot"):
        list(sc.propose(wire.propose_request(session="nope")))
    m = random_cluster(SMALL, device="cpu")
    with pytest.raises(ValueError, match="unknown goals"):
        list(sc.propose(wire.propose_request(("NoSuchGoal",), snapshot=tsnap.to_msgpack(m))))


# ----- the gRPC edge with the port's client ---------------------------------------------


def test_grpc_end_to_end_with_a_severed_stream(session_sidecar):
    pytest.importorskip("grpc")
    from ccx_torch.sidecar.client import SidecarClient

    server, port = tserver.make_grpc_server(session_sidecar)
    server.start()
    try:
        with SidecarClient(f"127.0.0.1:{port}", retries=2, backoff_s=0.001, retry_seed=3) as c:
            assert c.ping()["backend"] == "cpu"
            seen = []
            out = c.propose(session="sess", goals=GOALS, on_progress=seen.append, columnar=True,
                            **LEAN)
            assert seen and out["verified"]
            assert set(out["proposalsColumnar"]) >= {"partition", "newReplicas"}
            assert [g["goal"] for g in out["goalSummary"]][1:] == list(GOALS)
            FAULTS.arm("rpc.frame:sever@2")
            try:
                again = c.propose(session="sess", goals=GOALS, **LEAN)
            finally:
                FAULTS.disarm()
            assert again["verified"] and c.stats["stream_restarts"] == 1
            with pytest.raises(wire.SidecarError) as e:
                c.propose(session="sess", goals=("NoSuchGoal",), **LEAN)
            assert e.value.code == wire.ERR_INVALID
    finally:
        server.stop(0)

