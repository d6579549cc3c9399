"""The port's tracer: spans, the flight recorder, the watchdog, listeners,
job labels, the recording summary and its CLI, and the optimizer's span
tree.

``ccx_torch.common.tracing`` is a copy of the JAX package's module with the
device sync on ``torch.cuda.synchronize`` (raising, never swallowed) and no
compile or cost blocks; the recording format is the same, so the JAX
package's ``summarize`` must read the port's recordings as the port's does.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest
import torch

from ccx.common import tracing as jtracing
from ccx_torch.common import tracing
from ccx_torch.common.metrics import REGISTRY
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_tracer():
    yield
    TRACER.disarm()
    TRACER.set_watchdog(0)
    TRACER.sync = False


def test_span_tree_nesting_and_attrs():
    with TRACER.span("outer", kind="phase", P=8) as outer:
        with TRACER.span("inner"):
            TRACER.heartbeat(3, offset=30, total=100, energy=1.5)
    tree = outer.to_json()
    assert tree["name"] == "outer" and tree["attrs"]["P"] == 8 and tree["wallSeconds"] >= 0
    (inner,) = tree["children"]
    assert inner["attrs"] == {"chunk": 3, "chunkTotal": 100, "energy": 1.5}
    assert TRACER.last_tree()["name"] == "outer"
    assert "compile" not in tree and "costModel" not in tree


def test_span_end_closes_unwound_children():
    outer = TRACER.start("outer")
    TRACER.start("leaked")
    TRACER.end(outer)
    assert outer.to_json()["children"][0]["wallSeconds"] is not None
    with TRACER.span("fresh") as s:
        pass
    assert TRACER.last_tree()["name"] == "fresh" and s.path == "fresh"


def test_sync_drains_the_span_device_and_never_swallows(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    TRACER.sync = True
    card = torch.device("cuda", 0)
    with TRACER.span("on-card", device=card):
        pass
    with TRACER.span("host-only"):
        pass
    with TRACER.span("cpu-model", device=torch.device("cpu")):
        pass
    assert calls == [card]

    def lost(dev=None):
        raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(torch.cuda, "synchronize", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        with TRACER.span("doomed", device=card):
            pass


def test_flight_recorder_stream_is_o_append_jsonl(tmp_path):
    path = str(tmp_path / "rec.jsonl")
    TRACER.arm(path)
    with TRACER.span("alpha", kind="phase"):
        TRACER.heartbeat(0, offset=0, total=4)
        TRACER.heartbeat(1, offset=2, total=4, energy=2.0)
    TRACER.disarm()
    TRACER.arm(path)  # a second run appends
    TRACER.disarm()
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["ev"] for r in recs] == ["arm", "start", "chunk", "chunk", "end", "arm"]
    assert recs[0]["v"] == tracing.RECORDER_VERSION
    assert recs[3]["span"] == "alpha" and recs[3]["energy"] == 2.0
    assert all("t" in r and "tid" in r for r in recs)
    for summarize in (tracing.summarize, jtracing.summarize):
        s = summarize(path)
        assert s["runs"] == 2 and s["openSpans"] == [] and s["lastChunk"]["chunk"] == 1
    assert tracing.summarize(path)["spanWalls"] == {"alpha": recs[4]["wall_s"]}


def test_summarize_tolerates_torn_lines_and_segments_runs(tmp_path):
    path = tmp_path / "campaign.jsonl"
    lines = [
        {"ev": "arm", "pid": 100},
        {"ev": "start", "span": "optimize"},
        {"ev": "start", "span": "optimize/anneal"},
        {"ev": "chunk", "span": "optimize/anneal", "chunk": 9, "energy": 3.0},
        {"ev": "arm", "pid": 200},
        {"ev": "start", "span": "optimize"},
        {"ev": "end", "span": "optimize", "wall_s": 1.0},
    ]
    path.write_text("".join(json.dumps(r) + "\n" for r in lines) + '{"t": 3, "ev": "chu')
    s = tracing.summarize(str(path))
    assert s["tornLines"] == 1 and s["runs"] == 2
    assert "pid=100 optimize/anneal" in s["openSpans"]
    assert not any("pid=200" in o for o in s["openSpans"])
    assert s == {**jtracing.summarize(str(path)), "spanWalls": {"optimize": 1.0}}


def test_cli_prints_the_diagnosis(tmp_path):
    path = tmp_path / "rec.jsonl"
    path.write_text(json.dumps({"ev": "start", "span": "optimize"}) + "\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "ccx_torch.common.tracing", str(path)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0 and "open spans at death:" in out.stdout and "optimize" in out.stdout
    out = subprocess.run([sys.executable, "-m", "ccx_torch.common.tracing", str(path), "--json"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert json.loads(out.stdout)["openSpans"] == ["optimize"]
    assert tracing.main([str(tmp_path / "missing.jsonl")]) == 2


def test_recorder_survives_sigkill_mid_drive(tmp_path):
    path = tmp_path / "killed.jsonl"
    script = textwrap.dedent("""
        import time
        from ccx_torch.common.tracing import TRACER
        from ccx_torch.search.annealer import drive_chunks

        def run_one(c, off):
            time.sleep(0.05)
            return c, None

        with TRACER.span("optimize", kind="op"):
            with TRACER.span("anneal", kind="phase"):
                drive_chunks(run_one, None, total=10_000, chunk=1)
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT), tracing.ENV_RECORDER: str(path)}
    proc = subprocess.Popen([sys.executable, "-c", script], env=env)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if path.exists() and path.read_text().count('"ev": "chunk"') >= 3:
                break
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    s = tracing.summarize(str(path))
    assert s["tornLines"] == 0
    assert s["openSpans"] == ["optimize", "optimize/anneal"]
    assert s["lastChunk"]["span"] == "optimize/anneal" and s["lastChunk"]["chunk"] >= 2


def test_watchdog_dumps_a_stall_once(tmp_path):
    path = str(tmp_path / "stall.jsonl")
    TRACER.arm(path)
    TRACER.set_watchdog(0.3)
    span = TRACER.start("wedged-phase", kind="phase")
    try:
        deadline = time.monotonic() + 10
        dumps = []
        while time.monotonic() < deadline and not dumps:
            time.sleep(0.1)
            dumps = [json.loads(ln) for ln in open(path) if '"ev": "watchdog"' in ln]
        assert dumps, "the watchdog never fired on a stalled span"
        flat = [s["span"] for stack in dumps[0]["spans"].values() for s in stack]
        assert "wedged-phase" in flat
        assert any("test_torch_tracing" in ln for st in dumps[0]["threads"].values() for ln in st)
        time.sleep(0.8)
        assert sum(1 for ln in open(path) if '"ev": "watchdog"' in ln) == 1
    finally:
        TRACER.end(span)


def test_listener_sees_records_and_job_labels():
    seen = []
    TRACER.add_listener(seen.append)
    prev = TRACER.set_job("cluster-7")
    try:
        with TRACER.span("relay", kind="phase"):
            TRACER.heartbeat(0, total=1, energy=4.0)
    finally:
        TRACER.set_job(prev)
        TRACER.remove_listener(seen.append)
    assert [r["ev"] for r in seen] == ["start", "chunk", "end"]
    assert all(r["job"] == "cluster-7" for r in seen)
    assert seen[1]["tid"] == threading.get_ident()
    assert TRACER.convergence_timeline()["cluster-7"][-1]["energy"] == 4.0
    text = REGISTRY.render_prometheus()
    assert 'ccx_phase_relay_seconds_count{job="cluster-7"}' in text
    assert 'ccx_convergence_energy{job="cluster-7"} 4.0' in text


def test_observability_json_block():
    with TRACER.span("live"):
        block = TRACER.observability_json(threads=True)
    assert set(block) == {
        "flightRecorder", "watchdogSeconds", "watchdogDumps", "traceSync", "activeSpans",
        "lastSpanTree", "convergence", "threads", "compile", "compileAttribution", "costModel",
    }
    assert any(s["span"] == "live" for st in block["activeSpans"].values() for s in st)


def test_optimize_span_tree_and_recording_name_every_phase(tmp_path):
    m = random_cluster(RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=4, n_partitions=160,
                                         seed=4), device="cpu")
    opts = OptimizeOptions(
        anneal=AnnealOptions(n_chains=4, n_steps=40, moves_per_step=2, seed=1, chunk_steps=20),
        polish=GreedyOptions(n_candidates=32, max_iters=16, patience=4, chunk_iters=8),
        run_cold_greedy=False, topic_rebalance_rounds=0,
    )
    path = str(tmp_path / "opt.jsonl")
    TRACER.arm(path)
    phases = []
    res = optimize(m, GoalConfig(), opts=opts, progress_cb=phases.append)
    TRACER.disarm()
    tree = res.span_tree
    assert tree["name"] == "optimize" and tree["kind"] == "op"
    assert [c["name"] for c in tree["children"]] == list(res.phase_seconds) == phases
    for c in tree["children"]:
        assert res.phase_seconds[c["name"]] == pytest.approx(c["wallSeconds"], abs=1e-3)
    anneal = next(c for c in tree["children"] if c["name"] == "anneal")
    assert anneal["attrs"]["chunk"] == 1 and anneal["attrs"]["chunkTotal"] == 40
    assert "energy" in anneal["attrs"]
    walls = tracing.summarize(path)["spanWalls"]
    assert {f"optimize/{p}" for p in phases} | {"optimize"} == set(walls)
    assert res.to_json()["spanTree"] == tree


# ----- ids, the clock, aggregates, host syncs, queue waits ----------------------------


def test_sync_helper_counts_self_and_total_through_nested_spans():
    with TRACER.span("outer") as outer:
        with TRACER.blocked():
            time.sleep(0.002)
        with TRACER.span("inner"):
            for _ in range(3):
                with TRACER.blocked():
                    torch.ones(2).tolist()
            with TRACER.blocked():
                time.sleep(0.003)
    tree = outer.to_json()
    (inner,) = tree["children"]
    assert inner["syncs"] == {"self": 4, "total": 4}
    assert tree["syncs"] == {"self": 1, "total": 5}
    wait = tree["syncWaitSeconds"]
    assert inner["syncWaitSeconds"]["self"] >= 0.003 and wait["self"] >= 0.002
    assert wait["total"] == pytest.approx(wait["self"] + inner["syncWaitSeconds"]["total"],
                                          abs=2e-6)
    assert not TRACER.in_sync()
    with TRACER.blocked():
        assert TRACER.in_sync()
    # a span with no sync renders no counter
    with TRACER.span("quiet") as quiet:
        pass
    assert "syncs" not in quiet.to_json() and "syncWaitSeconds" not in quiet.to_json()


def test_an_aggregate_entered_250_times_is_one_node_and_sends_no_record(tmp_path):
    seen = []
    TRACER.add_listener(seen.append)
    try:
        with TRACER.span("anneal", kind="phase") as phase:
            for _ in range(250):
                with TRACER.step("sa-step"):
                    with TRACER.blocked():
                        pass
                    with TRACER.span("nested"):  # rolls up as well
                        pass
    finally:
        TRACER.remove_listener(seen.append)
    assert [(r["ev"], r["span"]) for r in seen] == [("start", "anneal"), ("end", "anneal")]
    (step,) = phase.to_json()["children"]
    assert step["name"] == "sa-step" and step["calls"] == 250 and "kind" not in step
    assert step["syncs"] == {"self": 250, "total": 250}
    (nested,) = step["children"]
    assert nested["calls"] == 250 and "costModel" not in nested
    assert step["parentId"] == phase.span_id
    assert step["startNs"] <= nested["startNs"] <= nested["endNs"] <= step["endNs"]
    assert 0 < step["wallSeconds"] <= phase.wall_s + 1e-4
    # armed: one file line per entry names the step, listeners still see none
    path = str(tmp_path / "steps.jsonl")
    TRACER.arm(path)
    with TRACER.span("anneal", kind="phase"):
        for _ in range(3):
            with TRACER.step("sa-step"):
                pass
    TRACER.disarm()
    recs = [json.loads(ln) for ln in open(path)]
    steps = [r for r in recs if r["ev"] == "step"]
    assert [r["call"] for r in steps] == [1, 2, 3] and steps[0]["span"] == "anneal/sa-step"
    assert tracing.summarize(path)["spanWalls"] == {"anneal": recs[-1]["wall_s"]}
    # outside any span a step does nothing
    with TRACER.step("orphan") as node:
        assert node is None


def test_stamps_nest_and_name_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.span("outer", kind="phase") as outer:
            with TRACER.span("inner"):
                torch.ones(8).add_(1)
            for _ in range(2):
                with TRACER.step("it"):
                    pass
    tree = outer.to_json()

    def walk(node):
        for c in node.get("children", ()):
            assert node["startNs"] <= c["startNs"] <= c["endNs"] <= node["endNs"]
            assert c["parentId"] == node["spanId"]
            walk(c)

    assert tree["startNs"] <= tree["endNs"]
    walk(tree)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    # the ranges of the spans that are not aggregates, on the spans' clock
    for node in (tree, tree["children"][0]):
        ev = events["ccx:" + node["name"]]
        assert node["startNs"] <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= node["endNs"]
    assert "ccx:it" not in events
    # no profiler recording: no range is opened
    with TRACER.span("quiet") as quiet:
        assert quiet.rf is None


def test_a_worker_adopts_the_request_and_its_parent_explicitly():
    out = {}
    with TRACER.span("Propose", kind="rpc", request_id="req-1") as root:
        with TRACER.span("decode") as decode:
            pass
        link = TRACER.link()

        def work():
            with TRACER.adopt(link):
                with TRACER.span("optimize", kind="op") as s:
                    with TRACER.span("anneal"):
                        pass
            out["tree"] = s.to_json()
            with TRACER.span("after") as later:  # outside adopt: unlinked
                pass
            out["later"] = later.to_json()

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert decode.request_id == "req-1" and link == ("req-1", root.span_id)
    tree = out["tree"]
    assert tree["name"] == "optimize" and tree["requestId"] == "req-1"
    assert tree["parentId"] == root.span_id
    assert tree["children"][0]["requestId"] == "req-1"
    assert "requestId" not in out["later"] and "parentId" not in out["later"]
    # an id that arrives inside the payload names the open spans
    with TRACER.span("PutSnapshot", kind="rpc") as put:
        with TRACER.span("decode") as d:
            TRACER.set_request("late")
        with TRACER.span("registry-put") as r:
            pass
    assert put.request_id == d.request_id == r.request_id == "late"


def test_grant_wait_is_counted_when_another_job_holds_the_grant():
    from ccx_torch.search.scheduler import ChunkScheduler

    def release_once(s, queued, release):
        # the release comes 0.05 s after the second job is seen queued
        deadline = time.monotonic() + 10
        while not queued(s) and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.05)
        release.set()

    s = ChunkScheduler(dispatch_width=1)
    held, release = threading.Event(), threading.Event()

    def holder():
        with s.job("holder", 0) as h:
            with s.chunk(h):
                held.set()
                release.wait(10)

    ths = [threading.Thread(target=holder),
           threading.Thread(target=release_once,
                            args=(s, lambda s: any(j.waiting for j in s._jobs), release))]
    ths[0].start()
    assert held.wait(10)
    ths[1].start()
    with TRACER.span("anneal", kind="phase") as phase:
        with s.job("waiter", 0) as h:
            with s.chunk(h):
                pass
    for t in ths:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ths)
    grant = phase.to_json()["grantWaitSeconds"]
    assert grant["self"] >= 0.05 and grant["total"] == grant["self"]
    # the admission wait under a residency cap is the handle's, for the
    # optimize root
    capped = ChunkScheduler(max_concurrent=1)
    held.clear()
    release.clear()

    def resident():
        with capped.job("resident", 0):
            held.set()
            release.wait(10)

    ths = [threading.Thread(target=resident),
           threading.Thread(target=release_once,
                            args=(capped, lambda s: any(not j.resident for j in s._jobs),
                                  release))]
    ths[0].start()
    assert held.wait(10)
    ths[1].start()
    with capped.job("queued", 0) as h:
        assert h.admit_wait_s >= 0.05
    for t in ths:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ths)


def test_optimize_tree_carries_steps_syncs_and_nested_stamps():
    m = random_cluster(RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=4, n_partitions=160,
                                         seed=4), device="cpu")
    opts = OptimizeOptions(
        anneal=AnnealOptions(n_chains=4, n_steps=40, moves_per_step=2, seed=1, chunk_steps=40),
        polish=GreedyOptions(n_candidates=32, max_iters=16, patience=4, chunk_iters=8),
        run_cold_greedy=False, topic_rebalance_rounds=0,
    )
    tree = optimize(m, GoalConfig(), opts=opts).span_tree
    phases = {c["name"]: c for c in tree["children"]}
    (step,) = [c for c in phases["anneal"].get("children", ()) if c["name"] == "sa-step"]
    assert step["calls"] == 40 and "kind" not in step
    iters = [c for c in phases["polish"]["children"] if c["name"] == "polish-iter"]
    assert len(iters) == 1 and 1 <= iters[0]["calls"] <= 16
    # the anneal reads its winner back (and the descents their stop flags)
    assert phases["anneal"]["syncs"]["total"] >= 1 and phases["polish"]["syncs"]["total"] >= 1
    assert tree["syncs"]["total"] == tree["syncs"]["self"] + sum(
        c.get("syncs", {}).get("total", 0) for c in tree["children"])
    for c in tree["children"]:
        assert tree["startNs"] <= c["startNs"] <= c["endNs"] <= tree["endNs"]
        assert c["parentId"] == tree["spanId"]
