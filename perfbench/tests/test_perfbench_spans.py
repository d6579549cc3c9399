"""The readers of the system's span tree on synthetic results: the sync
counters of the anneal, the descents and the warm tree, and the request's
edge spans; a tree without them reads 0, and a run whose requests of the
kind were all traced reads nothing."""

from __future__ import annotations

import types

import pytest

from perfbench import harness


def _node(name, syncs=0, wait=0.0, children=()):
    node = {"name": name}
    if syncs:
        node["syncs"] = {"self": syncs, "total": syncs + sum(
            c.get("syncs", {}).get("total", 0) for c in children)}
        node["syncWaitSeconds"] = {"self": wait, "total": wait + sum(
            c.get("syncWaitSeconds", {}).get("total", 0.0) for c in children)}
    if children:
        node["children"] = list(children)
    return node


def _result(anneal=(0, 0.0), polish=(0, 0.0), leader=(0, 0.0), root=(0, 0.0), edges=()):
    step = _node("sa-step", *anneal)
    phases = [_node("repair", 1, 0.5), _node("anneal", 1, 0.25, [step]),
              _node("polish", *polish), _node("leader-pass", *leader)]
    tree = _node("optimize", *root, children=phases) if root[0] else {
        "name": "optimize", "children": phases}
    if edges:
        tree["request"] = {"id": "r", "spans": [
            {"name": n, "startNs": 1_000, "endNs": 1_000 + ns} for n, ns in edges]}
    return {"spanTree": tree, "phaseSeconds": {}, "wallSeconds": 1.0}


def _run(*reqs):
    return types.SimpleNamespace(requests=[
        types.SimpleNamespace(kind=k, result=res, traced=traced) for k, res, traced in reqs])


COLD = [
    ("cold", _result(anneal=(10, 0.5), polish=(6, 0.25), leader=(2, 0.125),
                     edges=[("decode", 2_000_000), ("registry", 40_000_000)]), False),
    ("cold", _result(anneal=(20, 1.5), polish=(4, 0.75), leader=(0, 0.0),
                     edges=[("decode", 4_000_000)]), False),
    ("cold", _result(anneal=(999, 99.0), edges=[("decode", 9_000_000_000)]), True),
    ("warm", _result(root=(7, 0.5)), False),
]


@pytest.mark.parametrize("metric,want", [
    ("anneal_syncs.cold", (11 + 21) / 2),
    ("anneal_wait_s.cold", (0.75 + 1.75) / 2),
    ("descent_syncs.cold", (8 + 4) / 2),
    ("descent_wait_s.cold", (0.375 + 0.75) / 2),
    ("edge_s.cold", (0.042 + 0.004) / 2),
    ("warm_syncs.warm", 8 + 1),
    ("warm_wait_s.warm", 0.5 + 0.5 + 0.25),
    ("edge_s.warm", 0.0),
])
def test_each_reader_on_a_synthetic_run(metric, want):
    assert harness.reader(metric)(_run(*COLD)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["anneal_syncs.cold", "anneal_wait_s.cold",
                                    "descent_syncs.cold", "descent_wait_s.cold", "edge_s.cold",
                                    "warm_syncs.warm", "warm_wait_s.warm", "edge_s.warm"])
def test_a_tree_without_counters_reads_zero_and_all_traced_reads_nothing(metric):
    kind = metric.split(".")[1]
    bare = {"spanTree": {"name": "optimize", "children": [{"name": "anneal"}]}}
    assert harness.reader(metric)(_run((kind, bare, False))) == 0
    assert harness.reader(metric)(_run((kind, bare, True), (kind, None, False))) is None
