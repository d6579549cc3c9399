"""The benchmark's layout: every cell, configuration, traffic mix, limit and
metric of ``BENCHMARK.json`` is found by name; a new one needs only new
files and entries; the file keeps the contract's form; and nothing under
``perfbench/`` imports JAX or the JAX package (the reference not even the
system)."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.Cell.load(cell)
    assert harness.driver(c.traffic["driver"]).request
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert {"unverified", "diff_faults", "hard_violations"} <= set(c.limits)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = tmp_path / "perfbench"
    (pkg / "configs" / "B2.json").write_text(json.dumps(
        {**json.loads((pkg / "configs" / "B5.json").read_text()), "name": "B2",
         "spec": {"n_brokers": 50, "n_racks": 5, "n_topics": 40, "n_partitions": 5000,
                  "seed": 2}}))
    (pkg / "traffic" / "cold-lean.json").write_text((pkg / "traffic" / "cold-target.json")
                                                    .read_text())
    (pkg / "limits" / "b2-cold-lean.json").write_text(
        (pkg / "limits" / "b5-cold-target.json").read_text())
    (pkg / "metrics" / "moves.cold.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench["configs"].append({"name": "B2", "source": "BASELINE.json configs[1]",
                             "file": "perfbench/configs/B2.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "b2-cold-lean", "config": "B2", "traffic": "cold-lean",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "moves.cold", "unit": "moves", "better": "lower",
                               "source": "program_counter", "layer": "result path",
                               "moves": "propose_s", "workloads": ["b2-cold-lean"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell.load("b2-cold-lean", root=tmp_path)
    assert cell.config["spec"]["n_brokers"] == 50
    assert [m["name"] for m in cell.per_layer] == ["moves.cold"]
    assert harness.reader("moves.cold", pkg)(None) == 1.0
    # the cells already there read what they read before
    assert harness.Cell.load("b5-cold-target", root=tmp_path) == harness.Cell.load("b5-cold-target")


def test_benchmark_json_keeps_the_contracts_form():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["perfbench"] and len(b["command"]) <= 32
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
        assert w["config"] in {c["name"] for c in b["configs"]}
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m.get("workloads", names):
            e2e = harness.Cell.load(cell).end_to_end
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", names)) <= set(names)
    assert len(json.dumps(b)) <= 64 * 1024


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_reference_apart_from_the_system(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "flax", "ccx"}, roots
    if "reference" in path.relative_to(ROOT).parts:
        assert not roots & {"ccx_torch", "torch"}, roots
