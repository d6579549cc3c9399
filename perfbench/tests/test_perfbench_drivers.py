"""Each driver end to end on the CPU at a test size, through the harness's
test entry (``harness.run_cell`` with the CPU named), and the command's
refusals: no card, no system beside it, JAX in the process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.conftest import tiny_cell

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_driver_runs_end_to_end_on_the_cpu(name, traced, cpu, capsys):
    cell = tiny_cell(name)
    code, line = harness.run_cell(cell, 2**31 + 11, 2.0, traced, cpu)
    assert code == 0 and line["correct"], line
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line) == KEYS + ["checks"]  # the numbers compared come last
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # the device's own metrics need the card's trace
    want -= {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    assert set(line["metrics"]) == want
    for name_, check in line["checks"].items():
        assert check["value"] <= check["limit"], name_
    err = capsys.readouterr().err.splitlines()
    assert err[-len(line["checks"]):] == [
        f"check {k}: {v['value']} (limit {v['limit']})" for k, v in line["checks"].items()]


def test_same_seed_same_inputs(cpu):
    from perfbench.reference import generator as gen

    cell = tiny_cell("b5-cold-target")
    runs = [harness.Run(cell, 2**31 + 3, cpu) for _ in range(2)]
    spec = gen.spec_of(cell.config)
    snaps = [gen.redraw_loads(gen.snapshot(gen.random_cluster_arrays(spec)), spec, r.rng(1, 4))
             for r in runs]
    assert all((snaps[0][k] == snaps[1][k]).all() for k in ("leader_load", "broker_capacity"))


def test_a_process_holding_jax_prints_no_result(cpu, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, line = harness.run_cell(tiny_cell("b5-cold-target"), 5, 0.5, False, cpu)
    assert code == 3 and line is None


def test_a_metric_that_reads_nothing_prints_no_result(cpu, monkeypatch, capsys):
    real = harness.reader

    def reader(metric, pkg=harness.PKG):
        return (lambda run: None) if metric == "propose_s" else real(metric, pkg)

    monkeypatch.setattr(harness, "reader", reader)
    code, line = harness.run_cell(tiny_cell("b5-cold-target"), 7, 0.5, False, cpu)
    assert code == 4 and line is None
    assert "propose_s" in capsys.readouterr().err.splitlines()[-1]


def test_the_warm_mix_keeps_brokers_within_capacity(cpu):
    from perfbench.drivers import warm
    from perfbench.reference import generator as gen
    from perfbench.reference import goals as rg

    cell = tiny_cell("b5-warm-drift")
    run = harness.Run(cell, 2**31 + 17, cpu)
    snap = gen.snapshot(gen.random_cluster_arrays(gen.spec_of(cell.config)))
    run.base, run.drift = snap, run.rng(2)
    warm.hold(run, snap)
    caps = [g for g in rg.CAPACITY_GOALS]
    want = sum(v for v, _ in rg.goal_stack(snap, snap, caps, cell.config["thresholds"]).values())
    assert warm.overloads(run, snap) == want
    # one broker's CPU capacity cut to just above the load it holds, the
    # others' doubled: some draws put it over, and only the others come out
    b, p, leads = run.in_force
    cpu_load = np.bincount(b, weights=np.where(leads, snap["leader_load"][rg.CPU, p],
                                               snap["follower_load"][rg.CPU, p]), minlength=10)
    cap = snap["broker_capacity"].astype(np.float64) * 2
    thr = cell.config["thresholds"]["capacity_threshold"][rg.CPU]
    cap[rg.CPU, 0] = cpu_load[0] * 1.001 / thr
    run.base = dict(snap, broker_capacity=cap.astype(np.float32))
    warm.hold(run, snap)
    assert run.in_force_fits
    drawn = [warm.draw(run) for _ in range(20)]
    assert run.notes["drifts_redrawn"] > 0 and "windows_over_capacity" not in run.notes
    assert all(warm.overloads(run, new) == 0 for new in drawn)


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "b5-cold-target", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _command(harness.ROOT, env)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_the_command_fails_without_the_system_beside_it(tmp_path):
    shutil.copytree(harness.PKG, tmp_path / "perfbench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _command(tmp_path, env)
    assert proc.returncode != 0 and "correct" not in proc.stdout
