"""The comparison behind ``correct`` is shown to fail: the control (the
reference in bfloat16 in the system's place) fails each cell's limits, and
a run with the timed path broken underneath comes out not correct, once for
each fault a proposal cell can have: a proposal that returns its input
unchanged, half of the proposal's rows left out, and a proposal row altered
where it is produced. (No cell runs across chips, so no exchange between
chips can be left out.) At a test size on the CPU; the readings at the
cells' own sizes on the card are in PERF.md."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.reference import compare
from perfbench.tests.conftest import tiny_cell

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _requests(cell, cpu, n):
    run = harness.Run(cell, 2**31 + 29, cpu)
    drv = harness.driver(cell.traffic["driver"])
    try:
        run.start_sidecar()
        drv.setup(run)
        reqs = [drv.request(run, i) for i in range(n)]
    finally:
        run.stop_sidecar()
    assert all(r.result is not None for r in reqs)
    return reqs


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name, cpu):
    cell = tiny_cell(name)
    reqs = _requests(cell, cpu, 6)
    system = [compare.judge(r.snap, r.result, cell.config) for r in reqs]
    control = [compare.judge(r.snap, compare.control(r.snap, r.result, cell.config), cell.config)
               for r in reqs]
    assert compare.passes(compare.summarize(system, cell.limits))
    assert not compare.passes(compare.summarize(control, cell.limits))


def _unchanged(res, m):
    """The proposal is the input: no row, the input's placement."""
    from ccx_torch.proposals import ColumnarDiff

    cols = {k: v[:0] for k, v in res.diff.cols.items()}
    return dataclasses.replace(res, diff=ColumnarDiff(cols), model=m)


def _half(res, m):
    """Half of the proposal's rows are left out."""
    from ccx_torch.proposals import ColumnarDiff

    n = res.diff.n // 2
    return dataclasses.replace(res, diff=ColumnarDiff({k: v[:n] for k, v in res.diff.cols.items()}))


def _altered(res, m):
    """A row's second replica moved onto its first's broker, where the
    proposal is produced."""
    from ccx_torch.proposals import ColumnarDiff

    cols = {k: v.copy() for k, v in res.diff.cols.items()}
    new = cols["newReplicas"]
    rows = np.nonzero((new >= 0).sum(1) >= 2)[0]
    if rows.size:
        new[rows[0], 1] = new[rows[0], 0]
    return dataclasses.replace(res, diff=ColumnarDiff(cols))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, cpu, monkeypatch):
    from ccx_torch.sidecar import server

    inner = server.optimize

    def broken(m, *args, **kwargs):
        return fault(inner(m, *args, **kwargs), m)

    monkeypatch.setattr(server, "optimize", broken)
    code, line = harness.run_cell(tiny_cell(name), 2**31 + 31, 2.0, False, cpu)
    assert code == 0 and line["correct"] is False
