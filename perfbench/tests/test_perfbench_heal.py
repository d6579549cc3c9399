"""The heal cell's comparison fails a planted fault: a proposal that leaves
one replica on a dead broker, altered where the proposal is produced, makes
``correct`` false. At a test size on the CPU."""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench import harness
from perfbench.tests.conftest import tiny_cell


def _back_on_a_dead_broker(res, m):
    """One moved-in replica of a row that left a dead broker is put back on
    that broker, where the proposal is produced."""
    from ccx_torch.proposals import ColumnarDiff

    cols = {k: v.copy() for k, v in res.diff.cols.items()}
    old, new, lead = cols["oldReplicas"], cols["newReplicas"], cols["newLeader"]
    dead = set(np.nonzero(~m.broker_ok.cpu().numpy())[0].tolist())
    for r in range(len(new)):
        gone = [b for b in old[r] if b in dead and b not in new[r]]
        moved_in = [k for k, b in enumerate(new[r]) if b >= 0 and b not in old[r] and b != lead[r]]
        if gone and moved_in:
            new[r, moved_in[0]] = gone[0]
            return dataclasses.replace(res, diff=ColumnarDiff(cols))
    raise AssertionError("no row moved a replica off a dead broker")


def test_a_replica_left_on_a_dead_broker_is_not_correct(cpu, monkeypatch):
    from ccx_torch.sidecar import server

    inner = server.optimize

    def broken(m, *args, **kwargs):
        return _back_on_a_dead_broker(inner(m, *args, **kwargs), m)

    monkeypatch.setattr(server, "optimize", broken)
    code, line = harness.run_cell(tiny_cell("b3-dead-broker-heal"), 2**31 + 37, 2.0, False, cpu)
    assert code == 0 and line["correct"] is False
    assert line["failed"] == line["attempted"] >= 1
