"""The port's ClusterModelStats against the JAX package's.

The same seeded cluster goes through ``ccx.model.stats`` and
``ccx_torch.model.stats`` (the port on the CPU, where the aggregates are
the kernel's plain version). Counts must be equal; the float statistics
within rtol 1e-5 / atol 1e-3 (the aggregates' float sums run in another
order), and so must ``balancedness_score``.
"""

from __future__ import annotations

import numpy as np
import pytest

from ccx.model import stats as jstats
from ccx.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx_torch.model import stats as tstats
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays
from ccx_torch.ops import broker_aggregates as agg_op

SPECS = {
    "random": RandomClusterSpec(n_brokers=16, n_racks=4, n_topics=6, n_partitions=96, seed=11),
    "dead-brokers": RandomClusterSpec(
        n_brokers=8, n_racks=4, n_topics=4, n_partitions=64, seed=3, n_dead_brokers=2
    ),
    "single-partition": RandomClusterSpec(n_brokers=3, n_racks=1, n_topics=1, n_partitions=1, seed=0),
    "B1": bench_spec("B1"),
    "B3": bench_spec("B3"),
    "B4": bench_spec("B4"),
}
TOL = dict(rtol=1e-5, atol=1e-3)


def carry(jm):
    arrays = {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}
    return model_from_arrays(arrays, jm.num_topics, jm.num_racks, "cpu")


@pytest.mark.parametrize("name", list(SPECS))
def test_cluster_model_stats_match(name, monkeypatch):
    monkeypatch.setattr(agg_op, "LAUNCHES", 0)
    jm = random_cluster(SPECS[name])
    want, got = jstats.cluster_model_stats(jm), tstats.cluster_model_stats(carry(jm))
    assert agg_op.LAUNCHES == 0  # the CPU model takes the plain version
    for f in ("n_brokers", "n_replicas", "n_topics", "n_partitions", "n_hosts"):
        assert getattr(got, f) == getattr(want, f), f
    for block in ("avg", "std", "min", "max"):
        g, w = getattr(got, block), getattr(want, block)
        assert list(g) == list(w)
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], err_msg=block, **TOL)
    for key in ("replicas", "leaderReplicas"):
        # counts: exact
        assert got.min[key] == want.min[key] and got.max[key] == want.max[key]
    np.testing.assert_allclose(
        tstats.balancedness_score(got), jstats.balancedness_score(want), **TOL
    )
    assert got.to_json().keys() == want.to_json().keys()
    assert got.to_json()["metadata"] == want.to_json()["metadata"]


@pytest.mark.parametrize("name", ["random", "dead-brokers", "B4"])
def test_host_rollup_matches(name):
    jm = random_cluster(SPECS[name])
    want, got = jstats.host_rollup(jm), tstats.host_rollup(carry(jm))
    assert sorted(got) == sorted(want)
    for h in want:
        assert list(got[h]) == list(want[h])
        np.testing.assert_allclose(
            [got[h][k] for k in want[h]], [want[h][k] for k in want[h]], err_msg=str(h), **TOL
        )


def test_balancedness_of_a_flat_block_is_100():
    zeros = {k: 0.0 for k in tstats.STAT_KEYS}
    s = tstats.ClusterModelStats(0, 0, 0, 0, dict(zeros), dict(zeros), dict(zeros), dict(zeros))
    assert tstats.balancedness_score(s) == 100.0
    assert tstats.STAT_KEYS == jstats.STAT_KEYS
