"""The port's fixtures and broker aggregates against the JAX package.

Inputs come from the JAX package's seeded generator and are carried into the
port with ``model_from_arrays``, so both score the identical cluster. The
port's plain aggregates (the CPU path of the CUDA kernel's wrapper) are held
against the XLA segment-sum version and against the Pallas kernel in
interpret mode, on the fixtures of tests/test_ops_mxu.py. Integer outputs
must match exactly; float sums within rtol 1e-5 / atol 1e-3 (summation
order differs).
"""

from __future__ import annotations

import numpy as np
import pytest

from ccx.model.aggregates import _broker_aggregates_xla
from ccx.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx.ops.mxu_aggregates import broker_aggregates_mxu
from ccx_torch.model import fixtures as tfix
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays
from ccx_torch.ops import broker_aggregates as agg_op

SPECS = {
    "random": RandomClusterSpec(n_brokers=16, n_racks=4, n_topics=6, n_partitions=96, seed=11),
    "dead-brokers": RandomClusterSpec(
        n_brokers=8, n_racks=4, n_topics=4, n_partitions=64, seed=3, n_dead_brokers=2
    ),
    "jbod": bench_spec("B4"),
    "single-partition": RandomClusterSpec(
        n_brokers=3, n_racks=1, n_topics=1, n_partitions=1, seed=0
    ),
}
INT_FIELDS = ("replica_count", "leader_count", "topic_replica_count", "topic_leader_count")
FLOAT_FIELDS = ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load")


def carry(jm):
    """The JAX model's fields as numpy, into the port (on the CPU)."""
    arrays = {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}
    return model_from_arrays(arrays, jm.num_topics, jm.num_racks, "cpu")


@pytest.mark.parametrize("name", list(SPECS) + ["B3"])
def test_fixtures_are_bit_identical(name):
    spec = SPECS.get(name) or bench_spec(name)
    jm = random_cluster(spec)
    tm = tfix.random_cluster(spec, device="cpu")
    assert (tm.num_topics, tm.num_racks) == (jm.num_topics, jm.num_racks)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("reference", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("name", list(SPECS))
def test_plain_aggregates_match_jax(name, reference, monkeypatch):
    monkeypatch.setattr(agg_op, "LAUNCHES", 0)
    jm = random_cluster(SPECS[name])
    ref = _broker_aggregates_xla(jm) if reference == "xla" else broker_aggregates_mxu(jm, interpret=True)
    got = broker_aggregates(carry(jm))
    assert agg_op.LAUNCHES == 0
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-5, atol=1e-3, err_msg=f
        )
