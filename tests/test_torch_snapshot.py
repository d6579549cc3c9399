"""The port's snapshot codec against the JAX package's.

Both packages build from the same seeded numpy arrays. The port's
``pack_arrays`` must give the JAX package's bytes for the same arrays (and
the reverse decode must give the same arrays), so a snapshot packed by
either package decodes in the other; ``delta_encode``/``delta_apply`` must
give equal arrays; ``arrays_to_model`` must pad as the JAX package's
``build_model`` pads.
"""

from __future__ import annotations

import pathlib

import msgpack
import numpy as np
import pytest

from ccx.model import snapshot as jsnap
from ccx.model.fixtures import RandomClusterSpec, bench_spec, random_cluster
from ccx.sidecar import wire as jwire
from ccx_torch.model import snapshot as tsnap
from ccx_torch.model.tensor_model import TENSOR_FIELDS, model_from_arrays

FIXDIR = pathlib.Path(__file__).resolve().parent / "fixtures" / "sidecar"

SPECS = {
    "random": RandomClusterSpec(n_brokers=16, n_racks=4, n_topics=6, n_partitions=96, seed=11),
    "dead-brokers": RandomClusterSpec(
        n_brokers=8, n_racks=4, n_topics=4, n_partitions=64, seed=3, n_dead_brokers=2
    ),
    "jbod": bench_spec("B4"),
    "single-partition": RandomClusterSpec(n_brokers=3, n_racks=1, n_topics=1, n_partitions=1, seed=0),
    "B1": bench_spec("B1"),
}


def carry(jm):
    arrays = {k: np.asarray(getattr(jm, k)) for k in TENSOR_FIELDS}
    return model_from_arrays(arrays, jm.num_topics, jm.num_racks, "cpu")


def _same_arrays(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", list(SPECS))
def test_model_to_arrays_and_pack_are_byte_equal(name):
    jm = random_cluster(SPECS[name])
    tm = carry(jm)
    j_arrays, t_arrays = jsnap.model_to_arrays(jm), tsnap.model_to_arrays(tm)
    _same_arrays(t_arrays, j_arrays)
    packed = tsnap.to_msgpack(tm)
    assert packed == jsnap.to_msgpack(jm)
    # the same arrays through either package's packer
    assert tsnap.pack_arrays(j_arrays) == jsnap.pack_arrays(j_arrays)
    assert jsnap.pack_arrays(t_arrays) == packed


@pytest.mark.parametrize("name", list(SPECS))
def test_snapshots_decode_in_the_other_package(name):
    jm = random_cluster(SPECS[name])
    tm = carry(jm)
    _same_arrays(tsnap.decode_msgpack(jsnap.to_msgpack(jm)), jsnap.decode_msgpack(jsnap.to_msgpack(jm)))
    back = jsnap.from_msgpack(tsnap.to_msgpack(tm))
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("name", list(SPECS))
def test_arrays_to_model_pads_as_the_jax_package(name):
    jm = random_cluster(SPECS[name])
    d = jsnap.decode_msgpack(jsnap.to_msgpack(jm))
    jmodel = jsnap.arrays_to_model(d)
    tmodel = tsnap.arrays_to_model(d, device="cpu")
    assert (tmodel.num_topics, tmodel.num_racks) == (jmodel.num_topics, jmodel.num_racks)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tmodel, k).numpy(), np.asarray(getattr(jmodel, k)), err_msg=k)
    unpadded = tsnap.arrays_to_model(d, pad=False, device="cpu")
    assert unpadded.P == d["assignment"].shape[0]


def test_json_round_trip_matches():
    jm = random_cluster(SPECS["dead-brokers"])
    tm = carry(jm)
    assert tsnap.to_json(tm) == jsnap.to_json(jm)
    back = tsnap.from_json(jsnap.to_json(jm), device="cpu")
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(back, k).numpy(), getattr(tm, k).numpy(), err_msg=k)


@pytest.mark.parametrize("fields", [("leader_load",), ("leader_load", "follower_load"),
                                    ("broker_alive", "assignment")])
def test_delta_encode_and_apply_match(fields):
    jm = random_cluster(SPECS["random"])
    base = jsnap.model_to_arrays(jm)
    rng = np.random.default_rng(5)
    new = dict(base)
    for f in fields:
        a = base[f].copy()
        if a.dtype == bool:
            a[0] = ~a[0]
        elif f == "assignment":
            a[0, :] = a[1, :]
        else:
            a = (a * rng.uniform(0.5, 1.5, a.shape)).astype(a.dtype)
        new[f] = a
    jd, td = jsnap.delta_encode(base, new), tsnap.delta_encode(base, new)
    _same_arrays(td, jd)
    assert set(td) - {"version", "num_racks"} == set(fields)
    assert tsnap.pack_arrays(td) == jsnap.pack_arrays(jd)
    _same_arrays(tsnap.delta_apply(base, td), jsnap.delta_apply(base, jd))
    _same_arrays(tsnap.delta_apply(base, td), new)


def test_fixture_payloads_decode_equal_and_repack_byte_equal():
    for name in ("put_full_request.bin", "put_delta_request.bin", "put_full_request_fleet.bin"):
        req = msgpack.unpackb((FIXDIR / name).read_bytes(), raw=False)
        t, j = tsnap.decode_msgpack(req["packed"]), jsnap.decode_msgpack(req["packed"])
        _same_arrays(t, j)
        assert tsnap.pack_arrays(t) == req["packed"] == jsnap.pack_arrays(j)


def test_v1_snapshot_and_version_gate():
    jm = random_cluster(SPECS["random"])
    d = jsnap.model_to_arrays(jm)
    v1 = {k: v for k, v in d.items() if k != "broker_host"}
    v1["version"] = 1
    tm, jm1 = tsnap.arrays_to_model(v1, device="cpu"), jsnap.arrays_to_model(v1)
    np.testing.assert_array_equal(tm.broker_host.numpy(), np.asarray(jm1.broker_host))
    with pytest.raises(ValueError, match="unsupported snapshot version"):
        tsnap.arrays_to_model({**d, "version": tsnap.SCHEMA_VERSION + 1}, device="cpu")
    assert tsnap.ARRAY_FIELDS == jsnap.ARRAY_FIELDS
    assert tsnap.SCHEMA_VERSION == jsnap.SCHEMA_VERSION


def test_non_array_values_pack_canonically():
    d = {"z": {"b": 1, "a": [3, {"y": 1, "x": 2}]}, "a": np.arange(3, dtype=np.int64)}
    assert tsnap.pack_arrays(d) == jsnap.pack_arrays(d)
    assert msgpack.unpackb(tsnap.pack_arrays(d), raw=False)["z"] == jwire.canonicalize(d["z"])
