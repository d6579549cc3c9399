"""Snapshot codec — the cluster model's wire and file format.

The port's copy of the JAX package's ``model/snapshot.py``, on the same
schema, so a snapshot packed by either package decodes in the other (the
sidecar's gRPC payload, and the CLI's JSON files). Two encodings share the
schema:

* **JSON** — human-readable files for the CLI; arrays as nested lists.
* **msgpack** — the wire format: arrays as raw little-endian buffers with
  dtype/shape headers (zero-copy into numpy). ``pack_arrays`` emits
  canonical bytes by construction (map keys sorted), identical to the JAX
  package's for the same arrays.

Delta snapshots (``delta_encode``/``delta_apply``) carry only the changed
fields, keyed by the base generation.

``arrays_to_model`` builds the padded model on an explicit device (the
CUDA device by default, like every entry point of the port).
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from ccx_torch.model.tensor_model import TensorClusterModel, build_model

#: fields build_model accepts directly (arrays); kept in one place so the
#: codec, delta logic, and proto schema stay aligned
ARRAY_FIELDS = (
    "assignment",
    "leader_slot",
    "replica_disk",
    "partition_topic",
    "partition_immovable",
    "leader_load",
    "follower_load",
    "broker_capacity",
    "broker_rack",
    "broker_host",
    "broker_alive",
    "broker_new",
    "broker_excl_replicas",
    "broker_excl_leadership",
    "disk_capacity",
    "disk_alive",
    "topic_min_leaders",
)

#: v2 adds ``broker_host``. Decoding is backward compatible: a v1 snapshot
#: without the field builds a model with the one-host-per-broker default.
SCHEMA_VERSION = 2


def model_to_arrays(m: TensorClusterModel, strip_padding: bool = True) -> dict[str, Any]:
    """Dense (unpadded) numpy copies of a model, build_model-compatible."""
    P = int(m.partition_valid.sum())
    B = int(m.broker_valid.sum())
    if not strip_padding:
        P, B = m.P, m.B

    def arr(name: str) -> np.ndarray:
        return getattr(m, name).cpu().numpy()

    return {
        "version": SCHEMA_VERSION,
        "num_racks": m.num_racks,
        "assignment": arr("assignment")[:P],
        "leader_slot": arr("leader_slot")[:P],
        "replica_disk": arr("replica_disk")[:P],
        "partition_topic": arr("partition_topic")[:P],
        "partition_immovable": arr("partition_immovable")[:P],
        "leader_load": arr("leader_load")[:, :P],
        "follower_load": arr("follower_load")[:, :P],
        "broker_capacity": arr("broker_capacity")[:, :B],
        "broker_rack": arr("broker_rack")[:B],
        "broker_host": arr("broker_host")[:B],
        "broker_alive": arr("broker_alive")[:B],
        "broker_new": arr("broker_new")[:B],
        "broker_excl_replicas": arr("broker_excl_replicas")[:B],
        "broker_excl_leadership": arr("broker_excl_leadership")[:B],
        "disk_capacity": arr("disk_capacity")[:B],
        "disk_alive": arr("disk_alive")[:B],
        "topic_min_leaders": arr("topic_min_leaders"),
    }


def arrays_to_model(
    d: dict[str, Any], pad: bool = True, device: str | torch.device | None = None
) -> TensorClusterModel:
    """The padded model of a decoded snapshot (padding as ``build_model``
    pads), on ``device`` (None: the CUDA device)."""
    if d.get("version", 1) > SCHEMA_VERSION:
        raise ValueError(f"unsupported snapshot version {d['version']}")
    kwargs = {k: np.asarray(d[k]) for k in ARRAY_FIELDS if k in d}
    return build_model(num_racks=d.get("num_racks"), pad=pad, device=device, **kwargs)


# ----- JSON ----------------------------------------------------------------

def to_json(m: TensorClusterModel) -> str:
    d = model_to_arrays(m)
    enc = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    return json.dumps(enc)


def from_json(s: str, device: str | torch.device | None = None) -> TensorClusterModel:
    return arrays_to_model(json.loads(s), device=device)


# ----- msgpack (wire) ------------------------------------------------------

def _unpack_array(d: dict) -> np.ndarray:
    a = np.frombuffer(d["b"], dtype=np.dtype(d["d"])).reshape(d["s"])
    if a.dtype == np.uint8 and d.get("bool"):
        return a.astype(bool)
    return a


_BOOL_FIELDS = {
    "partition_immovable", "broker_alive", "broker_new",
    "broker_excl_replicas", "broker_excl_leadership", "disk_alive",
    "topic_min_leaders",
}


def pack_arrays(d: dict[str, Any]) -> bytes:
    """msgpack-encode an arrays dict (full snapshot, delta fields, or a
    columnar result blob) in canonical bytes: top-level keys emitted
    sorted, each array entry built in its sorted key order (``b`` <
    ``bool`` < ``d`` < ``s``), any other container sorted recursively.
    bool arrays travel as uint8, int64 as int32 and float64 as float32."""
    import msgpack

    from ccx_torch.sidecar.wire import canonicalize

    enc: dict[str, Any] = {}
    for k in sorted(d):
        v = d[k]
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            if a.dtype == np.bool_:
                a = a.astype(np.uint8)
            if a.dtype == np.int64:
                a = a.astype(np.int32)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            p: dict[str, Any] = {"b": a.tobytes()}
            if k in _BOOL_FIELDS:
                p["bool"] = True
            p["d"] = a.dtype.str
            p["s"] = list(a.shape)
            enc[k] = p
        else:
            enc[k] = canonicalize(v)
    return msgpack.packb(enc, use_bin_type=True)


def to_msgpack(m: TensorClusterModel) -> bytes:
    return pack_arrays(model_to_arrays(m))


def from_msgpack(buf: bytes, device: str | torch.device | None = None) -> TensorClusterModel:
    return arrays_to_model(decode_msgpack(buf), device=device)


def decode_msgpack(buf: bytes) -> dict[str, Any]:
    import msgpack

    raw = msgpack.unpackb(buf, raw=False)
    return {
        k: _unpack_array(v) if isinstance(v, dict) and "b" in v else v
        for k, v in raw.items()
    }


# ----- deltas (generation-keyed) -------------------------------------------

def delta_encode(base: dict[str, Any], new: dict[str, Any]) -> dict[str, Any]:
    """Fields of ``new`` that differ from ``base`` (plus scalars)."""
    out: dict[str, Any] = {"version": new.get("version", SCHEMA_VERSION),
                           "num_racks": new.get("num_racks")}
    for k in ARRAY_FIELDS:
        if k not in new:
            continue
        a, b = base.get(k), new[k]
        if a is None or np.asarray(a).shape != np.asarray(b).shape or not np.array_equal(a, b):
            out[k] = b
    return out


def delta_apply(base: dict[str, Any], delta: dict[str, Any]) -> dict[str, Any]:
    out = dict(base)
    out.update({k: v for k, v in delta.items() if v is not None})
    return out
