"""Broker aggregates: the CUDA kernel's wrapper, its plain PyTorch version
and its launch counter.

``broker_aggregates_cuda`` launches ``ccx_torch/csrc/broker_aggregates.cu``
(built with nvcc for sm_90a at first use into ``ccx_torch/_build/`` and
loaded with ctypes). It hands the kernel the model's topic index (the live
partitions grouped by topic, built once per ``partition_topic`` /
``partition_valid`` pair and cached) and one ``torch.empty`` buffer that
``carve`` cuts into the eight fields. The kernel sums the per-broker rows in
shared memory or straight into the output, as ``plan`` shows; it chooses
from the model's sizes unless ``rows`` names one way, as the on-card checks
do to hold both against the plain version. ``broker_aggregates_plain`` computes
the same function with ``index_add_``; the CPU path and the comparisons use
it, and nothing on the main path does when a card is present.
``ccx_torch.model.aggregates.broker_aggregates`` picks between them by the
model's device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import NamedTuple

import torch

from ccx_torch.common.resources import NUM_RESOURCES, Resource
from ccx_torch.model.aggregates import BrokerAggregates
from ccx_torch.model.tensor_model import TensorClusterModel

#: kernel launches made by ``broker_aggregates_cuda`` in this process
LAUNCHES = 0
_launch_lock = threading.Lock()

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "broker_aggregates.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _library_path() -> Path:
    """The library's path, keyed on a hash of the source and the flags, so a
    build of other sources or flags is never loaded."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbroker_aggregates.{h.hexdigest()[:8]}.so"

_lib = None
_lib_lock = threading.Lock()
#: devices on which ``ccx_broker_aggregates_init`` has run
_ready_devices: set[int] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def build(verbose: bool = False) -> str:
    """Compile the kernel into ``ccx_torch/_build/`` unless the library of
    these sources and flags is there. Returns nvcc's output (``-Xptxas -v``
    with ``verbose``); raises with it when the build fails."""
    library = _library_path()
    if library.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr


def _library(dev: torch.device):
    """The loaded library, initialised for ``dev`` (once per device)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_library_path()))
            lib.ccx_broker_aggregates_init.argtypes = [ctypes.c_int]
            lib.ccx_broker_aggregates_init.restype = ctypes.c_int
            fn = lib.ccx_broker_aggregates
            fn.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            lib.ccx_broker_aggregates_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
            lib.ccx_broker_aggregates_plan.restype = ctypes.c_int
            _lib = lib
        if dev.index not in _ready_devices:
            with torch.cuda.device(dev):
                rc = _lib.ccx_broker_aggregates_init(dev.index)
            if rc != 0:
                raise RuntimeError(f"broker_aggregates kernel setup failed: cudaError {rc}")
            _ready_devices.add(dev.index)
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


# --- the topic index -----------------------------------------------------------


class TopicIndex(NamedTuple):
    """The live partitions grouped by topic: ``order[offsets[t]:offsets[t+1]]``
    are the live partitions of topic ``t`` in ascending order, and
    ``order[offsets[T]:]`` the live partitions whose topic is outside
    ``[0, T)``."""

    order: torch.Tensor    # int32[n_live]
    offsets: torch.Tensor  # int32[T + 1]


def build_topic_index(partition_topic: torch.Tensor, partition_valid: torch.Tensor,
                      num_topics: int) -> TopicIndex:
    """The topic index, with torch ops on the tensors' device (one stable
    sort, one bincount, one cumsum, and one read of the live count)."""
    T = num_topics
    in_range = (partition_topic >= 0) & (partition_topic < T)
    key = torch.where(partition_valid, torch.where(in_range, partition_topic, T), T + 1).long()
    counts = torch.bincount(key, minlength=T + 2)
    offsets = torch.zeros(T + 1, dtype=torch.int32, device=key.device)
    offsets[1:] = torch.cumsum(counts[:T], 0)
    n_live = int(counts[: T + 1].sum())
    order = torch.argsort(key, stable=True)[:n_live].to(torch.int32)
    return TopicIndex(order, offsets)


class _Cached:
    __slots__ = ("topic", "valid", "versions", "num_topics", "index")


#: (id(partition_topic), id(partition_valid)) -> the index built from them.
#: An entry holds weak references to both tensors and their versions, so a
#: model with other (or in-place changed) tensors never reuses it; it is
#: dropped when either tensor is freed.
_TOPIC_INDEX: dict[tuple[int, int], _Cached] = {}


def topic_index(m: TensorClusterModel) -> TopicIndex:
    """The model's topic index, built once for its ``partition_topic`` and
    ``partition_valid`` tensors. No stage of the search changes either, so
    every model of one optimisation shares one index."""
    topic, valid = m.partition_topic, m.partition_valid
    key = (id(topic), id(valid))
    hit = _TOPIC_INDEX.get(key)
    versions = (topic._version, valid._version)
    if (hit is not None and hit.topic() is topic and hit.valid() is valid
            and hit.versions == versions and hit.num_topics == m.num_topics):
        return hit.index
    entry = _Cached()

    def drop(_ref, key=key):
        gone = _TOPIC_INDEX.get(key)
        if gone is not None and (gone.topic() is None or gone.valid() is None):
            _TOPIC_INDEX.pop(key, None)

    entry.topic, entry.valid = weakref.ref(topic, drop), weakref.ref(valid, drop)
    entry.versions, entry.num_topics = versions, m.num_topics
    entry.index = build_topic_index(topic, valid, m.num_topics)
    _TOPIC_INDEX[key] = entry
    return entry.index


# --- the output buffer ---------------------------------------------------------


#: (name, word offset, shape, dtype) of each field
Layout = tuple[tuple[str, int, tuple, torch.dtype], ...]


@functools.lru_cache(maxsize=64)
def output_layout(B: int, T: int, D: int) -> tuple[Layout, int]:
    """The eight fields' places in the one int32 output buffer: (name, word
    offset, shape, dtype) each, and the buffer's length in words. The two
    topic matrices come first (the kernel writes them whole); then the
    kernel's eight per-broker rows in its order, then the disk rows, all of
    which it zeroes with one memset and adds into."""
    fields = (
        ("topic_replica_count", (T, B), torch.int32),
        ("topic_leader_count", (T, B), torch.int32),
        ("broker_load", (NUM_RESOURCES, B), torch.float32),
        ("replica_count", (B,), torch.int32),
        ("leader_count", (B,), torch.int32),
        ("potential_nw_out", (B,), torch.float32),
        ("leader_bytes_in", (B,), torch.float32),
        ("disk_load", (B, D), torch.float32),
    )
    layout, words = [], 0
    for name, shape, dtype in fields:
        layout.append((name, words, shape, dtype))
        words += math.prod(shape)
    return tuple(layout), words


def carve(buf: torch.Tensor, B: int, T: int, D: int) -> BrokerAggregates:
    """The eight fields as views of ``buf`` (int32, ``output_layout``'s
    length)."""
    layout, _ = output_layout(B, T, D)
    parts = buf.split([math.prod(shape) for _, _, shape, _ in layout])
    return BrokerAggregates(**{
        name: (part if dtype == torch.int32 else part.view(dtype)).view(shape)
        for (name, _, shape, dtype), part in zip(layout, parts)
    })


#: ``rows`` of ``broker_aggregates_cuda`` and ``plan``, as the kernel's code
ROWS = {"auto": -1, "global": 0, "shared": 1}


def plan(m: TensorClusterModel, rows: str = "auto") -> dict:
    """How the kernel runs on ``m``: ``rows`` (``"shared"``: each block sums
    the per-broker rows in shared memory and its cluster reduces them;
    ``"global"``: every replica adds into the output), the broker ``tiles``
    and their width ``BT``, the topics per pass ``KT``, the blocks per tile
    and the dynamic shared bytes of a block."""
    dev = _cuda_device(m)
    lib = _library(dev)
    out = (ctypes.c_int * 6)()
    n_live = topic_index(m).order.numel()
    with _launch_lock:
        rc = lib.ccx_broker_aggregates_plan(n_live, m.R, m.B, m.num_topics, m.D, dev.index,
                                            ROWS[rows], out)
    if rc != 0:
        raise RuntimeError(f"broker_aggregates kernel plan failed: cudaError {rc}")
    return {"rows": "shared" if out[0] else "global", "tiles": out[1], "BT": out[2],
            "KT": out[3], "blocks_per_tile": out[4], "smem_bytes": out[5]}


def _cuda_device(m: TensorClusterModel) -> torch.device:
    if m.device.type != "cuda":
        raise ValueError(f"broker_aggregates_cuda needs a CUDA model, got {m.device}")
    return m.device


def broker_aggregates_cuda(m: TensorClusterModel, rows: str = "auto") -> BrokerAggregates:
    """One launch of the CUDA kernel on the current stream; ``rows`` as in
    ``plan``."""
    global LAUNCHES
    dev = _cuda_device(m)
    P, R, B, D, T = m.P, m.R, m.B, m.D, m.num_topics
    inputs = (
        ("assignment", m.assignment, torch.int32, (P, R)),
        ("leader_slot", m.leader_slot, torch.int32, (P,)),
        ("replica_disk", m.replica_disk, torch.int32, (P, R)),
        ("partition_valid", m.partition_valid, torch.bool, (P,)),
        ("partition_topic", m.partition_topic, torch.int32, (P,)),
        ("leader_load", m.leader_load, torch.float32, (NUM_RESOURCES, P)),
        ("follower_load", m.follower_load, torch.float32, (NUM_RESOURCES, P)),
    )
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape, dev)
    lib = _library(dev)
    index = topic_index(m)
    buf = torch.empty(output_layout(B, T, D)[1], dtype=torch.int32, device=dev)
    # one launch at a time: the library's per-device plan cache is shared
    # by every thread (fleet jobs launch from several)
    with _launch_lock, torch.cuda.device(dev):
        rc = lib.ccx_broker_aggregates(
            index.order.data_ptr(), index.offsets.data_ptr(), index.order.numel(),
            m.assignment.data_ptr(), m.leader_slot.data_ptr(), m.replica_disk.data_ptr(),
            m.partition_topic.data_ptr(), m.leader_load.data_ptr(), m.follower_load.data_ptr(),
            P, R, B, T, D, ROWS[rows], buf.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc == 0:
            LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"broker_aggregates kernel launch failed: cudaError {rc}")
    return carve(buf, B, T, D)


def broker_aggregates_plain(m: TensorClusterModel) -> BrokerAggregates:
    """The same function in plain PyTorch (``index_add_``), on any device."""
    B, T, D = m.B, m.num_topics, m.D
    valid = m.replica_valid
    is_leader = m.is_leader
    seg = torch.where(valid, m.assignment, B).reshape(-1).long()
    slot_load = m.replica_load.reshape(NUM_RESOURCES, -1)

    def bsum(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(B + 1, dtype=x.dtype, device=x.device)
        return out.index_add_(0, seg, x)[:B]

    broker_load = torch.zeros(NUM_RESOURCES, B + 1, device=m.device).index_add_(
        1, seg, slot_load
    )[:, :B]
    pot = torch.where(valid, m.leader_load[Resource.NW_OUT][:, None], 0.0)
    lbi = torch.where(is_leader, m.leader_load[Resource.NW_IN][:, None], 0.0)

    tb = torch.where(
        valid, m.partition_topic[:, None] * B + m.assignment, T * B
    ).reshape(-1).long()

    def tbsum(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(T * B + 1, dtype=torch.int32, device=m.device)
        return out.index_add_(0, tb, x.reshape(-1).int())[: T * B].reshape(T, B)

    bd = torch.where(
        valid & (m.replica_disk >= 0), m.assignment * D + m.replica_disk, B * D
    ).reshape(-1).long()
    disk_load = torch.zeros(B * D + 1, device=m.device).index_add_(
        0, bd, slot_load[Resource.DISK]
    )[: B * D].reshape(B, D)
    return BrokerAggregates(
        broker_load=broker_load,
        replica_count=bsum(valid.reshape(-1).int()),
        leader_count=bsum(is_leader.reshape(-1).int()),
        potential_nw_out=bsum(pot.reshape(-1)),
        leader_bytes_in=bsum(lbi.reshape(-1)),
        topic_replica_count=tbsum(valid),
        topic_leader_count=tbsum(is_leader),
        disk_load=disk_load,
    )
