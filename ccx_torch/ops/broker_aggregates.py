"""Broker aggregates: the CUDA kernel's wrapper, its plain PyTorch version
and its launch counter.

``broker_aggregates_cuda`` launches ``ccx_torch/csrc/broker_aggregates.cu``
(built with nvcc for sm_90a at first use into ``ccx_torch/_build/`` and
loaded with ctypes). ``broker_aggregates_plain`` computes the same function
with ``index_add_``; the CPU path and the comparisons use it, and nothing on
the main path does when a card is present.
``ccx_torch.model.aggregates.broker_aggregates`` picks between them by the
model's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ccx_torch.common.resources import NUM_RESOURCES, Resource
from ccx_torch.model.aggregates import BrokerAggregates
from ccx_torch.model.tensor_model import TensorClusterModel

#: kernel launches made by ``broker_aggregates_cuda`` in this process
LAUNCHES = 0

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


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_library_path()))
            fn = lib.ccx_broker_aggregates
            fn.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_void_p] * 8 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            _lib = lib
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


def broker_aggregates_cuda(m: TensorClusterModel) -> BrokerAggregates:
    """One launch of the CUDA kernel on the current stream."""
    global LAUNCHES
    dev = m.device
    if dev.type != "cuda":
        raise ValueError(f"broker_aggregates_cuda needs a CUDA model, got {dev}")
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
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = BrokerAggregates(
        broker_load=torch.zeros(NUM_RESOURCES, B, **f32),
        replica_count=torch.zeros(B, **i32),
        leader_count=torch.zeros(B, **i32),
        potential_nw_out=torch.zeros(B, **f32),
        leader_bytes_in=torch.zeros(B, **f32),
        topic_replica_count=torch.zeros(T, B, **i32),
        topic_leader_count=torch.zeros(T, B, **i32),
        disk_load=torch.zeros(B, D, **f32),
    )
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccx_broker_aggregates(
            *(t.data_ptr() for _, t, _, _ in inputs),
            P, R, B, T, D,
            out.broker_load.data_ptr(), out.replica_count.data_ptr(),
            out.leader_count.data_ptr(), out.potential_nw_out.data_ptr(),
            out.leader_bytes_in.data_ptr(), out.topic_replica_count.data_ptr(),
            out.topic_leader_count.data_ptr(), out.disk_load.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"broker_aggregates kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


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
