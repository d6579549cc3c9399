"""Native host-side kernels (C++ via ctypes, numpy fallback).

Build with ``python -m ccx_torch.native.build`` into
``ccx_torch/_build/native/`` (or let the first use try a quiet on-demand g++
build — the toolchain is a build-time convenience, never a runtime
requirement: every entry point has a numpy fallback). ``state()`` says
whether the library loaded and how many scatters ran natively or fell back.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

log = logging.getLogger(__name__)

_LIB_NAME = "libccxnative.so"
_lib: ctypes.CDLL | None = None
_tried = False
_load_lock = __import__("threading").Lock()
#: scatters served by the library, and those handed back to numpy
_SCATTERS = {"native": 0, "fallback": 0}
_scatters_lock = __import__("threading").Lock()


def _count(path: str) -> None:
    with _scatters_lock:
        _SCATTERS[path] += 1


def _lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build",
                        "native", _LIB_NAME)


def load(build_if_missing: bool = True) -> ctypes.CDLL | None:
    """The shared library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        if _tried:  # lost the race: another thread already resolved it
            return _lib
        return _load_locked(build_if_missing)


def _load_locked(build_if_missing: bool) -> ctypes.CDLL | None:
    global _lib, _tried
    _tried = True
    path = _lib_path()
    if not os.path.exists(path) and build_if_missing:
        try:
            from ccx_torch.native.build import build

            build(quiet=True)
        except Exception:  # toolchain missing: fall back silently
            log.debug("native build unavailable", exc_info=True)
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            pd = ctypes.POINTER(ctypes.c_double)
            pi = ctypes.POINTER(ctypes.c_int64)
            lib.ccx_scatter.restype = None
            lib.ccx_scatter.argtypes = [
                pd, pd, pd, pi, pi, pi, pi, pi, pd,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.ccx_decode_partition_samples.restype = ctypes.c_int64
            lib.ccx_decode_partition_samples.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, pi, pi, pd,
            ]
            _lib = lib
        except OSError:
            log.warning("failed to load %s", path, exc_info=True)
    return _lib


def available() -> bool:
    return load() is not None


def state() -> dict:
    """Whether the library loaded, from where, and which path the
    aggregator's scatters took."""
    return {"available": available(), "path": _lib_path() if _lib else None,
            "scatters": dict(_SCATTERS)}


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def scatter(sum_: np.ndarray, mx: np.ndarray, latest: np.ndarray,
            latest_t: np.ndarray, count: np.ndarray,
            entities: np.ndarray, slots: np.ndarray, times: np.ndarray,
            metrics: np.ndarray) -> bool:
    """Fused windowed-scatter; returns False if the caller must use the
    numpy path. Arrays must be C-contiguous with the aggregator's dtypes."""
    lib = load()
    if lib is None:
        _count("fallback")
        return False
    n = entities.shape[0]
    W, M = sum_.shape[1], sum_.shape[2]
    if not (
        sum_.flags.c_contiguous and mx.flags.c_contiguous
        and latest.flags.c_contiguous and latest_t.flags.c_contiguous
        and count.flags.c_contiguous
    ):
        _count("fallback")
        return False
    entities = np.ascontiguousarray(entities, np.int64)
    slots = np.ascontiguousarray(slots, np.int64)
    times = np.ascontiguousarray(times, np.int64)
    metrics = np.ascontiguousarray(metrics, np.float64)
    lib.ccx_scatter(
        _ptr(sum_, ctypes.c_double), _ptr(mx, ctypes.c_double),
        _ptr(latest, ctypes.c_double), _ptr(latest_t, ctypes.c_int64),
        _ptr(count, ctypes.c_int64), _ptr(entities, ctypes.c_int64),
        _ptr(slots, ctypes.c_int64), _ptr(times, ctypes.c_int64),
        _ptr(metrics, ctypes.c_double), n, W, M,
    )
    _count("native")
    return True


def decode_partition_samples(buf: bytes, capacity: int, n_metrics: int):
    """(ids, times, metrics) columnar decode of a partition-sample log, or
    None if the native library is unavailable or the log is malformed."""
    lib = load()
    if lib is None:
        return None
    ids = np.empty(capacity, np.int64)
    times = np.empty(capacity, np.int64)
    metrics = np.empty((capacity, n_metrics), np.float64)
    # zero-copy view: the C side only reads, so pass the bytes' own buffer
    view = np.frombuffer(buf, np.uint8)
    n = lib.ccx_decode_partition_samples(
        _ptr(view, ctypes.c_ubyte), len(buf), capacity,
        n_metrics, _ptr(ids, ctypes.c_int64), _ptr(times, ctypes.c_int64),
        _ptr(metrics, ctypes.c_double),
    )
    if n < 0:
        return None
    return ids[:n], times[:n], metrics[:n]
