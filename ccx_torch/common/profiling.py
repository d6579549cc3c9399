"""Device-side profiling hooks.

The port's counterpart of the JAX package's ``common/profiling.py``:

* ``with annotate("ccx:anneal", device):`` — a named range on the device
  timeline: an NVTX range on a CUDA device (what a CUDA profiler's timeline
  shows), ``torch.profiler.record_function`` otherwise (what a
  ``torch.profiler`` trace shows). Cheap; the optimizer's phases run under
  one each.
* ``with trace(log_dir):`` — a ``torch.profiler`` capture of the enclosed
  block (the CPU, and the card when there is one), exported as a Chrome
  trace into ``log_dir``. Without a directory it does nothing; a trace
  requested inside another does nothing either (one per process).

Once ``torch.profiler`` has traced the card, every later launch in the
process is slower (measured on an H100: a B5 target run took 60–73 s
after a traced window against 35–55 s before it), so ``trace`` is never
armed on a measured path.
"""

from __future__ import annotations

import contextlib
import os
import threading

#: serializes start/stop: one trace per process
_LOCK = threading.Lock()
_ACTIVE = False
_SEQ = 0


@contextlib.contextmanager
def annotate(name: str, device=None):
    """Named region: NVTX on a CUDA ``device``, a profiler record
    otherwise."""
    import torch

    if device is not None and getattr(device, "type", None) == "cuda":
        with torch.cuda.nvtx.range(name):
            yield
    else:
        with torch.profiler.record_function(name):
            yield


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir`` as
    ``ccx-trace-<pid>-<n>.json``; yields whether this call started one.
    The flight recorder notes the start and the stop, so a recording names
    the trace that covers its window."""
    global _ACTIVE, _SEQ
    if not log_dir:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ccx_torch.common.tracing import TRACER

    with _LOCK:
        started = not _ACTIVE
        _ACTIVE = _ACTIVE or started
        _SEQ += started
        seq = _SEQ
    if not started:
        yield False
        return
    path = os.path.join(log_dir, f"ccx-trace-{os.getpid()}-{seq}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(log_dir, exist_ok=True)
        TRACER._record({"ev": "trace-start", "dir": log_dir})
        with profile(activities=activities) as prof:
            yield True
        prof.export_chrome_trace(path)
        TRACER._record({"ev": "trace-stop", "dir": log_dir, "file": path})
    finally:
        with _LOCK:
            _ACTIVE = False
