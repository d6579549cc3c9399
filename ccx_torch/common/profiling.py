"""Device-side profiling: a ``torch.profiler`` capture of a block.

The port's counterpart of the JAX package's ``common/profiling.py``:

* ``with trace(log_dir):`` — a ``torch.profiler`` capture of the enclosed
  block (the CPU, and the card when there is one), exported as a Chrome
  trace into ``log_dir``. Without a directory it does nothing; a trace
  requested inside another does nothing either (one per process).
* ``with capture() as prof:`` — the same capture, handed to the caller
  (``prof`` is the ``torch.profiler.profile``, or None inside another
  capture) instead of exported: a whole B5 proposal's events make a Chrome
  trace of hundreds of megabytes.

While either records, every span of the tracer (``ccx_torch.common.
tracing``) is a ``ccx:<name>`` range on the capture's timeline, and the
spans' ``startNs``/``endNs`` lie on the clock of its host events.

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
def capture(log_dir: str | None = None):
    """A ``torch.profiler`` capture of the block (CPU activity, and CUDA
    when a card is visible); yields the profile, or None when another
    capture is recording. With ``log_dir`` the capture is exported there
    as ``ccx-trace-<pid>-<n>.json`` once the block ends. The flight
    recorder notes the start and the stop, so a recording names the trace
    that covers its window."""
    global _ACTIVE, _SEQ
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ccx_torch.common.tracing import TRACER

    with _LOCK:
        started = not _ACTIVE
        _ACTIVE = _ACTIVE or started
        _SEQ += started
        seq = _SEQ
    if not started:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    note = {"dir": log_dir} if log_dir else {}
    try:
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        TRACER._record({"ev": "trace-start", **note})
        with profile(activities=activities) as prof:
            yield prof
        if log_dir:
            note["file"] = os.path.join(log_dir, f"ccx-trace-{os.getpid()}-{seq}.json")
            prof.export_chrome_trace(note["file"])
        TRACER._record({"ev": "trace-stop", **note})
    finally:
        with _LOCK:
            _ACTIVE = False


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``capture``); yields whether this call started one. Without a
    directory it does nothing."""
    if not log_dir:
        yield False
        return
    with capture(log_dir) as prof:
        yield prof is not None
