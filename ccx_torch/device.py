"""Device selection and the card's liveness probe for the port's entry points.

``resolve_device`` picks the device an entry point runs on: the CUDA device
unless the caller asks for another; the port never drops to the CPU on its
own.

``ensure_responsive_backend`` is the long-running entry points' startup
check (``python -m ccx_torch.sidecar.server``): a card that hangs every
launch must fail the server at startup, not hang its first Propose. It
creates a CUDA tensor and synchronizes in a subprocess under a timeout
(``CCX_DEVICE_PROBE_TIMEOUT`` seconds, default 60; 0 disables the probe; an
invalid or negative value gives the default, with a warning). A probe that
fails or hangs raises ``DeviceUnresponsive``. Unlike the JAX package's
probe it never switches to the CPU: a CPU fallback would hide a lost card
behind slow answers.

The probe child is sent SIGTERM with a grace period and only then killed,
and reaping is bounded, so a child stuck in device I/O cannot hang the
caller.

``synchronize`` is the port's one device-wide synchronize: it waits out a
CUDA graph capture that another thread (a fleet job) has under way.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading

import torch

log = logging.getLogger(__name__)

#: env knob of the probe's timeout in seconds (0 disables the probe)
ENV_PROBE_TIMEOUT = "CCX_DEVICE_PROBE_TIMEOUT"
DEFAULT_PROBE_TIMEOUT_S = 60

#: the probe child's program: one tensor on the card, one synchronize
PROBE_CODE = "import torch\nx = torch.ones(1, device='cuda') + 1\ntorch.cuda.synchronize()\n"


class DeviceUnresponsive(RuntimeError):
    """The liveness probe failed or timed out."""


#: held while a CUDA graph captures (``ccx_torch.search.graphs``): a
#: device-wide synchronize from another thread fails during a capture and
#: invalidates it, so ``synchronize`` waits for the capture to end
CAPTURE_LOCK = threading.Lock()


def synchronize(device: torch.device) -> None:
    """Wait for every kernel queued on ``device``, never while another
    thread captures a graph (``CAPTURE_LOCK``); a device that is not CUDA
    has nothing to drain and returns at once. The port's one
    ``torch.cuda.synchronize``: a failing one raises."""
    if device.type != "cuda":
        return
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA by default.

    ``None`` means the first CUDA device and raises when there is none — the
    port never drops to the CPU on its own. Pass ``"cpu"`` to run the plain
    PyTorch paths on the host (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def probe_devices(timeout_s: int) -> int | None:
    """Run the probe child with a timeout. Returns its exit code, or None
    on timeout."""
    probe = subprocess.Popen(
        [sys.executable, "-c", PROBE_CODE],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    rc: int | None
    try:
        probe.communicate(timeout=timeout_s)
        rc = probe.returncode
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if probe.poll() is None:
            probe.terminate()
            try:
                probe.wait(timeout=15)
            except subprocess.TimeoutExpired:
                probe.kill()
                try:
                    # a child stuck in device I/O can survive SIGKILL:
                    # reaping must not block the caller
                    probe.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
    return rc


def probe_timeout_s() -> int:
    """``CCX_DEVICE_PROBE_TIMEOUT`` in seconds; the default for an unset,
    invalid or negative value (only an explicit 0 disables the probe)."""
    raw = os.environ.get(ENV_PROBE_TIMEOUT)
    if raw is None:
        return DEFAULT_PROBE_TIMEOUT_S
    try:
        timeout_s = int(raw)
    except ValueError:
        log.warning("%s=%r is not an integer; using %d", ENV_PROBE_TIMEOUT, raw,
                    DEFAULT_PROBE_TIMEOUT_S)
        return DEFAULT_PROBE_TIMEOUT_S
    if timeout_s < 0:
        log.warning("%s=%d is negative; using %d", ENV_PROBE_TIMEOUT, timeout_s,
                    DEFAULT_PROBE_TIMEOUT_S)
        return DEFAULT_PROBE_TIMEOUT_S
    return timeout_s


def ensure_responsive_backend(timeout_s: int | None = None) -> bool:
    """Probe the card. Returns True when it answered, or when the probe is
    disabled (timeout 0); raises ``DeviceUnresponsive`` when it failed or
    hung."""
    if timeout_s is None:
        timeout_s = probe_timeout_s()
    if timeout_s == 0:
        return True
    rc = probe_devices(timeout_s)
    if rc == 0:
        return True
    reason = (f"the device probe hung for {timeout_s} s" if rc is None
              else f"the device probe exited with {rc}")
    raise DeviceUnresponsive(f"{reason}: no responsive CUDA device; the port does not fall back "
                             f"to the CPU")
