"""The virtual mesh: N logical devices over one physical device.

The JAX package gets N virtual devices from XLA's host-platform flag
(``ccx/common/vmesh.py``: ``force_host_devices``, ``ensure_host_devices``),
so its sharded path runs without a multi-chip host. The port's counterpart
is a process-wide list of N logical devices that all name one physical
device: the CPU in the tests, ``cuda:0`` on the card. Every mesh caller
(``ccx_torch.parallel.sharding.make_mesh``, the optimizer's run mesh, the
façade's device count, the bench's ``--scaling`` and ``--mesh``) reads
``devices()`` in place of the physical list; with nothing forced it returns
the visible CUDA devices.

A mesh over logical devices runs every shard's work, and every ``psum``, on
the one physical device: it prices the sharding structure (the launches and
the reductions per shard), not a multi-card speedup.

``force_devices`` keeps a list that is already forced, as the JAX flag is
kept once set; ``ensure_devices`` raises when fewer devices come up than
were asked for. ``forced`` sets a list for a ``with`` block and restores the
previous one, so a test cannot leak a mesh into the next test on the same
worker.
"""

from __future__ import annotations

import contextlib

import torch

#: the forced logical devices, or None: the physical CUDA devices
_FORCED: list[torch.device] | None = None


def _base(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def force_devices(n: int = 8, device=None) -> None:
    """Make ``devices()`` return ``n`` logical devices over ``device``
    (default: ``cuda:0`` where a card is visible, else the CPU). A list
    already forced is kept."""
    global _FORCED
    if _FORCED is None:
        _FORCED = [_base(device)] * max(int(n), 1)


def ensure_devices(n: int = 8, device=None) -> int:
    """``force_devices`` and check: returns the device count, raising when
    fewer than ``n`` devices are there (a smaller list was forced first)."""
    force_devices(n, device)
    got = len(devices())
    if got < n:
        raise RuntimeError(f"asked for {n} logical devices, {got} are forced")
    return got


def devices() -> list[torch.device]:
    """The forced logical devices, else the visible CUDA devices."""
    if _FORCED is not None:
        return list(_FORCED)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def virtual() -> bool:
    """True while a logical list is forced."""
    return _FORCED is not None


@contextlib.contextmanager
def forced(n: int, device=None):
    """``n`` logical devices over ``device`` for the block (replacing any
    list forced before), the previous list restored after."""
    global _FORCED
    prev = _FORCED
    _FORCED = [_base(device)] * max(int(n), 1)
    try:
        yield devices()
    finally:
        _FORCED = prev
