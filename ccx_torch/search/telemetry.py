"""Convergence telemetry: per-chunk quality taps kept on the device.

A tap is a ``(max_chunks, G + EXTRA)`` float32 ring buffer and its row
count, both tensors on the search's device. Every chunked engine (the SA
drive, ``greedy_optimize`` and ``swap_polish``) writes one row at the end of
each chunk: the full per-goal lex cost vector (the lex-best chain's, for
several chains), the cumulative per-move-kind proposal and acceptance
counters (``state.MOVE_KIND_NAMES`` order), the temperature at the chunk's
last step and the chunk's replica-exchange attempt and accept counts.

* **No host read while recording.** ``record`` is an in-place index copy
  on the device; ``decode`` reads the buffer once, after the drive.
* **Off switch.** With ``enabled()`` false the engines pass no tap and
  their results are the same (a tap never feeds back into the search).
* **Truncation.** A run longer than ``max_chunks`` chunks writes its later
  chunks to the last row: rows ``0..max_chunks-2`` keep the opening of the
  run, the last row the latest chunk, and ``decode`` flags ``truncated``
  with the true chunk count.

The host-side analysis (plateau detection, budget proposals) lives in
``ccx_torch.common.convergence``.
"""

from __future__ import annotations

import contextlib
import os

import torch

#: row layout past the G goal costs: 3 proposal counters, 3 acceptance
#: counters, temperature, and the replica-exchange attempt/accept counters
#: (zero for engines without a ladder)
EXTRA = 9

#: environment off switch (``CCX_CONVERGENCE=0`` disables the taps)
ENV_CONVERGENCE = "CCX_CONVERGENCE"

_DEFAULT_MAX_CHUNKS = 256

_state: dict = {"enabled": None, "max_chunks": _DEFAULT_MAX_CHUNKS}


def enabled() -> bool:
    """Taps armed? An explicit ``set_enabled`` wins, else the environment
    (``CCX_CONVERGENCE=0`` disables), else on."""
    v = _state["enabled"]
    if v is None:
        return os.environ.get(ENV_CONVERGENCE, "1") != "0"
    return bool(v)


def set_enabled(v: bool | None) -> None:
    """Explicitly arm or disarm (None restores the environment/default)."""
    _state["enabled"] = v


def max_chunks() -> int:
    return int(_state["max_chunks"])


def set_max_chunks(n: int) -> None:
    """Ring-buffer depth."""
    _state["max_chunks"] = max(int(n), 1)


def configure(enabled: bool | None = None, max_chunks: int | None = None) -> None:
    """Config-driven setup."""
    if enabled is not None:
        set_enabled(bool(enabled))
    if max_chunks is not None and max_chunks > 0:
        set_max_chunks(max_chunks)


@contextlib.contextmanager
def taps(v: bool | None):
    """Force the taps on or off within a block."""
    prev = _state["enabled"]
    _state["enabled"] = v
    try:
        yield
    finally:
        _state["enabled"] = prev


# ----- device side -----------------------------------------------------------


def make_tap(n_goals: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A fresh ``(buffer float32[max_chunks, G + EXTRA], count int32[])``."""
    return (
        torch.zeros(max_chunks(), int(n_goals) + EXTRA, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def lex_best_row(cost_vecs: torch.Tensor) -> torch.Tensor:
    """Lexicographic argmin over chains, ``[K, G] -> [G]``, by the column
    elimination the descents' selection uses (ties within tolerance go to
    the first chain)."""
    K, G = cost_vecs.shape
    alive = torch.ones(K, dtype=torch.bool, device=cost_vecs.device)
    for g in range(G):
        col = torch.where(alive, cost_vecs[:, g], float("inf"))
        mn = col.min()
        alive = alive & (col <= mn + (1e-6 + 1e-6 * mn.abs()))
    return cost_vecs.index_select(0, alive.int().argmax().reshape(1))[0]


def record(tap, cost_vec, n_prop, n_acc, temperature, ex_attempted=None, ex_accepted=None) -> None:
    """Write one chunk's row in place (to the last row once the buffer is
    full) and advance the count. The cumulative move counters share the
    float32 row with the costs, so they are exact below 2**24.
    ``ex_attempted``/``ex_accepted`` are this chunk's replica-exchange pair
    counts; engines without a ladder omit them and write zeros."""
    buf, n = tap
    dev = buf.device

    def col(x) -> torch.Tensor:
        # a host number becomes a device fill, never a host-to-device copy
        # (which would wait for the stream)
        if torch.is_tensor(x):
            return x.to(dev, torch.float32).reshape(-1)
        return torch.full((1,), 0.0 if x is None else float(x), dtype=torch.float32, device=dev)

    row = torch.cat([
        col(cost_vec), col(n_prop), col(n_acc),
        col(temperature), col(ex_attempted), col(ex_accepted),
    ])
    idx = n.clamp(max=buf.shape[0] - 1).long().reshape(1)
    buf.index_copy_(0, idx, row[None, :])
    n.add_(1)


def current_row(tap, n_goals: int) -> torch.Tensor:
    """The cost vector of the row written last (the plateau exit's read)."""
    buf, n = tap
    idx = (n - 1).clamp(0, buf.shape[0] - 1).long()
    return buf.index_select(0, idx.reshape(1))[0, :n_goals]


# ----- host side --------------------------------------------------------------


def decode(tap, goal_names, chunk_size: int | None = None, budget: int | None = None,
           ladder: dict | None = None) -> dict | None:
    """The JSON-ready convergence segment of a tap: one host read, after
    the drive. Counters are cumulative. ``ladder`` (the annealer passes it
    when ``n_temps > 1``) is attached as is; the per-chunk exchange series
    appears whenever a chunk attempted a pair."""
    if tap is None:
        return None
    buf = tap[0].cpu().numpy()
    n = int(tap[1])
    if n <= 0:
        return None
    G = len(goal_names)
    rows = min(n, buf.shape[0])
    out: dict = {
        "goals": list(goal_names),
        "chunks": n,
        "truncated": n > buf.shape[0],
        "series": [[round(float(x), 4) for x in buf[i, :G]] for i in range(rows)],
        "proposed": [[int(x) for x in buf[i, G:G + 3]] for i in range(rows)],
        "accepted": [[int(x) for x in buf[i, G + 3:G + 6]] for i in range(rows)],
        "temperature": [round(float(buf[i, G + 6]), 6) for i in range(rows)],
    }
    ex_att = [int(buf[i, G + 7]) for i in range(rows)]
    if any(ex_att):
        out["exchange"] = {
            "attempted": ex_att,
            "accepted": [int(buf[i, G + 8]) for i in range(rows)],
        }
    if ladder is not None:
        out["ladder"] = dict(ladder)
    if chunk_size:
        out["chunk"] = int(chunk_size)
    if budget is not None:
        out["budget"] = int(budget)
    return out
