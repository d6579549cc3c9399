"""Deterministic fault injection — the chaos layer.

A copy of the JAX package's ``faults`` module (standard library only), with
one change: :func:`is_resource_exhausted` recognises an organic device
allocation failure as ``torch.cuda.OutOfMemoryError``. The serving path's
failure surface (the sidecar registry, the warm store, the fleet scheduler,
the gRPC edge) threads through the named seams below: a **seeded,
schedule-driven** fault injector, armed explicitly (``CCX_FAULTS`` env or
:meth:`FaultRegistry.arm`) and a no-op otherwise.

Design rules (the ``CCX_CONVERGENCE=0`` contract, applied to chaos):

* **Disarmed is free and bit-exact.** Every call site guards with
  ``if FAULTS.armed:`` — one attribute read, no function call, no import
  side effects. Disarmed, the serving path executes exactly as a tree
  without this module.
* **Deterministic.** A schedule names WHICH hit of a seam fires (the Nth,
  every Mth from N, or every hit); the corrupt action derives its bytes
  from a seeded RNG keyed by (seed, seam, hit index). Same spec + seed ⇒
  the same faults in the same places, so a chaos failure reproduces.
* **Faults are data, not control flow.** A seam raises
  :class:`InjectedFault` (optionally flavored: ``resource-exhausted`` to
  exercise device-memory-pressure degradation, ``sever`` to kill a stream without
  an error frame), sleeps, or corrupts a payload — the REAL recovery code
  downstream handles it exactly as it would handle the organic fault.

Seams (the serving stack's failure surface):

=====================  ======================================================
``snapshot.transfer``  host→device model build/transfer
                       (``SnapshotRegistry.model``)
``registry.graft``     metric-delta graft onto the resident device model
                       (``SnapshotRegistry.put``)
``placement.bank``     warm-base banking into the ``PlacementStore``
                       (``incremental.remember``)
``device.diff``        the columnar diff (``proposals.columnar_diff``);
                       the Propose fails with a retryable internal error
                       (the JAX package degrades to a numpy diff instead)
``rpc.frame``          every Propose stream frame at the gRPC edge
                       (``server.propose_stream``)
``scheduler.grant``    chunk-dispatch grant acquisition
                       (``ChunkScheduler.chunk``)
``compile``            cold-pipeline entry (``optimizer._optimize``) — the
                       stand-in for a failed device build or launch
=====================  ======================================================

Spec grammar (``;``-separated rules)::

    <seam>:<action>@<schedule>[:<param>=<value>,...]

    action    raise | exhaust | sever | delay | corrupt
    schedule  N        fire on the Nth hit only (1-based)
              N+       fire on every hit from the Nth on
              N/M      fire on hit N, N+M, N+2M, ...
              *        fire on every hit
    params    delay=<seconds>   (delay action; default 0.05)

Examples::

    CCX_FAULTS="registry.graft:raise@2"
    CCX_FAULTS="rpc.frame:sever@3;snapshot.transfer:exhaust@1"
    CCX_FAULTS="rpc.frame:corrupt@2/5;scheduler.grant:raise@1"

Dependency-light on purpose: stdlib only at import (``torch`` only inside
:func:`is_resource_exhausted`) — the seams live in modules that must import
instantly (wire client, scheduler).
"""

from __future__ import annotations

import os
import random
import threading
import time

#: env arming (the standalone sidecar reads it at startup)
ENV_FAULTS = "CCX_FAULTS"
ENV_FAULTS_SEED = "CCX_FAULTS_SEED"

#: the named seams — ``arm()`` rejects a rule naming anything else, so a
#: typo'd chaos spec fails loudly instead of silently injecting nothing
SEAMS = frozenset({
    "snapshot.transfer",
    "registry.graft",
    "placement.bank",
    "device.diff",
    "rpc.frame",
    "scheduler.grant",
    "compile",
})

ACTIONS = frozenset({"raise", "exhaust", "sever", "delay", "corrupt"})


class InjectedFault(RuntimeError):
    """A fault fired by the registry. ``seam``/``action``/``hit`` name the
    rule; ``kind`` flavors the raise so recovery code can branch the same
    way it branches on the organic error:

    * ``"resource-exhausted"`` — stands in for a CUDA out-of-memory
      allocation failure; the snapshot registry degrades by evicting
      device residents and retrying cold.
    * ``"sever"`` — the transport died mid-stream; the gRPC edge ends the
      stream abruptly (no error frame), the client sees a truncated
      stream and restarts it.
    * ``"injected"`` — a generic failure of the seam's operation.
    """

    def __init__(self, seam: str, action: str, hit: int,
                 kind: str = "injected") -> None:
        super().__init__(
            f"injected fault: {seam} {action} (hit {hit})"
        )
        self.seam = seam
        self.action = action
        self.hit = hit
        self.kind = kind


class FaultRule:
    """One parsed spec rule (see module docstring for the grammar)."""

    __slots__ = ("seam", "action", "start", "every", "once", "delay_s")

    def __init__(self, seam: str, action: str, start: int, every: int,
                 once: bool, delay_s: float) -> None:
        self.seam = seam
        self.action = action
        self.start = start      # first firing hit (1-based)
        self.every = every      # period (0 with once=True: single shot)
        self.once = once
        self.delay_s = delay_s

    def fires(self, hit: int) -> bool:
        if hit < self.start:
            return False
        if self.once:
            return hit == self.start
        if self.every <= 1:
            return True
        return (hit - self.start) % self.every == 0

    def describe(self) -> str:
        if self.once:
            sched = f"@{self.start}"
        elif self.every <= 1:
            sched = f"@{self.start}+" if self.start > 1 else "@*"
        else:
            sched = f"@{self.start}/{self.every}"
        return f"{self.seam}:{self.action}{sched}"


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse a spec string into rules; raises ``ValueError`` on unknown
    seams/actions or malformed schedules (a chaos run must never silently
    inject nothing)."""
    rules: list[FaultRule] = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"malformed fault rule {part!r} "
                             "(want seam:action@schedule)")
        seam = fields[0].strip()
        if seam not in SEAMS:
            raise ValueError(
                f"unknown fault seam {seam!r}; known: {sorted(SEAMS)}"
            )
        act_sched = fields[1].strip()
        if "@" in act_sched:
            action, sched = act_sched.split("@", 1)
        else:
            action, sched = act_sched, "1"
        action = action.strip()
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; known: {sorted(ACTIONS)}"
            )
        start, every, once = 1, 0, True
        sched = sched.strip()
        if sched == "*":
            start, every, once = 1, 1, False
        elif sched.endswith("+"):
            start, every, once = int(sched[:-1]), 1, False
        elif "/" in sched:
            a, m = sched.split("/", 1)
            start, every, once = int(a), max(int(m), 1), False
        else:
            start = int(sched)
        if start < 1:
            raise ValueError(f"fault schedule must be 1-based: {part!r}")
        delay_s = 0.05
        for extra in fields[2:]:
            for kv in extra.split(","):
                if not kv.strip():
                    continue
                k, _, v = kv.partition("=")
                if k.strip() == "delay":
                    delay_s = float(v)
                else:
                    raise ValueError(f"unknown fault param {k!r} in {part!r}")
        rules.append(FaultRule(seam, action, start, every, once, delay_s))
    return rules


class FaultRegistry:
    """The process-wide injector (:data:`FAULTS`). ``armed`` is a plain
    bool attribute — the one thing a disarmed hot path ever reads."""

    def __init__(self) -> None:
        self.armed = False
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = []
        self._seed = 0
        #: per-seam hit counters (every pass through an armed seam)
        self._hits: dict[str, int] = {}
        #: per-(seam, action) fired counters
        self._fired: dict[str, int] = {}

    # ----- arming -----------------------------------------------------------

    def arm(self, spec, seed: int = 0) -> None:
        """Arm with a spec string (or pre-parsed rule list). Resets the
        hit counters — a schedule always counts from the arming point."""
        rules = parse_spec(spec) if isinstance(spec, str) else list(spec)
        with self._lock:
            self._rules = rules
            self._seed = int(seed)
            self._hits = {}
            self._fired = {}
            self.armed = True

    def disarm(self) -> None:
        with self._lock:
            self.armed = False
            self._rules = []
            self._hits = {}

    def arm_from_env(self) -> bool:
        """Arm from ``CCX_FAULTS`` when set (bench/standalone-sidecar
        entry points call this; embedded services use the config key).
        Returns True when armed."""
        spec = os.environ.get(ENV_FAULTS, "")
        if not spec:
            return False
        self.arm(spec, seed=int(os.environ.get(ENV_FAULTS_SEED, "0")))
        return True

    # ----- the seam hit -----------------------------------------------------

    def hit(self, seam: str, payload: bytes | None = None):
        """One pass through an armed seam. Fires the first matching rule
        for this hit index: ``raise``/``exhaust``/``sever`` raise an
        :class:`InjectedFault` (flavored), ``delay`` sleeps, ``corrupt``
        returns a deterministically corrupted copy of ``payload`` (or
        raises when there is no payload to corrupt — a corrupt rule on a
        payload-less seam is a plain failure). Returns ``payload``
        (possibly corrupted) so call sites can write
        ``buf = FAULTS.hit("rpc.frame", buf)``."""
        with self._lock:
            if not self.armed:
                return payload
            n = self._hits.get(seam, 0) + 1
            self._hits[seam] = n
            rule = None
            for r in self._rules:
                if r.seam == seam and r.fires(n):
                    rule = r
                    break
            if rule is not None:
                key = f"{rule.seam}:{rule.action}"
                self._fired[key] = self._fired.get(key, 0) + 1
                seed = self._seed
        if rule is None:
            return payload
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return payload
        if rule.action == "corrupt":
            if payload is None:
                raise InjectedFault(seam, "corrupt", n)
            return _corrupt(bytes(payload), seed, seam, n)
        kind = {
            "exhaust": "resource-exhausted",
            "sever": "sever",
        }.get(rule.action, "injected")
        raise InjectedFault(seam, rule.action, n, kind=kind)

    # ----- accounting -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": self.armed,
                "rules": [r.describe() for r in self._rules],
                "seed": self._seed,
                "hits": dict(self._hits),
                "fired": dict(self._fired),
            }

    def fired_total(self) -> int:
        with self._lock:
            return sum(self._fired.values())

    def hits_total(self) -> int:
        with self._lock:
            return sum(self._hits.values())


def _corrupt(buf: bytes, seed: int, seam: str, hit: int) -> bytes:
    """Deterministically flip a handful of bytes: same (seed, seam, hit)
    ⇒ same corruption. Empty payloads gain one garbage byte so the
    corruption is never a silent no-op."""
    if not buf:
        return b"\xff"
    import zlib

    # process-stable derivation (tuple/str seeding hashes with the
    # per-process salt — NOT reproducible across runs)
    rng = random.Random(
        (int(seed) * 1_000_003 + int(hit)) ^ zlib.crc32(seam.encode())
    )
    out = bytearray(buf)
    for _ in range(max(1, min(4, len(out) // 64))):
        i = rng.randrange(len(out))
        out[i] ^= 1 + rng.randrange(255)
    return bytes(out)


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for a device allocation failure — injected
    (:class:`InjectedFault` flavored ``resource-exhausted``) or organic
    (``torch.cuda.OutOfMemoryError``). The snapshot registry branches on
    this to evict-and-retry-cold instead of failing the RPC; every other
    error propagates."""
    if isinstance(exc, InjectedFault):
        return exc.kind == "resource-exhausted"
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError)


#: the process-wide registry (one per process, like scheduler.FLEET and
#: the tracer); armed from CCX_FAULTS by the sidecar entry point or
#: programmatically, never implicitly
FAULTS = FaultRegistry()
