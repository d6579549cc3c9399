"""Unified device-memory manager — one ledger for all device residency.

The port's copy of the JAX package's ``common/devmem.py``. The sidecar's
``SnapshotRegistry`` (built device models) and the warm pipeline's
``PlacementStore`` (converged placement bases and their pressure banks)
price what they keep on the card on this one ledger, under one budget:

* every device-resident object is an **entry**: a ``(class, key)`` pair
  with a byte size (the tensors' ``nbytes``), a priority, an LRU stamp and
  an eviction callback supplied by the owning cache. Classes: ``snapshot``
  (built device cluster models), ``warmBase`` (placement bases + pressure
  banks), ``program`` (the allocator's peak working set, pinned: the
  ledger only *accounts* it);
* admission is **priority-aware packing**: when the evictable classes
  exceed the budget, victims are chosen lowest priority first, LRU within
  a priority — and an admission may NEVER evict an entry of strictly
  higher priority, so an urgent job's warm base or snapshot cannot be
  displaced by a dryrun. An entry's priority is the priority of the LAST
  job that used it;
* eviction is **never an error** by construction: the owning caches
  registered callbacks that drop only the device copy — an evicted
  snapshot rebuilds from host arrays on its next Propose, an evicted warm
  base cold-starts (reason on the result, the RPC succeeds);
* when no permissible victim exists the admission still proceeds and is
  counted (``overBudgetAdmissions``) — one job must always be able to run.

The budget, with no override (constructor, :func:`configure`,
``CCX_DEVMEM_BUDGET_MB``, ``CCX_FLEET_HBM_MB``), is the cost model's one
derivation (``ccx_torch.common.costmodel.fleet_snapshot_budget_bytes``),
the JAX package's rule on the CUDA device: half of (device capacity − the
program watermark), floor 64 MB. Capacity is ``torch.cuda.mem_get_info``'s
total, the watermark ``torch.cuda.max_memory_reserved`` — the most the
caching allocator has held for the optimizer's own tensors. On a host
without a CUDA device the entries live in host memory, which the ledger
does not bound: the budget is then unlimited unless one is set.

Import-light on purpose (stdlib and ``costmodel``, itself stdlib-only at
load): the scheduler and the incremental store import this at their own
import time.
"""

from __future__ import annotations

import logging
import os
import threading

from ccx_torch.common import costmodel

#: entry classes whose bytes the ledger may reclaim. ``program`` is
#: accounted but pinned — the optimizer's working set belongs to the
#: caching allocator and is already subtracted from the derived budget.
EVICTABLE_CLASSES = frozenset({"snapshot", "warmBase"})

#: budget override in MB (0/unset = fall through to the derivation)
ENV_BUDGET_MB = "CCX_DEVMEM_BUDGET_MB"
#: the fleet snapshot budget override the derivation reads
ENV_FLEET_HBM_MB = costmodel.ENV_FLEET_HBM_MB
#: the derived budget's floor
MIN_BUDGET_BYTES = costmodel.MIN_BUDGET_BYTES


#: the budget with no override, and the working-set watermark it
#: subtracts: the cost model's one derivation
derived_budget_bytes = costmodel.fleet_snapshot_budget_bytes
program_watermark_bytes = costmodel.hbm_watermark_bytes


class Entry:
    """One device-resident object on the ledger."""

    __slots__ = ("klass", "key", "nbytes", "priority", "stamp", "pinned",
                 "job", "evictor")

    def __init__(self, klass: str, key: str, nbytes: int, priority: int,
                 stamp: int, pinned: bool, job: str | None, evictor) -> None:
        self.klass = klass
        self.key = key
        self.nbytes = int(nbytes)
        self.priority = int(priority)
        self.stamp = stamp
        self.pinned = pinned
        #: fleet job / session label — the scheduler's admission hook
        #: boosts a registering urgent job's entries by this label
        self.job = job
        #: callable(key) dropping the owner's device copy; owners hold
        #: only the device copy behind it, so calling it twice is safe
        self.evictor = evictor


class DeviceMemoryManager:
    """The ledger (module docstring). One process-wide instance
    (:data:`DEVMEM`) is shared by the snapshot registry, the placement
    store and the cost observatory's program accounting; tests and
    embedders may construct private instances with explicit budgets."""

    def __init__(self, budget_bytes: int | None = None,
                 metrics: bool = False) -> None:
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], Entry] = {}
        self._seq = 0
        self._explicit_budget = budget_bytes
        #: (reason, priority-of-victim) -> count. Reasons: ``budget``
        #: (packing eviction), ``pressure`` (RESOURCE_EXHAUSTED flush),
        #: ``explicit`` (owner dropped/invalidated the entry itself)
        self.evictions: dict[tuple[str, int], int] = {}
        self.over_budget_admissions = 0
        self.admissions = 0
        #: export labeled gauges on the process registry (the singleton
        #: arms this; private test instances stay silent)
        self._metrics = metrics

    # ----- budget -----------------------------------------------------------

    def budget_bytes(self) -> int:
        """The unified budget: explicit constructor/config/env override,
        else :func:`derived_budget_bytes`."""
        if self._explicit_budget is not None and self._explicit_budget > 0:
            return int(self._explicit_budget)
        mb = _BUDGET_MB_CONFIG
        if mb is None:
            env = os.environ.get(ENV_BUDGET_MB)
            mb = float(env) if env else None
        if mb is not None and mb > 0:
            return int(mb * 1e6)
        return derived_budget_bytes()

    # ----- admission --------------------------------------------------------

    def admit(self, klass: str, key: str, nbytes: int, *,
              priority: int | None = None, job: str | None = None,
              pinned: bool = False, evictor=None) -> None:
        """Register (or refresh) a device-resident entry and pack the
        evictable classes under the budget. ``priority=None`` resolves
        to the ambient fleet job's priority, else an existing entry's
        priority (a metric graft refreshing a resident model must not
        demote it), else 0. Evictor callbacks run OUTSIDE the ledger
        lock — owners take their own locks inside them."""
        if priority is None:
            priority = self._ambient_priority()
        with self._lock:
            self._seq += 1
            cur = self._entries.get((klass, key))
            if priority is None:
                priority = cur.priority if cur is not None else 0
            e = Entry(klass, key, nbytes, priority, self._seq, pinned,
                      job if job is not None
                      else (cur.job if cur is not None else None),
                      evictor if evictor is not None
                      else (cur.evictor if cur is not None else None))
            self._entries[(klass, key)] = e
            self.admissions += 1
            victims = self._pick_victims(admit_priority=e.priority,
                                         protect=(klass, key))
        self._evict(victims, reason="budget")
        self._export()

    def touch(self, klass: str, key: str, *,
              priority: int | None = None,
              job: str | None = None) -> None:
        """LRU-refresh an entry (cache hit); ``priority`` — the toucher's
        job priority — becomes the entry's new priority (the last user
        wins, in both directions), and ``job`` relabels the entry with
        the toucher's fleet-job id (so a later ``touch_job`` from the
        scheduler's admission hook matches). No gauge export: a touch
        changes neither bytes nor eviction counts, and this is the
        per-cache-hit hot path."""
        with self._lock:
            e = self._entries.get((klass, key))
            if e is None:
                return
            self._seq += 1
            e.stamp = self._seq
            if priority is not None:
                e.priority = int(priority)
            if job is not None:
                e.job = job

    def touch_job(self, job: str, priority: int) -> None:
        """Boost/demote every entry carrying ``job`` as its fleet-job
        label to ``priority`` — the scheduler's admission hook: the
        moment an urgent job registers, its warm base and snapshot are
        protected from lower-priority packing for the job's duration
        (and a later normal-priority registration demotes them back).
        No gauge export — priorities are not gauged."""
        with self._lock:
            for e in self._entries.values():
                if e.job == job:
                    e.priority = int(priority)

    def release(self, klass: str, key: str, *,
                reason: str = "explicit") -> bool:
        """Remove an entry (the owner dropped/invalidated its device
        copy itself — LRU-install races, pressure flushes, puts). Does
        NOT call the evictor: the owner already did the dropping."""
        with self._lock:
            e = self._entries.pop((klass, key), None)
            if e is not None:
                k = (reason, e.priority)
                self.evictions[k] = self.evictions.get(k, 0) + 1
        self._export()
        return e is not None

    def release_namespace(self, ns: str, *, reason: str = "explicit") -> int:
        """Drop every entry whose key lives under ``ns + ":"`` — the
        teardown hook a registry/store arms via ``weakref.finalize`` so a
        dropped instance's entries never linger as phantom bytes on the
        shared ledger (tests and embedders construct and drop many)."""
        prefix = ns + ":"
        with self._lock:
            keys = [k for k in self._entries if k[1].startswith(prefix)]
            n = 0
            for k in keys:
                e = self._entries.pop(k)
                rk = (reason, e.priority)
                self.evictions[rk] = self.evictions.get(rk, 0) + 1
                n += 1
        self._export()
        return n

    # ----- eviction ---------------------------------------------------------

    def _pick_victims(self, admit_priority: int,
                      protect: tuple[str, str]) -> list[Entry]:
        """(lock held) Victims to bring the evictable classes under
        budget: lowest priority first, LRU within a priority; entries of
        STRICTLY higher priority than the admitter are untouchable (the
        urgent-vs-dryrun invariant), as are pinned entries and the
        just-admitted one. May come up short — the caller counts the
        over-budget admission and serves anyway."""
        budget = self.budget_bytes()
        total = sum(
            e.nbytes for e in self._entries.values()
            if e.klass in EVICTABLE_CLASSES
        )
        if total <= budget:
            return []
        candidates = sorted(
            (
                e for (kl, ky), e in self._entries.items()
                if kl in EVICTABLE_CLASSES and not e.pinned
                and (kl, ky) != protect and e.priority <= admit_priority
            ),
            key=lambda e: (e.priority, e.stamp),
        )
        victims: list[Entry] = []
        for e in candidates:
            if total <= budget:
                break
            del self._entries[(e.klass, e.key)]
            total -= e.nbytes
            k = ("budget", e.priority)
            self.evictions[k] = self.evictions.get(k, 0) + 1
            victims.append(e)
        if total > budget:
            self.over_budget_admissions += 1
        return victims

    def _evict(self, victims: list[Entry], reason: str) -> None:
        """Run the victims' owner callbacks outside the ledger lock (the
        owners take their own locks; a failing callback never wedges the
        ledger — the device copy it guards is already unaccounted)."""
        for e in victims:
            if e.evictor is None:
                continue
            try:
                e.evictor(e.key)
            except Exception:  # noqa: BLE001 — the entry is gone from the
                # ledger either way; the owner's callback only drops Python
                # references, so its failure is logged and packing goes on
                logging.getLogger(__name__).exception(
                    "device-memory evictor for %s/%s failed", e.klass, e.key
                )

    # ----- program residency ------------------------------------------------

    def note_program_watermark(self) -> None:
        """Refresh the pinned ``program`` entry from the allocator's
        watermark (:func:`program_watermark_bytes`) — the working set,
        priced exactly once (the derived budget already subtracts the
        same number)."""
        wm = program_watermark_bytes()
        if wm <= 0:
            return
        with self._lock:
            self._seq += 1
            self._entries[("program", "working-set")] = Entry(
                "program", "working-set", wm, 0, self._seq,
                pinned=True, job=None, evictor=None,
            )
        # no export here: the only caller is stats(), which exports once
        # at its end

    # ----- ambient priority -------------------------------------------------

    @staticmethod
    def _ambient_priority() -> int | None:
        """The calling thread's fleet-job priority (None = no ambient
        job — the caller's explicit/existing priority applies)."""
        from ccx_torch.search.scheduler import FLEET

        h = FLEET.current()
        return None if h is None else int(h.priority)

    # ----- observability ----------------------------------------------------

    def stats(self) -> dict:
        """The ledger block: resident bytes and
        entry counts per class, eviction counts by reason and priority,
        the budget and whether the evictable classes respect it."""
        self.note_program_watermark()
        with self._lock:
            by_class_bytes: dict[str, int] = {}
            by_class_count: dict[str, int] = {}
            for e in self._entries.values():
                by_class_bytes[e.klass] = (
                    by_class_bytes.get(e.klass, 0) + e.nbytes
                )
                by_class_count[e.klass] = by_class_count.get(e.klass, 0) + 1
            evictable = sum(
                v for k, v in by_class_bytes.items()
                if k in EVICTABLE_CLASSES
            )
            evs = {
                f"{reason}/p{prio}": n
                for (reason, prio), n in sorted(self.evictions.items())
            }
            budget = self.budget_bytes()
            out = {
                "budgetBytes": budget,
                "residentBytes": by_class_bytes,
                "residentCount": by_class_count,
                "evictableBytes": evictable,
                "withinBudget": evictable <= budget,
                "evictions": evs,
                "evictionsTotal": sum(self.evictions.values()),
                "admissions": self.admissions,
                "overBudgetAdmissions": self.over_budget_admissions,
            }
        self._export()  # every stats read re-seeds the gauges (/metrics)
        return out

    def _export(self) -> None:
        """Push the labeled Prometheus gauges (singleton only): one
        ``devmem-resident-bytes`` series per class, one
        ``devmem-evictions`` series per (reason, priority), plus the
        scalar budget — all settable gauges, so the exposition stays one
        ``# TYPE`` per family (strict-parser-safe)."""
        if not self._metrics:
            return
        from ccx_torch.common.metrics import REGISTRY

        with self._lock:
            by_class: dict[str, int] = {}
            for e in self._entries.values():
                by_class[e.klass] = by_class.get(e.klass, 0) + e.nbytes
            evs = dict(self.evictions)
        for klass in ("snapshot", "warmBase", "program"):
            REGISTRY.set_gauge(
                "devmem-resident-bytes", by_class.get(klass, 0),
                labels={"class": klass},
                help="device-resident bytes per ledger class "
                     "(ccx_torch.common.devmem)",
            )
        REGISTRY.set_gauge(
            "devmem-budget-bytes", self.budget_bytes(),
            help="unified device-memory budget (ccx_torch.common.devmem)",
        )
        for (reason, prio), n in evs.items():
            REGISTRY.set_gauge(
                "devmem-evictions", n,
                labels={"reason": reason, "priority": str(prio)},
                help="ledger evictions by reason and victim priority "
                     "(ccx_torch.common.devmem)",
            )

    # ----- test/bench helpers -----------------------------------------------

    def entry(self, klass: str, key: str) -> Entry | None:
        with self._lock:
            return self._entries.get((klass, key))


#: programmatic override (``configure``)
_BUDGET_MB_CONFIG: float | None = None


def configure(budget_mb: float | None = None) -> None:
    """Set the process-wide budget in MB; 0/None restores the env/derived
    budget."""
    global _BUDGET_MB_CONFIG
    _BUDGET_MB_CONFIG = float(budget_mb) if budget_mb else None


#: the process-wide ledger (the sidecar registry and the placement store
#: share it — like FLEET / TRACER / REGISTRY)
DEVMEM = DeviceMemoryManager(metrics=True)
