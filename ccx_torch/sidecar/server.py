"""The optimizer sidecar of the port — gRPC service.

The JVM keeps LoadMonitor, Executor and REST; its analyzer hop
(``goal.optimizer.backend=tpu``) is gRPC to a sidecar: snapshot up,
proposals and per-goal stats down, progress streamed so the JVM can feed
its ``OperationProgress``. This module is that sidecar on the port: the
same three methods (``PutSnapshot``, ``Propose``, ``Ping``) on the
unchanged wire contract (``ccx_torch/sidecar/wire.py``, a copy of the JAX
package's), answered by ``ccx_torch.optimizer.optimize`` on the CUDA
device.

* ``SnapshotRegistry`` keeps each session's host arrays and, per cluster,
  the built device model, priced on the unified device-memory ledger
  (``ccx_torch.common.devmem``). Eviction drops only the device copy; a
  metric-only delta is grafted onto the resident model instead of
  rebuilding it.
* ``OptimizerSidecar`` implements the methods, transport-independent.
  ``propose`` runs ``optimize`` as a fleet job
  (``ccx_torch.search.scheduler``) in a worker thread and relays its phase
  starts and chunk heartbeats (through a ``TRACER`` listener) as progress
  frames; warm Proposes resolve their base from the placement store.
* ``make_grpc_server``/``main`` put the methods on gRPC with byte-identity
  serializers (no protoc codegen). ``grpc`` is imported inside them only.

The port serves on the device it was given (the CUDA device by default)
and has no fallback: a failing launch, graft or synchronize fails the RPC
with a structured error. The JAX package's ``/metrics`` gauges of its
compile counters and cost model are not exported here (those modules are
not ported).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import weakref
import zlib
from concurrent import futures

import numpy as np
import torch

from ccx_torch.common import devmem, faults
from ccx_torch.common.resources import NUM_RESOURCES
from ccx_torch.common.tracing import TRACER
from ccx_torch.device import resolve_device
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.snapshot import (
    ARRAY_FIELDS,
    arrays_to_model,
    decode_msgpack,
    delta_apply,
    pack_arrays,
)
from ccx_torch.model.tensor_model import TENSOR_FIELDS, TensorClusterModel
from ccx_torch.optimizer import OptimizeOptions, optimize
from ccx_torch.search import incremental as incr
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from ccx_torch.search.scheduler import FLEET, JobCancelled
from ccx_torch.sidecar import GRPC_MESSAGE_OPTIONS, SERVICE, wire
from ccx_torch.sidecar import identity as _identity

log = logging.getLogger(__name__)

#: the package version the Ping response reports
VERSION = "0.1.0"

#: streamed-result segment size: the columnar proposals blob is sliced into
#: chunks of this many bytes, each riding one ``resultSegment`` frame
RESULT_SEGMENT_BYTES = int(os.environ.get("CCX_RESULT_SEGMENT_BYTES", str(1 << 20)))


def model_device_bytes(m: TensorClusterModel) -> int:
    """Device footprint of a built model: the sum of its tensors' nbytes
    (padded shapes — what sits on the card)."""
    return sum(int(getattr(m, name).nbytes) for name in TENSOR_FIELDS)


class SnapshotRegistry:
    """Device-resident snapshot registry — fleet serving's N-cluster cache.

    The host arrays of every session snapshot are kept, and on top of them
    the BUILT device model (``arrays_to_model`` output) per session, so
    repeat Proposes skip the build and the host→device transfer. Device
    residency is priced in bytes on the unified device-memory ledger
    (priority-aware eviction: an urgent job's model is never displaced by
    a dryrun admission). Eviction only drops the DEVICE copy; the host
    arrays stay, so an evicted cluster's next Propose rebuilds. An explicit
    ``hbm_budget_bytes`` detaches the registry onto a private ledger with
    that budget.

    Thread-safe: one lock guards the maps; the build runs outside it, and
    so do ledger admissions (the ledger calls back into
    ``_devmem_evicted``, which takes the lock)."""

    #: delta fields that can be grafted onto a resident device model
    #: without a rebuild: the metric tensors (padded with zeros as
    #: build_model pads them). Anything else takes the rebuild path.
    METRIC_FIELDS = frozenset({"leader_load", "follower_load"})

    def __init__(self, hbm_budget_bytes: int | None = None,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        #: session -> (generation, host arrays)
        self._snapshots: dict[str, tuple[int, dict]] = {}
        #: session -> (generation, device model, device bytes, install stamp)
        self._models: dict[str, tuple[int, TensorClusterModel, int, int]] = {}
        self._seq = 0
        self._explicit_budget = hbm_budget_bytes
        self._devmem = (
            devmem.DEVMEM
            if hbm_budget_bytes is None or hbm_budget_bytes <= 0
            else devmem.DeviceMemoryManager(budget_bytes=int(hbm_budget_bytes))
        )
        self._ns = f"reg{id(self):x}"
        self._self_ref = weakref.ref(self)
        # a dropped registry must not leave phantom bytes on a shared
        # ledger: finalize releases this instance's namespace at GC
        weakref.finalize(self, self._devmem.release_namespace, self._ns)
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        #: metric-only delta puts grafted onto the resident device model
        self.delta_grafts = 0
        #: grafts that returned None (a delta wider than the model, or an
        #: injected ``registry.graft`` fault): the device copy was dropped
        #: and the next Propose rebuilds
        self.graft_failures = 0
        #: builds that hit a device allocation failure, evicted every
        #: resident and retried
        self.pressure_evictions = 0

    def budget_bytes(self) -> int:
        return self._devmem.budget_bytes()

    # ----- ledger hooks -------------------------------------------------------

    def _ledger_key(self, session: str) -> str:
        return f"{self._ns}:{session}"

    def _devmem_evicted(self, key: str, stamp: int) -> None:
        """Ledger eviction callback: drop only the DEVICE copy, and only
        the install it was admitted for (``stamp``): a callback that lost a
        race to a newer install leaves the new model alone."""
        session = key.split(":", 1)[1]
        with self._lock:
            cur = self._models.get(session)
            if cur is not None and cur[3] == stamp:
                del self._models[session]
                self.evictions += 1

    def _admit(self, session: str, nbytes: int, stamp: int,
               priority: int | None = None, job: str | None = None) -> None:
        """Price an installed device model on the ledger (outside the
        lock). ``job=None`` keeps an existing entry's label. The residency
        check after the admit closes the install/admit race: a packing
        eviction between the install and this admit would leave an entry
        pricing a model no longer resident."""
        ref = self._self_ref

        def _evict(key, _ref=ref, _stamp=stamp):
            reg = _ref()
            if reg is not None:
                reg._devmem_evicted(key, _stamp)

        self._devmem.admit(
            "snapshot", self._ledger_key(session), nbytes,
            priority=priority, job=job, evictor=_evict,
        )
        with self._lock:
            cur = self._models.get(session)
            resident = cur is not None and cur[3] == stamp
        if not resident:
            self._devmem.release("snapshot", self._ledger_key(session))

    # ----- sessions -----------------------------------------------------------

    def get(self, session: str):
        with self._lock:
            return self._snapshots.get(session)

    def put(self, session: str, generation: int, arrays: dict,
            changed: set | None = None) -> None:
        """Store a session's snapshot. ``changed`` (the delta's array
        fields, None for a full put) enables the steady-state fast path: a
        METRIC-ONLY delta grafts the new load tensors onto the resident
        device model instead of invalidating it."""
        with self._lock:
            self._snapshots[session] = (int(generation), arrays)
            cached = self._models.pop(session, None)
        graftable = (
            changed is not None and cached is not None
            and set(changed) <= self.METRIC_FIELDS
        )
        if cached is not None and not graftable:
            self._devmem.release("snapshot", self._ledger_key(session))
        if not graftable:
            return
        # the resident model was popped above, so a failed graft leaves no
        # device copy and the next Propose rebuilds: a torn graft is never
        # served
        grafted = self._graft_metrics(cached[1], arrays, changed)
        if grafted is None:
            self.graft_failures += 1
            self._devmem.release("snapshot", self._ledger_key(session))
            return
        with self._lock:
            cur = self._snapshots.get(session)
            if cur is None or cur[0] != int(generation):
                # a newer put landed while this one grafted: installing it
                # would pin a stale model under a fresh stamp
                stamp = None
            else:
                self._seq += 1
                stamp = self._seq
                self._models[session] = (int(generation), grafted, cached[2], stamp)
                self.delta_grafts += 1
        if stamp is not None:
            # same bytes; priority and job label kept
            self._admit(session, cached[2], stamp)
        else:
            self._devmem.release("snapshot", self._ledger_key(session))

    @staticmethod
    def _graft_metrics(model: TensorClusterModel, arrays: dict, changed: set):
        """The resident model with the changed load tensors replaced: each
        delta's dense rows go to the model's device in one copy and are
        padded there to the model's [RES, P] bucket. None in two defined
        cases — a delta wider than the model, or an injected
        ``registry.graft`` fault while faults are armed — and the caller
        rebuilds; any other error propagates."""
        if faults.FAULTS.armed:
            try:
                faults.FAULTS.hit("registry.graft")
            except faults.InjectedFault:
                return None
        Pp = model.leader_load.shape[1]
        reps = {}
        for k in changed:
            dense = np.asarray(arrays[k], np.float32).reshape(NUM_RESOURCES, -1)
            n = dense.shape[1]
            if n > Pp:
                return None
            if not dense.flags.writeable:
                # a zero-copy view of the wire payload: torch wants a
                # writable buffer to alias
                dense = dense.copy()
            dev = torch.from_numpy(dense).to(model.device)
            if n < Pp:
                dev = torch.nn.functional.pad(dev, (0, Pp - n))
            reps[k] = dev
        return model.replace(**reps)

    def model(self, session: str, priority: int | None = None,
              job: str | None = None) -> TensorClusterModel | None:
        """The device model for a session's CURRENT snapshot: a cache hit
        when resident, else built and admitted on the ledger. ``priority``
        (the serving job's fleet priority) and ``job`` (its cluster id)
        price and label the entry. A build that fails on a device
        allocation (``torch.cuda.OutOfMemoryError``, or the injected
        ``exhaust`` fault standing for it) evicts every resident and is
        retried once; any other error propagates. A build that raced a
        newer put is served but never installed."""
        with self._lock:
            entry = self._snapshots.get(session)
            if entry is None:
                return None
            gen = entry[0]
            cached = self._models.get(session)
            if cached is not None and cached[0] == gen:
                self.hits += 1
                hit = cached[1]
            else:
                arrays = entry[1]
                self.misses += 1
                hit = None
        if hit is not None:
            self._devmem.touch(
                "snapshot", self._ledger_key(session), priority=priority, job=job
            )
            return hit
        try:
            m = self._build(arrays)
        except (torch.cuda.OutOfMemoryError, faults.InjectedFault) as e:
            if not faults.is_resource_exhausted(e):
                raise
            self.pressure_evictions += 1
            self.evict_device(reason="pressure")
            m = self._build(arrays)
        nbytes = model_device_bytes(m)
        with self._lock:
            cur = self._snapshots.get(session)
            if cur is not None and cur[0] == gen:
                self._seq += 1
                stamp = self._seq
                self._models[session] = (gen, m, nbytes, stamp)
            else:
                stamp = None
        if stamp is not None:
            self._admit(session, nbytes, stamp, priority=priority, job=job or session)
        return m

    def _build(self, arrays: dict) -> TensorClusterModel:
        # chaos seam: the host→device build; ``exhaust`` rules exercise the
        # pressure-evict-retry path
        if faults.FAULTS.armed:
            faults.FAULTS.hit("snapshot.transfer")
        return arrays_to_model(arrays, device=self.device)

    def evict_device(self, session: str | None = None, reason: str = "explicit") -> int:
        """Drop device-resident models (the host arrays stay, so the next
        Propose rebuilds). ``session=None`` drops all of them. Returns the
        number evicted."""
        with self._lock:
            if session is not None:
                dropped = [session] if self._models.pop(session, None) is not None else []
            else:
                dropped = list(self._models)
                self._models.clear()
            self.evictions += len(dropped)
        for s in dropped:
            self._devmem.release("snapshot", self._ledger_key(s), reason=reason)
        return len(dropped)

    def stats(self) -> dict:
        with self._lock:
            device_bytes = sum(v[2] for v in self._models.values())
            return {
                "sessions": len(self._snapshots),
                "deviceResident": len(self._models),
                "deviceBytes": device_bytes,
                "budgetBytes": self.budget_bytes(),
                "unifiedLedger": self._explicit_budget is None or self._explicit_budget <= 0,
                "evictions": self.evictions,
                "hits": self.hits,
                "misses": self.misses,
                "deltaGrafts": self.delta_grafts,
                "graftFailures": self.graft_failures,
                "pressureEvictions": self.pressure_evictions,
            }


#: the wire options the port cannot honor beyond the JAX package's default:
#: it has one repair path, no repair/anneal overlap, and its polish moves
#: no swaps (the swap polish stage does)
_FIXED_OPTIONS = {"repair_backend": "device", "overlap_repair": False, "polish_swap_fraction": 0.0}


def options_from_wire(o: dict, warm: bool) -> OptimizeOptions:
    """The ``OptimizeOptions`` of a Propose's ``options`` map, key for key
    as the JAX package's sidecar maps them (``wire.PROPOSE_OPTION_KEYS``),
    with its defaults for absent keys. An unknown key, or a value of
    ``repair_backend``, ``overlap_repair`` or ``polish_swap_fraction``
    other than the one path the port runs, is an invalid argument: the RPC fails rather than run another
    configuration than the client asked for."""
    unknown = set(o) - wire.PROPOSE_OPTION_KEYS
    if unknown:
        raise ValueError(
            f"unknown options keys: {sorted(unknown)}; this end speaks the keys "
            "in ccx_torch.sidecar.wire.PROPOSE_OPTION_KEYS"
        )
    backend = str(o.get("repair_backend", "device"))
    if backend not in ("device", "host"):
        raise ValueError(f"repair_backend must be 'device' or 'host', got {backend!r}")
    for key, only in _FIXED_OPTIONS.items():
        if key in o and o[key] != only:
            raise ValueError(f"option {key}={o[key]!r} is not supported by this sidecar (only {only!r})")

    def opt_int(key):
        return int(o[key]) if o.get(key) is not None else None

    return OptimizeOptions(
        anneal=AnnealOptions(
            n_chains=int(o.get("chains", 32)),
            n_steps=int(o.get("steps", 3000)),
            moves_per_step=int(o.get("moves_per_step", 8)),
            seed=int(o.get("seed", 42)),
            chunk_steps=int(o.get("chunk_steps", 250)),
            p_swap=float(o.get("p_swap", 0.15)),
            p_swap_end=float(o.get("p_swap_end", -1.0)),
            swap_coupling=float(o.get("swap_coupling", 0.5)),
            n_temps=int(o.get("n_temps", 1)),
            exchange_interval=int(o.get("exchange_interval", 1)),
            bf16_scoring=bool(o.get("bf16_scoring", False)),
        ),
        polish=GreedyOptions(
            n_candidates=int(o.get("polish_candidates", 256)),
            max_iters=int(o.get("polish_max_iters", 400)),
            patience=int(o.get("polish_patience", 8)),
            batch_moves=int(o.get("polish_batch_moves", 16)),
            chunk_iters=int(o.get("polish_chunk_iters", 50)),
        ),
        check_evacuation=bool(o.get("check_evacuation", True)),
        max_repair_rounds=int(o.get("max_repair_rounds", 3)),
        require_hard_zero=bool(o.get("require_hard_zero", True)),
        run_polish=bool(o.get("run_polish", True)),
        run_leader_pass=bool(o.get("run_leader_pass", True)),
        run_cold_greedy=bool(o.get("run_cold_greedy", True)),
        topic_rebalance_rounds=int(o.get("topic_rebalance_rounds", 2)),
        topic_rebalance_max_sweeps=int(o.get("topic_rebalance_max_sweeps", 1024)),
        topic_rebalance_move_leaders=bool(o.get("topic_rebalance_move_leaders", True)),
        topic_rebalance_guarded=bool(o.get("topic_rebalance_guarded", True)),
        topic_rebalance_polish_iters=opt_int("topic_rebalance_polish_iters"),
        leader_pass_max_iters=opt_int("leader_pass_max_iters"),
        swap_polish_iters=int(o.get("swap_polish_iters", 0)),
        swap_polish_post_iters=int(o.get("swap_polish_post_iters", 0)),
        swap_polish_candidates=int(o.get("swap_polish_candidates", 128)),
        swap_polish_guarded=bool(o.get("swap_polish_guarded", True)),
        swap_polish_chunk_iters=int(o.get("swap_polish_chunk_iters", 50)),
        incremental=incr.IncrementalOptions(
            enabled=warm,
            warm_swap_iters=int(o.get("warm_swap_iters", 8)),
            warm_swap_patience=int(o.get("warm_swap_patience", 3)),
            warm_swap_candidates=int(o.get("warm_swap_candidates", 32)),
            warm_steps=int(o.get("warm_steps", 100)),
            warm_chunk_steps=int(o.get("warm_chunk_steps", 25)),
            warm_chains=int(o.get("warm_chains", 2)),
            warm_moves_per_step=int(o.get("warm_moves", 8)),
            plateau_window=int(o.get("plateau_window", 1)),
            warm_t0=float(o.get("warm_t0", 1e-8)),
            warm_leader_iters=int(o.get("warm_leader_iters", 0)),
        ),
        plan_enabled=bool(o.get("plan_enabled", False)),
        plan_cost_tier=bool(o.get("plan_cost_tier", False)),
        plan_max_waves=int(o.get("plan_max_waves", 64)),
        plan_broker_cap=int(o.get("plan_broker_cap", 5)),
        plan_wave_bytes_mb=float(o.get("plan_wave_bytes_mb", 0.0)),
        plan_throttle_mb_per_sec=float(o.get("plan_throttle_mbps", 0.0)),
    )


class OptimizerSidecar:
    """Method implementations (transport-independent, tested directly).
    ``device`` is where snapshots are built and optimized (None: the CUDA
    device)."""

    def __init__(self, goal_config: GoalConfig | None = None,
                 snapshot_hbm_budget_bytes: int | None = None,
                 device: str | torch.device | None = None) -> None:
        self.goal_config = goal_config or GoalConfig()
        self.registry = SnapshotRegistry(snapshot_hbm_budget_bytes, device)
        self.device = self.registry.device
        self._lock = threading.Lock()
        #: session -> (generation, ClusterModelStats): the input-side stats
        #: block of the session's current snapshot, immutable per
        #: generation, so a repeat Propose skips its aggregates launch
        self._input_stats: dict[str, tuple[int, object]] = {}
        #: Proposes whose input-side stats came from that memo
        self.stats_memo_hits = 0
        #: session -> (generation, crc32 of the last PutSnapshot payload):
        #: tells a duplicate delivery (same generation, same bytes: ACK)
        #: from a desynced writer reusing the generation (an error)
        self._put_crc: dict[str, tuple[int, int]] = {}

    # ----- PutSnapshot --------------------------------------------------------

    def put_snapshot(self, request: bytes) -> bytes:
        req = wire.unpackb(request)
        wire.check_version(req)
        session = req.get("session", "")
        generation = int(req.get("generation", 0))
        if "packed" not in req:
            raise wire.WireError(wire.ERR_MALFORMED, "PutSnapshot request missing 'packed'")
        arrays = _decode_snapshot(req["packed"], what="packed snapshot")
        crc = zlib.crc32(req["packed"]) & 0xFFFFFFFF
        with self._lock:
            if req.get("is_delta"):
                base = self.registry.get(session)
                if base is None:
                    raise ValueError(f"no base snapshot for session {session!r}")
                if generation == base[0]:
                    # the registry is already at this generation: the same
                    # bytes are a duplicate delivery (ACK, the client retry
                    # contract); other bytes are a desynced writer
                    if self._put_crc.get(session) == (generation, crc):
                        return wire.ack_response(generation)
                    raise ValueError(
                        f"delta for session {session!r} reuses current "
                        f"generation {generation} with different content "
                        "— writer desynced; re-send a full snapshot"
                    )
                base_gen = req.get("base_generation")
                if base_gen is not None and int(base_gen) != base[0]:
                    # a delta against the wrong base would build a cluster
                    # state that never existed
                    raise ValueError(
                        f"delta base generation {base_gen} does not match "
                        f"cached generation {base[0]} for session {session!r}"
                    )
                changed = set(arrays) & set(ARRAY_FIELDS)
                arrays = delta_apply(base[1], arrays)
                self.registry.put(session, generation, arrays, changed=changed)
            else:
                self.registry.put(session, generation, arrays)
            self._put_crc[session] = (generation, crc)
        return wire.ack_response(generation)

    # ----- Propose ------------------------------------------------------------

    def propose(self, request: bytes, cancel: threading.Event | None = None):
        """Generator: progress frames, then the result frame (and, for a
        streamed columnar result, the segment frames before it).

        ``cancel`` is the transport's disconnect signal: the optimize
        worker runs as a fleet job holding the event and unwinds with
        ``JobCancelled`` at its next chunk-boundary grant. A consumer that
        stops iterating this generator cancels the same way."""
        if cancel is None:
            cancel = threading.Event()
        req = wire.unpackb(request)
        wire.check_version(req)
        yield wire.progress_frame("Decoding snapshot")
        model = None
        session = None
        cur_gen = None
        warm_req = bool(req.get(wire.FIELD_WARM_START)) and incr.env_enabled()
        # the fleet job: the cluster id names it on the scheduler, and the
        # priority also prices every device resident this RPC touches
        cluster = str(req.get("cluster_id") or req.get("session") or "anon")
        priority = int(req.get("priority") or 0)
        if req.get("snapshot") is not None:
            arrays = _decode_snapshot(req["snapshot"], what="snapshot")
        else:
            session = req.get("session", "")
            # read, validate, apply and store under one lock, so concurrent
            # deltas for a session cannot drop updates
            with self._lock:
                entry = self.registry.get(session)
                if entry is None:
                    raise ValueError(f"no snapshot for session {session!r}")
                if req.get("delta") is not None:
                    base_gen = req.get("base_generation")
                    if base_gen is not None and int(base_gen) != entry[0]:
                        raise ValueError(
                            f"delta base generation {base_gen} does not "
                            f"match cached generation {entry[0]} for "
                            f"session {session!r}"
                        )
                    delta_arrays = _decode_snapshot(req["delta"], what="delta")
                    changed = set(delta_arrays) & set(ARRAY_FIELDS)
                    arrays = delta_apply(entry[1], delta_arrays)
                    cur_gen = int(req.get("generation", entry[0] + 1))
                    self.registry.put(session, cur_gen, arrays, changed=changed)
                else:
                    arrays = entry[1]
                    cur_gen = entry[0]
            model = self.registry.model(session, priority=priority, job=cluster)
        if model is None:
            model = arrays_to_model(arrays, device=self.device)

        goals = tuple(req.get("goals") or ()) or DEFAULT_GOAL_ORDER
        unknown = [g for g in goals if g not in GOAL_REGISTRY]
        if unknown:
            raise ValueError(f"unknown goals: {unknown}")
        if "StructuralFeasibility" not in goals:
            goals = ("StructuralFeasibility",) + tuple(goals)
        opts = options_from_wire(req.get("options") or {}, warm_req)
        # the warm base: (session, base_generation) in the placement store;
        # a missing or mismatched base cold-starts with the reason on the
        # result, never a failure
        warm = None
        cold_reason = None
        if warm_req:
            if session is None:
                cold_reason = "warm_start requires a session"
            else:
                want_gen = req.get("base_generation")
                warm = incr.STORE.get(session, want_gen, priority=priority, job=cluster)
                if warm is None:
                    have = incr.STORE.generation(session)
                    cold_reason = (
                        f"no warm placement for session {session!r} at "
                        f"base_generation {want_gen} (store has "
                        f"{have if have is not None else 'none'})"
                    )
        yield wire.progress_frame(f"Optimizing {model.P}x{model.B} over {len(goals)} goals")

        # optimize runs in a worker thread so its phase starts and chunk
        # heartbeats can stream through this generator
        q: queue.Queue = queue.Queue()
        box: dict = {}

        def _run():
            try:
                box["res"] = optimize(
                    model, self.goal_config, goals, opts, warm_start=warm,
                    progress_cb=lambda p: q.put(("phase", p)),
                    job=(cluster, priority), cancel=cancel,
                )
            except BaseException as e:  # re-raised below, at the RPC edge
                box["err"] = e
            finally:
                q.put(None)

        worker = threading.Thread(target=_run, daemon=True)
        worker.start()
        # chunk-heartbeat relay: this worker's chunk records become
        # structured progress frames, at most one per second
        last_beat = [0.0]

        def _tap(rec):
            if rec.get("ev") != "chunk" or rec.get("tid") != worker.ident:
                return
            now = time.monotonic()
            if now - last_beat[0] >= 1.0:
                last_beat[0] = now
                q.put(("beat", rec))

        TRACER.add_listener(_tap)
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                kind, payload = item
                if kind == "phase":
                    yield wire.progress_frame(payload)
                else:
                    yield wire.heartbeat_frame(
                        f"{payload.get('span', '?')} chunk {payload['chunk']}",
                        span=payload.get("span"),
                        chunk=payload["chunk"],
                        total=payload.get("total"),
                        job=payload.get("job", cluster),
                        energy=payload.get("energy"),
                    )
        except GeneratorExit:
            # the consumer stopped iterating (the stream closed): cancel the
            # worker at its next chunk boundary
            cancel.set()
            FLEET.kick()
            raise
        finally:
            TRACER.remove_listener(_tap)
        worker.join()
        if "err" in box:
            raise box["err"]
        res = box["res"]
        yield wire.progress_frame("Diff + verification done")
        # bank this run's placement as the session's next warm base
        bank_s = 0.0
        if session is not None and cur_gen is not None and incr.env_enabled() and res.verification.ok:
            t_bank = time.monotonic()
            try:
                incr.remember(
                    session, cur_gen, res.model, self.goal_config,
                    pressure=res.warm_pressure, priority=priority, job=cluster,
                )
            except faults.InjectedFault:
                # the injected ``placement.bank`` fault: the bank-last store
                # kept the previous base, so the next warm Propose resolves
                # it or cold-starts; this verified result still ships
                log.warning(
                    "warm-base banking failed for session %r gen %s — the "
                    "next warm Propose will cold-start", session, cur_gen, exc_info=True,
                )
            bank_s = time.monotonic() - t_bank
        columnar = bool(req.get("columnar_proposals"))
        stream = columnar and bool(req.get(wire.FIELD_STREAM_RESULT))
        # warm results omit the ClusterModelStats blocks (the minimal-diff
        # contract of a steady-state window)
        warm_applied = bool(res.incremental is not None and res.incremental.get("warmStart"))
        if session is not None and cur_gen is not None and not warm_applied:
            # the input-side stats are immutable per (session, generation)
            with self._lock:
                memo = self._input_stats.get(session)
            if memo is not None and memo[0] == cur_gen:
                res._stats_before = memo[1]
                self.stats_memo_hits += 1
        t_asm = time.monotonic()
        result = res.to_json(
            include_proposals=not columnar, include_stats=not warm_applied,
            include_goal_summary=not stream,
        )
        asm_s = time.monotonic() - t_asm
        if session is not None and cur_gen is not None and not warm_applied and res.stats_before is not None:
            with self._lock:
                self._input_stats[session] = (cur_gen, res.stats_before)
        if warm_req and cold_reason is not None and "incremental" not in result:
            result["incremental"] = {"warmStart": False, "coldStart": True, "reason": cold_reason}
        if not columnar:
            yield wire.result_frame(result)
            return
        # the optimizer's columnar diff is the result
        result["numProposals"] = res.diff.n
        t_pack = time.monotonic()
        blob = pack_arrays(res.diff.cols)
        pack_s = time.monotonic() - t_pack
        # a flipped byte inside a bin payload decodes cleanly: the crc is
        # the client's only detector
        result["proposalsColumnarCrc32"] = zlib.crc32(blob) & 0xFFFFFFFF
        if res.plan is not None and res.plan.n_waves > 0:
            plan_blob = pack_arrays(res.plan.wire_cols())
            result[wire.FIELD_PLAN_COLUMNAR] = plan_blob
            result[wire.FIELD_PLAN_COLUMNAR_CRC32] = zlib.crc32(plan_blob) & 0xFFFFFFFF
        result["wireSeconds"] = {
            "assembly": round(asm_s, 6), "pack": round(pack_s, 6), "bank": round(bank_s, 6),
        }
        if not stream:
            result["proposalsColumnar"] = blob
            yield wire.result_frame(result)
            return
        # streamed: the blob rides segment frames; the terminal frame has
        # the scalar blocks and the goal summary as flat typed arrays
        gs_blob = pack_arrays(res.goal_summary_columnar())
        result["goalSummaryColumnar"] = gs_blob
        result["goalSummaryColumnarCrc32"] = zlib.crc32(gs_blob) & 0xFFFFFFFF
        seg_bytes = max(int(RESULT_SEGMENT_BYTES), 1)
        total = max((len(blob) + seg_bytes - 1) // seg_bytes, 1)
        result["proposalsColumnarSegments"] = total
        result["proposalsColumnarBytes"] = len(blob)
        for i in range(total):
            yield wire.result_segment_frame(i, total, blob[i * seg_bytes: (i + 1) * seg_bytes])
        yield wire.result_frame(result)

    def ping(self, request: bytes) -> bytes:
        """Pong: the backend (``cuda``, or ``cpu`` for a sidecar built on
        the host), its device count and, on a card, the device's name."""
        if request:  # empty bytes: a pre-versioning client, accepted
            wire.check_version(wire.unpackb(request))
        if self.device.type == "cuda":
            return wire.pong_response(
                VERSION, "cuda", torch.cuda.device_count(),
                device=torch.cuda.get_device_name(self.device),
            )
        return wire.pong_response(VERSION, self.device.type, 1)


def _decode_snapshot(packed: bytes, what: str) -> dict:
    """Array-blob decode with the structured ``bad-snapshot`` error: an
    undecodable payload fails this request, not the server."""
    try:
        return decode_msgpack(packed)
    except Exception as e:  # noqa: BLE001 — anything here is a bad payload
        raise wire.WireError(wire.ERR_BAD_SNAPSHOT, f"undecodable {what}: {e}") from e


def make_grpc_server(sidecar: OptimizerSidecar | None = None,
                     address: str = "127.0.0.1:0",
                     max_workers: int | None = None):
    """Returns (grpc server, bound port). ``max_workers`` bounds concurrent
    RPC handlers (default ``CCX_SIDECAR_WORKERS``, else 16): the transport
    ceiling on in-flight Propose streams; the fleet scheduler is the policy
    layer under it."""
    import grpc

    if max_workers is None:
        max_workers = int(os.environ.get("CCX_SIDECAR_WORKERS", "16"))
    sidecar = sidecar or OptimizerSidecar()
    # seed the ledger's gauges so /metrics shows them from the first scrape
    devmem.DEVMEM.stats()

    def unary(fn, rpc_name):
        def handler(request: bytes, context):
            try:
                with TRACER.span(rpc_name, kind="rpc", bytes=len(request or b"")):
                    return fn(request)
            except Exception as e:  # noqa: BLE001 — RPC boundary
                log.exception("rpc failed")
                # "<code>: <message>": the server stays up, this RPC fails
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"{wire.code_of(e)}: {e}")
        return handler

    def propose_stream(request: bytes, context):
        # the callback fires when the RPC ends for any reason; on a client
        # disconnect it cancels the worker at its next chunk boundary
        cancel = threading.Event()

        def _on_rpc_done():
            cancel.set()
            FLEET.kick()

        context.add_callback(_on_rpc_done)
        try:
            with TRACER.span("Propose", kind="rpc", bytes=len(request or b"")):
                for update in sidecar.propose(request, cancel=cancel):
                    buf = wire.pack_frame(update)
                    if faults.FAULTS.armed:
                        # chaos seam: per-frame transport faults
                        buf = faults.FAULTS.hit("rpc.frame", buf)
                    yield buf
        except JobCancelled as e:
            log.info("propose cancelled: %s", e)
            yield wire.pack_frame(wire.error_frame(str(e), wire.ERR_CANCELLED))
        except faults.InjectedFault as e:
            if e.kind == "sever":
                # injected transport death: no terminal frame
                log.warning("injected stream sever: %s", e)
                return
            log.exception("propose failed (injected)")
            yield wire.pack_frame(wire.error_frame(str(e), wire.ERR_INTERNAL))
        except Exception as e:  # noqa: BLE001 — RPC boundary
            log.exception("propose failed")
            yield wire.pack_frame(wire.error_frame(str(e), wire.code_of(e)))

    method_handlers = {
        "Propose": grpc.unary_stream_rpc_method_handler(
            propose_stream, request_deserializer=_identity, response_serializer=_identity,
        ),
        "PutSnapshot": grpc.unary_unary_rpc_method_handler(
            unary(sidecar.put_snapshot, "PutSnapshot"),
            request_deserializer=_identity, response_serializer=_identity,
        ),
        "Ping": grpc.unary_unary_rpc_method_handler(
            unary(sidecar.ping, "Ping"), request_deserializer=_identity,
            response_serializer=_identity,
        ),
    }
    handler = grpc.method_handlers_generic_handler(SERVICE, method_handlers)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers), options=GRPC_MESSAGE_OPTIONS,
    )
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port(address)
    return server, port


def main(argv=None) -> int:
    import argparse

    from ccx_torch.search import scheduler as fleet

    ap = argparse.ArgumentParser(description="ccx_torch optimizer sidecar (CUDA)")
    ap.add_argument("--address", default="127.0.0.1:50051")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA device)")
    ap.add_argument("--workers", type=int, default=None,
                    help="gRPC handler threads (default CCX_SIDECAR_WORKERS or 16)")
    ap.add_argument("--fleet-max-concurrent", type=int, default=None,
                    help="device-residency cap of the fleet scheduler "
                         "(default CCX_FLEET_MAX_CONCURRENT or unlimited)")
    ap.add_argument("--snapshot-hbm-mb", type=float, default=None,
                    help="private device-memory budget of the snapshot registry "
                         "(detaches it from the unified ledger)")
    ap.add_argument("--devmem-budget-mb", type=float, default=None,
                    help="budget of the unified device-memory ledger (default "
                         "CCX_DEVMEM_BUDGET_MB, else derived from the device)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # CCX_FAULTS injects deterministic faults at the named seams; never
    # armed implicitly
    if faults.FAULTS.arm_from_env():
        log.warning("fault injection ARMED: %s", faults.FAULTS.stats())
    mc = args.fleet_max_concurrent
    if mc is None and os.environ.get("CCX_FLEET_MAX_CONCURRENT"):
        mc = int(os.environ["CCX_FLEET_MAX_CONCURRENT"])
    if mc is not None:
        fleet.configure(max_concurrent=mc)
    if args.devmem_budget_mb:
        devmem.configure(budget_mb=args.devmem_budget_mb)
    sidecar = OptimizerSidecar(
        snapshot_hbm_budget_bytes=int(args.snapshot_hbm_mb * 1e6) if args.snapshot_hbm_mb else None,
        device=args.device,
    )
    server, port = make_grpc_server(sidecar, address=args.address, max_workers=args.workers)
    server.start()
    log.info("optimizer sidecar listening on port %s (device %s)", port, sidecar.device)
    server.wait_for_termination()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
