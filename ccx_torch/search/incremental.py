"""Incremental re-optimization: the warm-start drift loop.

A rebalancer that runs all the time sees the same cluster drift a little
between metrics windows. This module keeps each session's last converged
placement on the device and, on a new snapshot,

1. **re-scores only the touched bands**: the previous run banked its
   per-broker band-pressure tables (``state.broker_pressure``, six [B]
   rows); the new metrics give new ones, and only brokers whose pressure
   moved beyond a tolerance are touched;
2. **warm-starts the search from the previous solution**: the previous
   placement is grafted onto the new metric tensors (``warm_model``) and a
   short descent (the usage-coupled swap polish) runs from it. When the
   drift window holds structural damage (a dead broker or disk, a rack
   break, a capacity overflow) the placement is repaired first and a short
   warm SA over the targeted hot list runs to its plateau;
3. **ships a minimal diff** against the snapshot.

The fused init (``warm_init``) launches the aggregates kernel once and
shares the result between the stack evaluation of the warm base, the
pressure stack, the touched mask and the descent's starting state;
``warm_finish`` launches it once more over the final placement for the
result stack and the next window's pressure bank.

The subsystem is off unless ``IncrementalOptions.enabled``; the environment
``CCX_INCREMENTAL=0`` disables it outright. The store below is
process-wide: ``remember`` banks into it and callers read it back with
``STORE.get``. Its bases are byte-priced on the unified device-memory
ledger (``ccx_torch.common.devmem.DEVMEM``), beside the sidecar's resident
models.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import weakref

import torch

from ccx_torch.common import costmodel
from ccx_torch.common.devmem import DEVMEM
from ccx_torch.common.faults import FAULTS
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import StackResult, evaluate_stack
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.search.state import (
    broker_pressure,
    init_search_state,
    make_topic_group,
    max_partitions_per_topic,
    stack_needs_topic,
)

#: environment off switch
ENV_INCREMENTAL = "CCX_INCREMENTAL"

#: relative band-pressure change that marks a broker touched by drift
#: (either direction, on any of the six pressure tables)
PRESSURE_RTOL = 0.02
PRESSURE_ATOL = 1e-3


def env_enabled() -> bool:
    """False when ``CCX_INCREMENTAL=0``."""
    return os.environ.get(ENV_INCREMENTAL, "1") != "0"


@dataclasses.dataclass(frozen=True)
class IncrementalOptions:
    """Warm-path knobs."""

    #: master gate; ``CCX_INCREMENTAL=0`` overrides True
    enabled: bool = False
    #: usage-coupled swap-polish iterations of the warm run (the primary
    #: warm engine: a pure lex descent over pressure-ranked replica swaps
    #: and leadership transfers)
    warm_swap_iters: int = 8
    #: consecutive no-improvement iterations before the warm swap polish
    #: stops
    warm_swap_patience: int = 3
    #: candidates per warm swap-polish iteration, split evenly between
    #: replica-swap pairs and leadership transfers
    warm_swap_candidates: int = 32
    #: SA step budget of the structural path (an upper bound: the plateau
    #: exit usually stops earlier)
    warm_steps: int = 100
    #: steps per warm SA chunk: the plateau decision's granularity
    warm_chunk_steps: int = 25
    #: chains of the warm SA
    warm_chains: int = 2
    #: proposals per chain per warm SA step
    warm_moves_per_step: int = 8
    #: chunks without lex improvement before the warm SA stops
    plateau_window: int = 1
    #: warm SA initial temperature: a descent with a whisper of Metropolis
    warm_t0: float = 1e-8
    #: leadership-only greedy iterations after the warm engines (0: none)
    warm_leader_iters: int = 0
    #: count backstop of the process-wide placement store (``configure``):
    #: warm bases are priced in bytes on the device-memory ledger first
    max_sessions: int = 32
    #: leadership-only profile: the warm base is usable only when its
    #: replica placement equals the snapshot's
    leadership_only: bool = False

    @property
    def armed(self) -> bool:
        return self.enabled and env_enabled()


@dataclasses.dataclass
class WarmStart:
    """One session's last converged placement: the placement tensors, taken
    by reference from the result model, and the banked pressure stack (the
    drift delta cache)."""

    session: str
    generation: int
    assignment: torch.Tensor
    leader_slot: torch.Tensor
    replica_disk: torch.Tensor
    #: float32[6, B] on the device: the six ``broker_pressure`` tables of
    #: the placement under the metrics it was optimized for
    pressure: torch.Tensor | None = None
    #: monotonic stamp for LRU eviction
    stamp: float = 0.0
    #: install token: the ledger's eviction callback drops the base only
    #: while the token it was admitted for is still the stored one
    token: int = 0

    def shape_key(self) -> tuple:
        return (tuple(self.assignment.shape), tuple(self.leader_slot.shape))


def warm_device_bytes(warm: WarmStart) -> int:
    """Device bytes of one warm base: the placement tensors and the banked
    pressure stack."""
    return sum(
        int(t.nbytes) for t in (warm.assignment, warm.leader_slot, warm.replica_disk, warm.pressure)
        if t is not None
    )


class PlacementStore:
    """Process-wide placement registry, keyed by session.

    ``put`` keeps placements by reference (no copy); ``get(session,
    base_generation)`` returns the stored placement only when the
    generation matches (None asks for the latest). Residency is priced in
    bytes on the device-memory ledger ``ledger`` (``STORE`` shares the
    process-wide ``DEVMEM``; priority-aware eviction: an urgent job's base
    is never displaced by a dryrun admission), with ``max_sessions`` kept
    as a count backstop; ``ledger=None`` leaves the count LRU alone. An
    evicted session cold-starts on its next window (``ColdStartRequired``
    with the reason on the result; eviction is never an error)."""

    def __init__(self, max_sessions: int = 32, ledger=None) -> None:
        self._lock = threading.Lock()
        self._by_session: dict[str, WarmStart] = {}
        self.max_sessions = int(max_sessions)
        self._seq = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._ledger = ledger
        self._ns = f"store{id(self):x}"
        self._self_ref = weakref.ref(self)
        if ledger is not None:
            # a dropped store must not leave phantom bytes on a shared
            # ledger: finalize releases this instance's namespace at GC
            weakref.finalize(self, ledger.release_namespace, self._ns)

    def _ledger_key(self, session: str) -> str:
        return f"{self._ns}:{session}"

    def _ledger_evicted(self, key: str, token: int) -> None:
        """Ledger eviction callback: drop only this store's entry. A
        callback that lost a race to a newer bank of the session (another
        token) leaves the newer base alone."""
        session = key.split(":", 1)[1]
        with self._lock:
            cur = self._by_session.get(session)
            if cur is not None and cur.token == token:
                del self._by_session[session]
                self.evictions += 1

    def put(self, warm: WarmStart, priority: int | None = None,
            job: str | None = None) -> None:
        """Store a base and price it on the ledger under ``priority`` (None:
        the ambient fleet job's) and the fleet-job label ``job`` (default:
        the session)."""
        count_victims: list[str] = []
        with self._lock:
            warm.stamp = time.monotonic()
            self._seq += 1
            warm.token = self._seq
            self._by_session[warm.session] = warm
            while len(self._by_session) > max(self.max_sessions, 1):
                victim = min(self._by_session, key=lambda s: self._by_session[s].stamp)
                del self._by_session[victim]
                self.evictions += 1
                count_victims.append(victim)
        if self._ledger is None:
            return
        for victim in count_victims:
            self._ledger.release("warmBase", self._ledger_key(victim))
        ref = self._self_ref
        token = warm.token

        def _evict(key, _ref=ref, _token=token):
            store = _ref()
            if store is not None:
                store._ledger_evicted(key, _token)

        self._ledger.admit(
            "warmBase", self._ledger_key(warm.session), warm_device_bytes(warm),
            priority=priority, job=job or warm.session, evictor=_evict,
        )
        # a packing eviction between the store write and the admit popped
        # the base: its re-added entry would price bytes no longer resident
        with self._lock:
            cur = self._by_session.get(warm.session)
            resident = cur is not None and cur.token == token
        if not resident:
            self._ledger.release("warmBase", self._ledger_key(warm.session))

    def get(self, session: str, base_generation: int | None = None,
            priority: int | None = None, job: str | None = None) -> WarmStart | None:
        """The session's base at ``base_generation`` (None: the latest).
        A hit refreshes the ledger entry: the reader's priority becomes the
        entry's (the last user wins) and ``job`` relabels it."""
        with self._lock:
            warm = self._by_session.get(session)
            if warm is None or (
                base_generation is not None and int(base_generation) != warm.generation
            ):
                self.misses += 1
                return None
            warm.stamp = time.monotonic()
            self.hits += 1
        if self._ledger is not None:
            self._ledger.touch("warmBase", self._ledger_key(session), priority=priority, job=job)
        return warm

    def generation(self, session: str) -> int | None:
        with self._lock:
            warm = self._by_session.get(session)
            return None if warm is None else warm.generation

    def drop(self, session: str) -> None:
        with self._lock:
            had = self._by_session.pop(session, None) is not None
        if had and self._ledger is not None:
            self._ledger.release("warmBase", self._ledger_key(session))

    def clear(self) -> None:
        with self._lock:
            sessions = list(self._by_session)
            self._by_session.clear()
        if self._ledger is not None:
            for session in sessions:
                self._ledger.release("warmBase", self._ledger_key(session))

    def device_bytes(self) -> int:
        with self._lock:
            return sum(warm_device_bytes(w) for w in self._by_session.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._by_session),
                "maxSessions": self.max_sessions,
                "deviceBytes": sum(warm_device_bytes(w) for w in self._by_session.values()),
                "ledger": self._ledger is not None,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


#: the process-wide store, priced on the unified device-memory ledger
STORE = PlacementStore(ledger=DEVMEM)


def configure(max_sessions: int | None = None) -> None:
    """Set the process-wide store's session cap (a positive count; None or
    0 keeps the current one)."""
    if max_sessions is not None and max_sessions > 0:
        STORE.max_sessions = int(max_sessions)


# ----- warm-base construction --------------------------------------------------


def remember(
    session: str, generation: int, model: TensorClusterModel, cfg: GoalConfig | None = None,
    pressure: torch.Tensor | None = None, priority: int | None = None, job: str | None = None,
) -> WarmStart:
    """Bank a converged result as the session's warm base: the placement
    tensors by reference, and the pressure stack (``pressure``, e.g. a warm
    result's ``warm_pressure``, or one aggregates launch here). The store
    write is the last step (after the ``placement.bank`` fault seam), so a
    failure leaves the previous base in place. ``priority`` and ``job``
    price the base on the ledger (``PlacementStore.put``)."""
    if pressure is None:
        pressure = _pressure_stack(model, cfg)
    warm = WarmStart(
        session=str(session),
        generation=int(generation),
        assignment=model.assignment,
        leader_slot=model.leader_slot,
        replica_disk=model.replica_disk,
        pressure=pressure,
    )
    if FAULTS.armed:
        FAULTS.hit("placement.bank")
    STORE.put(warm, priority=priority, job=job)
    return warm


def _press6(p) -> torch.Tensor:
    return torch.stack(
        (p.usage_over, p.usage_under, p.lead_over, p.lead_under, p.lbi_over, p.lbi_under)
    )


def _pressure_stack(model: TensorClusterModel, cfg: GoalConfig | None) -> torch.Tensor:
    """float32[6, B]: the six pressure tables of a model under its own
    metrics (one aggregates launch)."""
    return _press6(broker_pressure(model, broker_aggregates(model), cfg or GoalConfig()))


def _touched_mask(new: torch.Tensor, old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(bool[B] mask, int32 count), on the device: brokers whose pressure
    moved beyond the tolerance between two pressure stacks."""
    tol = PRESSURE_ATOL + PRESSURE_RTOL * torch.maximum(old.abs(), new.abs())
    mask = ((new - old).abs() > tol).any(0)
    return mask, mask.sum().int()


@costmodel.instrument("warm-init")
def warm_init(wm: TensorClusterModel, banked: torch.Tensor | None, cfg: GoalConfig,
              goal_names: tuple[str, ...]):
    """The fused first half of a warm window: one aggregates launch shared
    by the stack of the warm base under the new metrics, its pressure
    stack, the touched mask against ``banked`` (all brokers without one)
    and the descent's starting state. Returns (state, stack, pressure,
    touched mask, touched count)."""
    agg = broker_aggregates(wm)
    stack = evaluate_stack(wm, cfg, goal_names, agg=agg)
    press = _press6(broker_pressure(wm, agg, cfg))
    if banked is not None:
        mask, count = _touched_mask(press, banked)
    else:
        mask = torch.ones(press.shape[1], dtype=torch.bool, device=press.device)
        count = mask.sum().int()
    group = make_topic_group(wm, max_partitions_per_topic(wm)) if stack_needs_topic(goal_names) else None
    state0 = init_search_state(wm, cfg, goal_names, group=group, agg=agg)
    return state0, stack, press, mask, count


@costmodel.instrument("warm-finish")
def warm_finish(model: TensorClusterModel, cfg: GoalConfig, goal_names: tuple[str, ...]):
    """(exact StackResult, float32[6, B] pressure stack) of a final
    placement from one aggregates launch: the result evaluation and the
    next window's bank share it."""
    agg = broker_aggregates(model)
    return evaluate_stack(model, cfg, goal_names, agg=agg), _press6(broker_pressure(model, agg, cfg))


def warm_model(m_new: TensorClusterModel, warm: WarmStart) -> TensorClusterModel | None:
    """The new snapshot's metric and topology tensors with the warm
    placement grafted on; None when the padded shapes disagree (callers
    cold-start). Rows where the warm base holds no replica but the snapshot
    does (partitions created since the bank) keep the snapshot's
    placement."""
    if tuple(m_new.assignment.shape) != tuple(warm.assignment.shape) or (
        tuple(m_new.leader_slot.shape) != tuple(warm.leader_slot.shape)
    ):
        return None
    base_has = (warm.assignment >= 0).any(1)
    return m_new.replace(
        assignment=torch.where(base_has[:, None], warm.assignment, m_new.assignment),
        leader_slot=torch.where(base_has, warm.leader_slot, m_new.leader_slot),
        replica_disk=torch.where(base_has[:, None], warm.replica_disk, m_new.replica_disk),
    )


# ----- drift scan: touched bands -> targeted hot list ---------------------------


def touched_brokers(warm: WarmStart, model: TensorClusterModel, cfg: GoalConfig | None = None):
    """(bool[B] mask of brokers whose band pressure moved beyond tolerance
    between the banked stack and the same placement under the new metrics,
    the new pressure stack). All True when nothing comparable was banked."""
    new = _pressure_stack(model, cfg)
    if warm.pressure is None or tuple(warm.pressure.shape) != tuple(new.shape):
        return torch.ones(new.shape[1], dtype=torch.bool, device=new.device), new
    mask, _ = _touched_mask(new, warm.pressure)
    return mask, new


def drift_hot_list(model: TensorClusterModel, touched: torch.Tensor,
                   goal_names: tuple[str, ...], cfg: GoalConfig):
    """The warm SA's targeted hot list: the structural offenders
    (``hot_partition_list_device``) united with the partitions holding a
    replica on a touched broker, in id order, padded to ``_evac_bucket(P)``
    (an over-full set keeps an even subsample). Returns (evac int32[bucket],
    n_evac, n_structural); ``n_structural > 0`` means the base needs
    repair."""
    from ccx_torch.search.annealer import _evac_bucket, hot_partition_list_device

    evac_s, n_s = hot_partition_list_device(model, goal_names, cfg)
    with TRACER.blocked():
        n_structural = int(n_s)
    a = model.assignment
    touched = touched.to(a.device)
    hot = ((a >= 0) & touched[a.clamp(0, model.B - 1).long()]).any(1) & model.partition_valid
    if n_structural:
        hot[evac_s[:n_structural].long()] = True
    with TRACER.blocked():
        drift_idx = torch.nonzero(hot)[:, 0]
    bucket = _evac_bucket(model.P)
    if drift_idx.numel() > bucket:
        drift_idx = drift_idx[:: (drift_idx.numel() + bucket - 1) // bucket][:bucket]
    out = torch.zeros(bucket, dtype=torch.int32, device=a.device)
    out[: drift_idx.numel()] = drift_idx.int()
    return out, int(drift_idx.numel()), n_structural


# ----- the warm pipeline ----------------------------------------------------------


def warm_anneal_options(iopts: IncrementalOptions, base_anneal):
    """The warm SA's options: the cold rung's proposal mix with a short
    chunked budget, low temperature, a boosted hot-list draw and the
    plateau exit armed."""
    return dataclasses.replace(
        base_anneal,
        n_chains=max(iopts.warm_chains, 1),
        n_steps=max(iopts.warm_steps, 1),
        moves_per_step=max(iopts.warm_moves_per_step, 1),
        chunk_steps=max(iopts.warm_chunk_steps, 1),
        t0=iopts.warm_t0,
        t1=min(base_anneal.t1, iopts.warm_t0),
        p_evac=0.5,
        plateau_window=max(iopts.plateau_window, 1),
    )


def reoptimize(
    m: TensorClusterModel,
    warm: WarmStart,
    cfg: GoalConfig,
    goal_names: tuple[str, ...],
    iopts: IncrementalOptions,
    base_opts,
    phase=None,
    tally=None,
):
    """The warm pipeline's search (``ccx_torch.optimizer.optimize`` calls it
    with its ``phase`` context manager and ``tally`` accumulator).

    The common path (metrics-only drift) runs the fused init and one
    engine, the usage-coupled swap polish from the init's state, and
    defers the result stack to the caller's ``warm_finish`` after
    preferred-leader canonicalization. The structural path (the base's
    hard tier is non-zero under the new snapshot) first repairs, then runs
    a short plateau-terminated warm SA over the targeted hot list, then the
    swap polish.

    Returns ``(model, stack_before, stack_after, search_result, info,
    base_model, bank_pressure, n_engine_moves)``: ``stack_after`` is None
    when deferred, ``bank_pressure`` the next window's bank when the final
    placement is the one scanned (else None), ``info`` the
    ``OptimizerResult.incremental`` block. Raises ``ColdStartRequired`` when
    the warm base cannot be applied."""
    from ccx_torch.search.annealer import allows_inter_broker, anneal
    from ccx_torch.search.greedy import SwapPolishOptions, greedy_optimize, swap_polish
    from ccx_torch.search.repair import hard_repair

    def _phase(name):
        return phase(name) if phase is not None else contextlib.nullcontext()

    with _phase("warm-model"):
        wm = warm_model(m, warm)
        if wm is None:
            raise ColdStartRequired(
                f"shape mismatch: snapshot {tuple(m.assignment.shape)} vs "
                f"warm base {warm.shape_key()[0]}"
            )
        if iopts.leadership_only and not (
            torch.equal(m.assignment, warm.assignment)
            and torch.equal(m.replica_disk, warm.replica_disk)
        ):
            raise ColdStartRequired(
                "leadership-only verb: warm base replica placement differs from the live "
                "snapshot (unapplied moves); inheriting it would move replicas"
            )

    run_swap = iopts.warm_swap_iters > 0 and allows_inter_broker(goal_names)
    ksw = max(iopts.warm_swap_candidates // 2, 1)
    spo = SwapPolishOptions(
        n_swap_candidates=ksw,
        n_lead_candidates=max(iopts.warm_swap_candidates - ksw, 0),
        max_iters=iopts.warm_swap_iters,
        patience=max(iopts.warm_swap_patience, 1),
        trd_guard=base_opts.swap_polish_guarded,
        chunk_iters=max(iopts.warm_swap_iters, 1),
    )

    with _phase("drift-scan"):
        has_banked = warm.pressure is not None and tuple(warm.pressure.shape) == (6, int(wm.B))
        state0, stack_before, new_pressure, touched_dev, touched_n = warm_init(
            wm, warm.pressure if has_banked else None, cfg, goal_names
        )
        with TRACER.blocked():
            structural = float(stack_before.hard_violations) > 0
        evac = n_evac = None
        n_offenders = 0
        if structural:
            evac, n_evac, n_offenders = drift_hot_list(wm, touched_dev, goal_names, cfg)

    sa = None
    if structural:
        with _phase("repair"):
            wm, _ = hard_repair(wm, cfg, goal_names)
        aopts = warm_anneal_options(iopts, base_opts.anneal)
        with _phase("anneal"):
            sa = anneal(wm, cfg, goal_names, aopts, evac=(evac, n_evac))
        if tally is not None:
            tally(sa, "anneal")
        # the repaired and annealed placement is the base the revert guard
        # protects (never revert into infeasibility)
        wm = sa.model
        stack_before = sa.stack_before
        model = sa.model
        stack_after = sa.stack_after
    else:
        model = wm
        stack_after = None

    search = sa
    n_engine_moves = 0
    if run_swap:
        with _phase("swap-polish"):
            sp = swap_polish(
                model, cfg, goal_names, spo,
                init=None if structural else (state0, stack_before),
                defer_stack_after=True,
            )
        if tally is not None:
            tally(sp, "swap-polish")
        model = sp.model
        stack_after = None
        search = search or sp
        n_engine_moves += sp.n_moves
    bank_pressure = None
    if not structural and not run_swap:
        # no engine ran: the proposal is the base, already evaluated by the
        # fused init, whose pressure stack is the next bank
        stack_after = stack_before
        bank_pressure = new_pressure

    n_lead = 0
    if iopts.warm_leader_iters > 0:
        with _phase("leader-pass"):
            lead = greedy_optimize(
                model, cfg, goal_names,
                dataclasses.replace(
                    base_opts.polish, leadership_only=True, max_iters=iopts.warm_leader_iters
                ),
            )
            if tally is not None:
                tally(lead, "leader-pass")
            model = lead.model
            n_lead = lead.n_moves
            n_engine_moves += n_lead
            if n_lead:
                # leadership moved off the scored placement: the caller's
                # warm_finish scores the final model and banks its pressure
                stack_after = None
                bank_pressure = None
            else:
                stack_after = lead.stack_after

    touched = int(wm.B)
    if has_banked:
        with TRACER.blocked():
            touched = int(touched_n)
    info = {
        "warmStart": True,
        "coldStart": False,
        "session": warm.session,
        "baseGeneration": warm.generation,
        "touchedBrokers": touched,
        "driftPartitions": n_evac,
        "structuralOffenders": int(n_offenders),
        "swapIters": iopts.warm_swap_iters,
        "plateau": sa.plateau if sa is not None else None,
        "leaderMoves": n_lead,
    }
    return (model, stack_before, stack_after, search, info, wm, bank_pressure, n_engine_moves)


def repair_retries(model: TensorClusterModel, cfg: GoalConfig, goal_names: tuple[str, ...],
                   iopts: IncrementalOptions, base_opts, tally=None):
    """The cold pipeline's repair retries at the warm budget, for a warm
    result that kept a hard violation: up to ``max_repair_rounds - 1``
    rounds of ``hard_repair`` and the rung's polish for ``warm_swap_iters``
    iterations (patience ``warm_swap_patience``). The structural path's
    repair, warm SA and swap polish can leave an overload that the swap
    polish's candidates miss (at B5 the hot-skew family's x8 window keeps
    one network-outbound overload after the warm SA); the polish scores the
    offending broker's moves directly. Returns ``(model, stack, pressure,
    moves, rounds)`` of the first round whose placement has no hard
    violation, or None when no round reaches that (the caller then ships
    its own result)."""
    from ccx_torch.search.greedy import greedy_optimize
    from ccx_torch.search.repair import finalize_preferred_leaders, hard_repair

    polish = dataclasses.replace(
        base_opts.polish, max_iters=max(iopts.warm_swap_iters, 1),
        patience=max(iopts.warm_swap_patience, 1),
    )
    moves = 0
    for rounds in range(1, base_opts.max_repair_rounds):
        model, n_repair = hard_repair(model, cfg, goal_names)
        res = greedy_optimize(model, cfg, goal_names, polish)
        if tally is not None:
            tally(res, "repair-retry")
        model, _, _ = finalize_preferred_leaders(res.model, cfg, goal_names, None, reevaluate=False)
        moves += n_repair + res.n_moves
        stack, pressure = warm_finish(model, cfg, goal_names)
        with TRACER.blocked():
            feasible = float(stack.hard_violations) <= 0
        if feasible:
            return model, stack, pressure, moves, rounds
    return None


def _significantly_lex_worse(after: StackResult, before: StackResult) -> bool:
    """True when ``after``'s (hard violations, cost vector) is significantly
    lexicographically worse than ``before``'s, under the convergence
    module's asymmetric tolerances."""
    from ccx_torch.common.convergence import lex_improved

    return lex_improved(tuple(before.lex_key()), tuple(after.lex_key()))


class ColdStartRequired(Exception):
    """The warm base cannot be applied to this snapshot (e.g. a padded-shape
    mismatch after a topology change): fall back to the cold pipeline."""
