"""Simulated annealing over candidate placements, chains as a batch axis.

K independent chains each propose ``moves_per_step`` moves per step — the
reference's ``ActionType`` vocabulary: INTER_BROKER_REPLICA_MOVEMENT,
LEADERSHIP_MOVEMENT, INTRA_BROKER_REPLICA_MOVEMENT — score the full goal
stack from incrementally-kept aggregates (O(R) per move,
``ccx_torch.search.state``) and accept on the full per-goal cost vector:

* a move that raises any hard goal's cost is never accepted;
* a strict lexicographic improvement of the cost vector is always accepted;
* otherwise Metropolis on the tier-weighted soft delta, with a geometric
  temperature schedule.

With probability ``p_swap`` a proposal is a two-partition swap (REPLICA_SWAP:
two replicas exchange brokers, or a leadership rotation between two
partitions), which crosses count-preserving barriers single moves cannot.
Three step engines, chosen as the JAX package chooses them (``step_engine``):

* ``single`` (``p_swap == 0``): sequential single moves;
* ``sequential``: sequential proposals through one two-partition path, a
  single move being a swap with an inert partner;
* ``batched`` (the default at scale): the step's proposals are drawn,
  scored and accepted against the step's base state, then a disjoint subset
  (in draw order) is applied at once; swap endpoints are drawn
  usage-coupled from candidate pools with probability ``swap_coupling``.

Every random number comes from the caller's ``torch.Generator`` through the
``draw_*`` functions; the plan and accept functions take those draws as
tensors, so a test can hand them exactly the draws another implementation
made.

With ``chunk_steps > 0`` the steps run in chunks through ``drive_chunks``:
each chunk ends with one convergence-tap row (``ccx_torch.search.telemetry``),
the plateau exit (``plateau_window``) reads that row at the chunk boundary,
and ``n_temps > 1`` arms the replica-exchange ladder, which permutes whole
chains between temperature rungs at chunk boundaries
(``exchange_permutation``). Chunking draws nothing and changes no step, so a
chunked run with ``n_temps=1`` equals the one-loop run exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np
import torch

from ccx_torch.common import costmodel
from ccx_torch.common.resources import Resource
from ccx_torch.goals import topic_terms as tt
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack, soft_weights
from ccx_torch.model.aggregates import BROKER_FIELDS, broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.search.state import (
    KIND_LEADERSHIP_SWAP,
    KIND_REPLICA_SWAP,
    KIND_SINGLE,
    PartitionView,
    SearchState,
    _placement_updates,
    _take_rows,
    apply_move,
    apply_swap,
    broker_pressure,
    bump_kind_counters,
    cat_views,
    gather_views,
    init_search_state,
    make_cost_vector_fn,
    make_move_scorer,
    make_swap_scorer,
    make_topic_group,
    max_partitions_per_topic,
    scatter_partition,
    stack_needs_topic,
    usage_weights,
    view_rows,
    with_placement,
)

# Move kinds (ref ActionType).
MOVE_REPLICA = 0      # INTER_BROKER_REPLICA_MOVEMENT
MOVE_LEADERSHIP = 1   # LEADERSHIP_MOVEMENT
MOVE_DISK = 2         # INTRA_BROKER_REPLICA_MOVEMENT (JBOD)


@dataclasses.dataclass(frozen=True)
class AnnealOptions:
    n_chains: int = 64
    n_steps: int = 3000
    #: proposals per chain per step
    moves_per_step: int = 1
    #: True: a step's proposals are scored against the step's base state and
    #: applied as a disjoint batch (the ``batched`` engine, where the cluster
    #: is wide enough for the batch to be disjoint); False: they compose
    #: sequentially, each scoring the state the previous one left
    batched: bool = True
    t0: float = 0.3          # initial temperature (soft-cost units)
    t1: float = 1e-4         # final temperature
    p_leadership: float = 0.15
    p_disk: float = 0.0      # raise for JBOD stacks
    #: probability the destination broker is drawn headroom-weighted rather
    #: than uniformly
    p_biased_dest: float = 0.5
    #: probability of drawing from the hot list (replicas on dead brokers or
    #: disks, rack duplicates) when it is non-empty
    p_evac: float = 0.3
    #: share of two-partition swap proposals (0 disables them)
    p_swap: float = 0.15
    #: >= 0: the swap share moves linearly from ``p_swap`` to this value
    #: over the run; < 0: constant ``p_swap``
    p_swap_end: float = -1.0
    #: share of swap proposals whose endpoints are drawn usage-coupled
    #: (batched engine only): each endpoint Gumbel-picked from a pool of
    #: ``couple_pool`` candidates ranked by broker band pressure x replica
    #: usage
    swap_coupling: float = 0.5
    couple_pool: int = 4
    #: > 0: run the steps in chunks of this many through ``drive_chunks``
    #: (one tap row per chunk; the plateau exit and the ladder act at chunk
    #: boundaries); 0: one loop
    chunk_steps: int = 0
    #: > 0 (chunked, taps on): stop once this many consecutive chunks fail
    #: to lex-improve the tap's current row
    plateau_window: int = 0
    #: > 1 (chunked): the replica-exchange ladder's temperature rungs. Rung 0
    #: cools on the ``t0 -> t1`` schedule, rung K-1 holds at ``t0``, the
    #: rungs between end on a geometric ladder; neighbouring rungs exchange
    #: whole chains at chunk boundaries
    n_temps: int = 1
    #: chunk boundaries between exchange sweeps under the ladder
    exchange_interval: int = 1
    #: rank the coupled pools' scores in bfloat16 (rank-order only; costs
    #: and acceptance stay float32)
    bf16_scoring: bool = False
    seed: int = 0


@dataclasses.dataclass
class AnnealResult:
    model: TensorClusterModel
    stack_before: StackResult
    stack_after: StackResult
    n_accepted: int
    n_chains: int
    n_steps: int
    best_chain: int
    n_prop_kind: tuple[int, ...] = (0, 0, 0)
    n_acc_kind: tuple[int, ...] = (0, 0, 0)
    #: the step engine that ran (``step_engine``)
    engine: str = "single"
    #: decoded convergence segment (``telemetry.decode``) of a chunked run
    #: with taps on, else None
    convergence: dict | None = None
    #: plateau-exit report (``PlateauExit.to_json``) when ``plateau_window``
    #: was armed, else None
    plateau: dict | None = None


@dataclasses.dataclass(frozen=True)
class ProposalParams:
    """Static knobs of move proposal (shared by the annealer and greedy)."""

    p_real: int
    b_real: int
    p_leadership: float = 0.15
    p_disk: float = 0.0
    p_biased_dest: float = 0.5
    p_evac: float = 0.3
    #: hot draws also target duplicate-rack slots (stack has a rack goal)
    target_rack: bool = False
    #: False for intra-broker-only stacks: hot draws never force an
    #: inter-broker evacuation move
    allow_inter: bool = True
    #: share of two-partition swap proposals (0 disables the swap branch)
    p_swap: float = 0.15
    #: stack scores capacity goals: hot draws target replicas on brokers
    #: above effective capacity and biased destinations avoid them
    target_capacity: bool = True
    cap_thresholds: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    #: share of swap proposals that rotate leadership instead of exchanging
    #: replicas (``lead_swap_share``)
    p_lead_swap: float = 0.5
    #: share of swap proposals drawn usage-coupled (batched engine only)
    p_couple: float = 0.0
    #: candidates per coupled endpoint draw
    couple_pool: int = 4
    #: coupled pool scores in bfloat16
    bf16: bool = False


def lead_swap_share(p_leadership: float) -> float:
    """Leadership-rotation share of swap proposals: 0.5 at the default
    p_leadership=0.15, proportionally less below it, 0 when leadership moves
    are off."""
    if p_leadership <= 0:
        return 0.0
    return 0.5 * min(p_leadership / 0.15, 1.0)


def scoring_dtype(bf16: bool) -> torch.dtype:
    """dtype of rank-order-only scoring intermediates (the coupled pool
    scores); cost vectors and acceptance never use it."""
    return torch.bfloat16 if bf16 else torch.float32


RACK_TARGET_GOALS = frozenset(
    {"RackAwareGoal", "RackAwareDistributionGoal", "KafkaAssignerEvenRackAwareGoal"}
)
CAPACITY_GOALS = frozenset(
    {"CpuCapacityGoal", "NetworkInboundCapacityGoal",
     "NetworkOutboundCapacityGoal", "DiskCapacityGoal"}
)
#: stacks made only of these goals move replicas within a broker only
INTRA_ONLY_GOALS = frozenset(
    {"IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"}
)


def allows_inter_broker(goal_names: tuple[str, ...]) -> bool:
    return not set(goal_names) <= INTRA_ONLY_GOALS


def _evac_bucket(P: int) -> int:
    """Offender-list length for a model with padded partition count P: the
    SA hot list and the repair sweep's per-sweep offender bound share it."""
    return min(P, max(1024, P // 16))


def _structural_hot(m: TensorClusterModel, goal_names: tuple[str, ...]) -> torch.Tensor:
    """bool[P]: partitions with a replica on a dead broker (inter-broker
    stacks) or a dead disk, or with a rack duplicate (stacks with a rack
    goal)."""
    a = m.assignment
    valid = m.replica_valid
    safe_b = a.clamp(0, m.B - 1).long()
    hot = torch.zeros(m.P, dtype=torch.bool, device=m.device)
    if allows_inter_broker(goal_names):
        hot |= (valid & ~m.broker_ok[safe_b]).any(1)
    rd = m.replica_disk
    hot |= (valid & (rd >= 0) & ~m.disk_alive[safe_b, rd.clamp(0, m.D - 1).long()]).any(1)
    if RACK_TARGET_GOALS & set(goal_names):
        slots = torch.arange(m.R, device=m.device)
        racks = torch.where(valid, m.broker_rack[safe_b], -1 - slots[None, :].int())
        dup = (racks[:, :, None] == racks[:, None, :]) & (slots[:, None] < slots[None, :])
        hot |= dup.any(2).any(1) & m.partition_valid
    return hot


def _capacity_hot(m: TensorClusterModel, cfg: GoalConfig | None) -> torch.Tensor:
    """bool[P]: partitions with a replica on a live broker above its
    effective capacity (one aggregates launch)."""
    cap = effective_capacity(m, (cfg or GoalConfig()).capacity_threshold)
    load = broker_aggregates(m).broker_load
    util = torch.where(cap > 0, load / torch.where(cap > 0, cap, 1.0), 0.0).amax(0)
    over_b = m.broker_ok & (util > 1.0)
    return (m.replica_valid & over_b[m.assignment.clamp(0, m.B - 1).long()]).any(1)


def _scores_capacity(goal_names: tuple[str, ...]) -> bool:
    return allows_inter_broker(goal_names) and bool(CAPACITY_GOALS & set(goal_names))


@costmodel.instrument("hot-list")
def hot_partition_list(
    m: TensorClusterModel,
    goal_names: tuple[str, ...] = (),
    cfg: GoalConfig | None = None,
) -> tuple[torch.Tensor, int]:
    """Partitions violating targetable hard constraints: replicas on dead
    brokers (inter-broker stacks) or dead disks, plus rack duplicates when
    the stack has a rack goal; when none exist and the stack scores
    capacity, partitions with a replica on a broker above effective
    capacity. Returns (sorted ids int32, padded to ``_evac_bucket(P)`` —
    or to P when more offenders exist — and their count)."""
    hot = _structural_hot(m, goal_names)
    if _scores_capacity(goal_names) and not bool(hot.any()):
        hot = _capacity_hot(m, cfg)
    idx = torch.nonzero(hot)[:, 0].int()
    n = idx.numel()
    bucket = _evac_bucket(m.P)
    size = max(bucket if n <= bucket else m.P, 1)
    out = torch.zeros(size, dtype=torch.int32, device=m.device)
    out[:n] = idx
    return out, n


def hot_partition_list_device(
    m: TensorClusterModel,
    goal_names: tuple[str, ...] = (),
    cfg: GoalConfig | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``hot_partition_list`` with no host read: (the lowest offender ids in
    ascending order, 0-padded to ``_evac_bucket(P)``, int32; their count, an
    int32 tensor). The same selection rules, the capacity scan always
    launched; more offenders than the bucket holds keep the lowest ids."""
    hot = _structural_hot(m, goal_names)
    if _scores_capacity(goal_names):
        hot = torch.where(hot.any(), hot, _capacity_hot(m, cfg))
    bucket = _evac_bucket(m.P)
    # a stable sort puts the offenders first, in id order: no data-dependent
    # shape, so no host read
    order = torch.argsort((~hot).to(torch.uint8), stable=True)[:bucket]
    n = hot.sum().clamp(max=bucket).int()
    idx = torch.where(torch.arange(bucket, device=m.device) < n, order, 0).int()
    return idx, n


# --------------------------------------------------------------------------
# Draws
# --------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, device, low: float = 0.0) -> torch.Tensor:
    """Uniform floats in [low, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    return u * (1.0 - low) + low if low else u


@dataclasses.dataclass
class PartitionDraws:
    p: torch.Tensor          # int[K] uniform partition in [0, p_real)
    u_evac: torch.Tensor     # float32[K] hot-list coin
    evac_i: torch.Tensor     # int[K] hot-list index in [0, max(n_evac, 1))


def draw_partitions(
    gen: torch.Generator, K: int, pp: ProposalParams, n_evac: int, device
) -> PartitionDraws:
    return PartitionDraws(
        p=torch.randint(0, pp.p_real, (K,), generator=gen, device=device),
        u_evac=_uniform(gen, (K,), device),
        evac_i=torch.randint(0, max(n_evac, 1), (K,), generator=gen, device=device),
    )


def _draw_partition(
    d: PartitionDraws, pp: ProposalParams, evac: torch.Tensor | None, n_evac: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(partition ids int64[K], drawn-from-hot-list bool[K])."""
    p = d.p.long()
    use_evac = torch.zeros_like(p, dtype=torch.bool)
    if evac is not None and n_evac > 0:
        use_evac = d.u_evac < pp.p_evac
        p = torch.where(use_evac, evac[d.evac_i.long()].long(), p)
    return p, use_evac


@dataclasses.dataclass
class SingleDraws:
    u_kind: torch.Tensor     # float32[K] picks replica / leadership / disk move
    r: torch.Tensor          # int[K] replica slot in [0, R)
    u_prefer: torch.Tensor   # float32[K] leadership move targets slot 0 if < 0.5
    u_dst: torch.Tensor      # float32[K, B] in [1e-12, 1): Gumbel noise of the biased destination
    dst_uniform: torch.Tensor  # int[K] uniform destination in [0, b_real)
    u_bias: torch.Tensor     # float32[K] biased (< p_biased_dest) or uniform destination
    u_disk: torch.Tensor     # float32[K, D] in [1e-12, 1): Gumbel noise of the disk pick


def draw_single(
    gen: torch.Generator, K: int, m: TensorClusterModel, pp: ProposalParams
) -> SingleDraws:
    dev = m.device
    return SingleDraws(
        u_kind=_uniform(gen, (K,), dev),
        r=torch.randint(0, m.R, (K,), generator=gen, device=dev),
        u_prefer=_uniform(gen, (K,), dev),
        u_dst=_uniform(gen, (K, m.B), dev, 1e-12),
        dst_uniform=torch.randint(0, pp.b_real, (K,), generator=gen, device=dev),
        u_bias=_uniform(gen, (K,), dev),
        u_disk=_uniform(gen, (K, m.D), dev, 1e-12),
    )


def effective_capacity(m: TensorClusterModel, thresholds) -> torch.Tensor:
    """float32[RES, B] — capacity times the per-resource threshold (where
    the hard capacity goals' hinge starts), built without a host copy."""
    return torch.stack([m.broker_capacity[i] * float(t) for i, t in enumerate(thresholds)])


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def _at(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x[k, r[k]] for x[K, R]."""
    return x.gather(1, r.long()[:, None])[:, 0]


def _single_plan(
    d: SingleDraws,
    state: SearchState,
    chain: torch.Tensor,
    m: TensorClusterModel,
    pp: ProposalParams,
    view: PartitionView,
    use_evac: torch.Tensor,
):
    """Build K candidate moves from gathered views: returns (old rows, new
    rows, feasible bool[K]).

    Feasibility never creates structural violations: the destination is
    alive, valid, not replica-excluded and not already hosting the
    partition; leadership lands only on alive, non-leadership-excluded
    brokers; immovable partitions are untouchable."""
    R, B, D = m.R, m.B, m.D
    dev = m.device
    slots = torch.arange(R, device=dev)
    p_rep = 1.0 - pp.p_leadership - pp.p_disk
    kind = torch.where(
        d.u_kind < p_rep, MOVE_REPLICA,
        torch.where(d.u_kind < p_rep + pp.p_leadership, MOVE_LEADERSHIP, MOVE_DISK),
    )
    # half of the leadership transfers target the preferred slot 0
    prefer = d.u_prefer < 0.5
    r = torch.where((kind == MOVE_LEADERSHIP) & prefer, 0, d.r.long())
    old_assign, old_leader, old_disk = view.assign, view.leader, view.disk

    ok_b = m.broker_ok
    safe_row = old_assign.clamp(0, B - 1).long()
    safe_dk = old_disk.clamp(0, D - 1).long()
    slot_ok = old_assign >= 0
    cap_eff = effective_capacity(m, pp.cap_thresholds)
    # a resource with capacity 0 is unconstrained: utilization 0
    load = state.agg.broker_load                                # [C, RES, B]
    util_c = torch.where(
        cap_eff > 0, load / torch.where(cap_eff > 0, cap_eff, 1.0), 0.0
    ).amax(1)                                                   # [C, B]
    util_b = util_c[chain.long()]                               # [K, B]
    if pp.allow_inter:
        dead_broker_slot = slot_ok & ~ok_b[safe_row]
        over_slot = (
            slot_ok & ok_b[safe_row] & (util_b.gather(1, safe_row) > 1.0)
            if pp.target_capacity else torch.zeros_like(slot_ok)
        )
    else:
        dead_broker_slot = torch.zeros_like(slot_ok)
        over_slot = torch.zeros_like(slot_ok)
    dead_disk_slot = slot_ok & ok_b[safe_row] & (old_disk >= 0) & ~m.disk_alive[safe_row, safe_dk]
    row_racks = torch.where(slot_ok, m.broker_rack[safe_row], -1 - slots[None, :].int())
    if pp.target_rack:
        rack_dup_slot = slot_ok & (
            (row_racks[:, None, :] == row_racks[:, :, None])
            & (slots[None, :] < slots[:, None])
        ).any(2)
    else:
        rack_dup_slot = torch.zeros_like(slot_ok)
    # a dead-broker replica outranks a dead disk outranks a rack duplicate
    # outranks a capacity overload
    bad_score = (
        3.0 * dead_broker_slot + 2.5 * dead_disk_slot
        + 1.0 * rack_dup_slot + 0.5 * over_slot
    )
    has_bad = bad_score.amax(1) > 0.0
    bad_r = bad_score.argmax(1)
    hot = use_evac & has_bad
    r = torch.where(hot, bad_r, r)
    evac_kind = torch.where(_at(dead_disk_slot, bad_r), MOVE_DISK, MOVE_REPLICA)
    kind = torch.where(hot, evac_kind, kind)
    repair_rack = hot & _at(rack_dup_slot, bad_r) & ~_at(dead_disk_slot, bad_r)

    src = _at(old_assign, r)
    slot_valid = src >= 0
    movable = view.pvalid & ~view.immovable

    # --- destination broker: headroom-weighted or uniform -------------------
    alive_ok = ok_b & ~m.broker_excl_replicas
    headroom = 1.0 - util_b
    w = torch.where(alive_ok, headroom.clamp(min=0) + 0.05, 0.0)
    if pp.target_capacity:
        w = torch.where(util_b <= 1.0, w, 0.0)
        # every alive broker over capacity: least-loaded fallback
        w_fb = torch.where(alive_ok, 1.0 / util_b.clamp(min=1e-9), 0.0)
        w = torch.where((w > 0).any(1, keepdim=True), w, w_fb)
    g = _gumbel(d.u_dst)
    neg_inf = float("-inf")
    dst_biased = torch.where(w > 0, torch.log(w) + g, neg_inf).argmax(1)
    use_bias = d.u_bias < pp.p_biased_dest
    dst = torch.where(use_bias, dst_biased, d.dst_uniform.long())
    if pp.target_rack:
        # rack repairs relocate onto a rack the partition does not use
        used = torch.where(slot_ok, row_racks, -1)
        rack_used = (m.broker_rack[None, None, :] == used[:, :, None]).any(1)
        w_rack = torch.where(rack_used, 0.0, w)
        any_free = (w_rack > 0).any(1)
        dst_rack = torch.where(w_rack > 0, torch.log(w_rack) + g, neg_inf).argmax(1)
        dst = torch.where(repair_rack & any_free, dst_rack, dst)

    # --- feasibility masks ---------------------------------------------------
    dst_ok = alive_ok[dst] & (dst != src)
    no_dup = ~(old_assign == dst[:, None]).any(1)
    is_leader_slot = r == old_leader
    dst_lead_ok = ~(is_leader_slot & m.broker_excl_leadership[dst])
    move_ok = (kind == MOVE_REPLICA) & slot_valid & movable & dst_ok & no_dup & dst_lead_ok

    gd = _gumbel(d.u_disk)
    dst_disk = torch.where(m.disk_alive[dst], gd, neg_inf).argmax(1)

    tgt_b = src.clamp(0, B - 1).long()
    can_lead = ok_b & ~m.broker_excl_leadership
    lead_ok = (
        (kind == MOVE_LEADERSHIP) & slot_valid & movable & (r != old_leader) & can_lead[tgt_b]
    )

    disk_new = torch.where(m.disk_alive[tgt_b], gd, neg_inf).argmax(1)
    disk_ok = (
        (kind == MOVE_DISK) & slot_valid & movable & (disk_new != _at(old_disk, r)) & (D > 1)
    )
    feasible = move_ok | lead_ok | disk_ok

    at_r = slots[None, :] == r[:, None]
    new_assign = torch.where(move_ok[:, None] & at_r, dst[:, None].int(), old_assign)
    new_leader = torch.where(lead_ok, r.int(), old_leader)
    moved_disk = dst_disk if D > 1 else torch.zeros_like(dst_disk)
    new_disk = torch.where(
        move_ok[:, None] & at_r, moved_disk[:, None].int(),
        torch.where(disk_ok[:, None] & at_r, disk_new[:, None].int(), old_disk),
    )
    return (
        (old_assign, old_leader, old_disk),
        (new_assign, new_leader, new_disk),
        feasible,
    )


@dataclasses.dataclass
class SwapDraws:
    r1: torch.Tensor         # int[K] slot of partition 1 in [0, R)
    r2: torch.Tensor         # int[K] slot of partition 2 in [0, R)
    u_d1: torch.Tensor       # float32[K, D] in [1e-12, 1): Gumbel noise of p1's new disk
    u_d2: torch.Tensor       # float32[K, D] in [1e-12, 1): Gumbel noise of p2's new disk
    u_kind: torch.Tensor     # float32[K] leadership rotation if < p_lead_swap


def draw_swap(gen: torch.Generator, K: int, m: TensorClusterModel) -> SwapDraws:
    dev = m.device
    return SwapDraws(
        r1=torch.randint(0, m.R, (K,), generator=gen, device=dev),
        r2=torch.randint(0, m.R, (K,), generator=gen, device=dev),
        u_d1=_uniform(gen, (K, m.D), dev, 1e-12),
        u_d2=_uniform(gen, (K, m.D), dev, 1e-12),
        u_kind=_uniform(gen, (K,), dev),
    )


def _slot_mask(r: torch.Tensor, R: int) -> torch.Tensor:
    """bool[K, R] — slot r[k] of row k."""
    return torch.arange(R, device=r.device)[None, :] == r[:, None]


def _swap_plan(
    d: SwapDraws,
    m: TensorClusterModel,
    pp: ProposalParams,
    p1: torch.Tensor,
    view1: PartitionView,
    p2: torch.Tensor,
    view2: PartitionView,
    use_lead: torch.Tensor | None = None,
    couple: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
):
    """Build K swap candidates from two gathered views: returns (old1, new1,
    old2, new2, feasible bool[K], is_lead bool[K]).

    Two variants share the draw: a replica swap (two replicas exchange
    brokers; every broker keeps its replica count) and a leadership
    rotation (p1's leadership moves to p2's leader broker and p2's to p1's;
    every broker keeps its leader count), which is how leader-bytes and
    preferred-leader gains cross the LeaderReplicaDistribution tier.
    ``use_lead`` pre-decides the variant (the batched engine draws it with
    the pools); None uses ``d.u_kind``. ``couple = (use_couple, r1_c,
    r2_c)`` replaces the uniform slots with the coupled pools' slots."""
    R, B, D = m.R, m.B, m.D
    r1, r2 = d.r1.long(), d.r2.long()
    if couple is not None:
        use_couple, r1_c, r2_c = couple
        r1 = torch.where(use_couple, r1_c.long(), r1)
        r2 = torch.where(use_couple, r2_c.long(), r2)
    x = _at(view1.assign, r1)
    y = _at(view2.assign, r2)
    sx, sy = x.clamp(0, B - 1).long(), y.clamp(0, B - 1).long()
    recv_ok = m.broker_ok & ~m.broker_excl_replicas
    excl_lead = m.broker_excl_leadership
    lead1 = r1 == view1.leader
    lead2 = r2 == view2.leader
    both = (p1 != p2) & view1.pvalid & view2.pvalid & ~view1.immovable & ~view2.immovable
    ok = (
        both & (x >= 0) & (y >= 0) & (x != y) & recv_ok[sx] & recv_ok[sy]
        & ~(view1.assign == y[:, None]).any(1)
        & ~(view2.assign == x[:, None]).any(1)
        & ~(lead1 & excl_lead[sy])
        & ~(lead2 & excl_lead[sx])
    )
    neg_inf = float("-inf")
    if D > 1:
        d1 = torch.where(m.disk_alive[sy], _gumbel(d.u_d1), neg_inf).argmax(1).int()
        d2 = torch.where(m.disk_alive[sx], _gumbel(d.u_d2), neg_inf).argmax(1).int()
    else:
        d1 = d2 = torch.zeros_like(x)
    at1, at2 = _slot_mask(r1, R), _slot_mask(r2, R)
    old1 = (view1.assign, view1.leader, view1.disk)
    old2 = (view2.assign, view2.leader, view2.disk)
    new1 = (
        torch.where(at1, y[:, None], view1.assign),
        view1.leader,
        torch.where(at1, d1[:, None], view1.disk),
    )
    new2 = (
        torch.where(at2, x[:, None], view2.assign),
        view2.leader,
        torch.where(at2, d2[:, None], view2.disk),
    )

    # --- leadership rotation ---------------------------------------------
    lb1 = _at(view1.assign, view1.leader.clamp(0, R - 1)).clamp(0, B - 1).long()
    lb2 = _at(view2.assign, view2.leader.clamp(0, R - 1)).clamp(0, B - 1).long()
    # p1's leadership lands on lb2 (it needs a replica there), p2's on lb1
    on_lb2 = view1.assign == lb2[:, None]
    on_lb1 = view2.assign == lb1[:, None]
    r1l = on_lb2.int().argmax(1).int()
    r2l = on_lb1.int().argmax(1).int()
    lead_allowed = m.broker_ok & ~excl_lead
    ok_lead = (
        both & (lb1 != lb2) & on_lb2.any(1) & on_lb1.any(1)
        & lead_allowed[lb1] & lead_allowed[lb2]
    )
    if use_lead is None:
        lead_possible = pp.p_lead_swap > 0
        use_lead = (
            d.u_kind < pp.p_lead_swap if lead_possible
            else torch.zeros_like(ok)
        )
    else:
        lead_possible = True
    if lead_possible:
        ul = use_lead[:, None]
        new1 = (
            torch.where(ul, view1.assign, new1[0]),
            torch.where(use_lead, r1l, new1[1]),
            torch.where(ul, view1.disk, new1[2]),
        )
        new2 = (
            torch.where(ul, view2.assign, new2[0]),
            torch.where(use_lead, r2l, new2[1]),
            torch.where(ul, view2.disk, new2[2]),
        )
        ok = torch.where(use_lead, ok_lead, ok)
    return old1, new1, old2, new2, ok, use_lead


@dataclasses.dataclass
class SwapProposalDraws:
    p1: torch.Tensor         # int[K] uniform partition in [0, p_real)
    p2: torch.Tensor         # int[K] uniform partition in [0, p_real)
    plan: SwapDraws


def propose_swap(
    d: SwapProposalDraws,
    state: SearchState,
    chain: torch.Tensor,
    m: TensorClusterModel,
    pp: ProposalParams,
):
    """K uniform swap candidates: returns (p1, view1, old1, new1, p2,
    view2, old2, new2, feasible, is_lead)."""
    K = chain.shape[0]
    views = gather_views(state, m, torch.cat([chain, chain]), torch.cat([d.p1, d.p2]))
    view1 = view_rows(views, slice(0, K))
    view2 = view_rows(views, slice(K, 2 * K))
    p1, p2 = d.p1.long(), d.p2.long()
    old1, new1, old2, new2, ok, is_lead = _swap_plan(d.plan, m, pp, p1, view1, p2, view2)
    return p1, view1, old1, new1, p2, view2, old2, new2, ok, is_lead


def goal_tols(cost_vec: torch.Tensor) -> torch.Tensor:
    """Per-goal significance tolerance for vector comparisons."""
    return 1e-6 + 1e-6 * cost_vec.abs()


def lex_accept(
    cur_vec: torch.Tensor,      # float32[K, G]
    new_vec: torch.Tensor,      # float32[K, G]
    hard_arr: torch.Tensor,     # bool[G]
    weights: torch.Tensor,      # float32[G] tier weights
    temperature: float | torch.Tensor,  # one, or float32[K] per candidate
    u: torch.Tensor,            # float32[K] uniform in [1e-12, 1)
) -> torch.Tensor:
    """Vector-lexicographic SA acceptance (see module docstring)."""
    d = new_vec - cur_vec
    sig = d.abs() > goal_tols(cur_vec)
    any_sig = sig.any(-1)
    first = sig.int().argmax(-1, keepdim=True)
    lex_lt = any_sig & (d.gather(-1, first)[..., 0] < 0)
    hard_up = (sig & hard_arr & (d > 0)).any(-1)
    soft_d = torch.where(hard_arr, 0.0, d * weights).sum(-1)
    if torch.is_tensor(temperature):
        t = temperature.clamp(min=1e-30)
    else:
        t = max(temperature, 1e-30)
    metropolis = torch.log(u) < (-soft_d / t)
    return ~hard_up & (lex_lt | ~any_sig | metropolis)


def _chain_temp(temperature, chain: torch.Tensor):
    """The temperature of each candidate's chain: the one temperature of a
    flat run, or a ladder's per-chain temperatures gathered by chain."""
    return temperature[chain.long()] if torch.is_tensor(temperature) else temperature


def _anneal_step(
    state: SearchState,
    gen: torch.Generator,
    temperature: float | torch.Tensor,
    evac: torch.Tensor,
    n_evac: int,
    *,
    m: TensorClusterModel,
    pp: ProposalParams,
    hard_arr: torch.Tensor,
    weights: torch.Tensor,
    moves_per_step: int,
    scorer,
    group,
) -> None:
    """``moves_per_step`` sequential proposals on every chain at once: each
    scores against the state the previous one left."""
    C = state.n_chains
    chains = torch.arange(C, device=m.device)
    for _ in range(moves_per_step):
        p, use_evac = _draw_partition(draw_partitions(gen, C, pp, n_evac, m.device), pp, evac, n_evac)
        view = gather_views(state, m, chains, p)
        old, new, feasible = _single_plan(draw_single(gen, C, m, pp), state, chains, m, pp, view, use_evac)
        delta = scorer(state, chains, view, old, new)
        u = _uniform(gen, (C,), m.device, 1e-12)
        accept = feasible & lex_accept(state.cost_vec, delta.cost_vec, hard_arr, weights, temperature, u)
        apply_move(state, m, chains, p, view, old, new, delta, accept, group=group)
        bump_kind_counters(state, chains, KIND_SINGLE, 1, accept)


@dataclasses.dataclass
class UnifiedDraws:
    """Draws of one proposal per chain of the sequential two-partition
    engine."""

    u_sel: torch.Tensor      # float32[C] swap if < the step's swap share
    part: PartitionDraws     # the single move's partition
    p1: torch.Tensor         # int[C] swap partitions in [0, p_real)
    p2: torch.Tensor         # int[C] (also the single move's inert partner)
    single: SingleDraws
    swap: SwapDraws
    u_acc: torch.Tensor      # float32[C] in [1e-12, 1): Metropolis uniform


def draw_unified(
    gen: torch.Generator, C: int, m: TensorClusterModel, pp: ProposalParams, n_evac: int
) -> UnifiedDraws:
    dev = m.device
    return UnifiedDraws(
        u_sel=_uniform(gen, (C,), dev),
        part=draw_partitions(gen, C, pp, n_evac, dev),
        p1=torch.randint(0, pp.p_real, (C,), generator=gen, device=dev),
        p2=torch.randint(0, pp.p_real, (C,), generator=gen, device=dev),
        single=draw_single(gen, C, m, pp),
        swap=draw_swap(gen, C, m),
        u_acc=_uniform(gen, (C,), dev, 1e-12),
    )


def _inert(use: torch.Tensor, rows):
    """Rows where ``use``, else -1: an inert partner's rows, whose every
    scatter contribution and write is exactly zero."""
    return tuple(torch.where(use.view(-1, *([1] * (r.dim() - 1))), r, -1) for r in rows)


def _pick(use: torch.Tensor, a, b):
    """Row-wise ``a`` where ``use`` else ``b``, for (assign, leader, disk)."""
    return tuple(torch.where(use.view(-1, *([1] * (x.dim() - 1))), x, y) for x, y in zip(a, b))


def _unified_move(
    state: SearchState,
    d: UnifiedDraws,
    temperature: float | torch.Tensor,
    swap_share: float,
    evac: torch.Tensor,
    n_evac: int,
    *,
    m: TensorClusterModel,
    pp: ProposalParams,
    hard_arr: torch.Tensor,
    weights: torch.Tensor,
    swap_scorer,
    group,
) -> None:
    """One proposal on every chain through the two-partition path: a swap
    with probability ``swap_share``, else a single move with an inert
    partner (the partner may equal the moved partition; its writes are
    dropped)."""
    C = state.n_chains
    chains = torch.arange(C, device=m.device)
    use_swap = d.u_sel < swap_share
    p_single, use_evac = _draw_partition(d.part, pp, evac, n_evac)
    pa = torch.where(use_swap, d.p1.long(), p_single)
    pb = d.p2.long()
    views = gather_views(state, m, torch.cat([chains, chains]), torch.cat([pa, pb]))
    va, vb = view_rows(views, slice(0, C)), view_rows(views, slice(C, 2 * C))
    _, new_s, feas_s = _single_plan(d.single, state, chains, m, pp, va, use_evac & ~use_swap)
    _, n1w, _, n2w, ok_w, is_lead = _swap_plan(d.swap, m, pp, pa, va, pb, vb)
    olda = (va.assign, va.leader, va.disk)
    newa = _pick(use_swap, n1w, new_s)
    oldb = _inert(use_swap, (vb.assign, vb.leader, vb.disk))
    newb = _inert(use_swap, n2w)
    feasible = torch.where(use_swap, ok_w, feas_s)
    delta = swap_scorer(state, chains, va, olda, newa, vb, oldb, newb)
    accept = feasible & lex_accept(state.cost_vec, delta.cost_vec, hard_arr, weights, temperature, d.u_acc)
    apply_swap(
        state, m, chains, pa, va, olda, newa, pb, vb, oldb, newb, delta, accept,
        group=group, active2=use_swap,
    )
    kind = torch.where(use_swap, torch.where(is_lead, KIND_LEADERSHIP_SWAP, KIND_REPLICA_SWAP), KIND_SINGLE)
    bump_kind_counters(state, chains, kind, 1, accept)


@dataclasses.dataclass
class BatchedDraws:
    """Draws of one batched step: C chains x K proposals. Per-proposal
    fields are flattened chain-major (row ``c * K + k``); ``pool_a``/``pool_b``
    are the endpoint pools (pool slot 0 is the uniform draw, and slot 0 of
    ``pool_a`` doubles as the single move's partition)."""

    u_sel: torch.Tensor      # float32[C*K] swap if < the step's swap share
    part: PartitionDraws     # [C*K] single-move partitions
    pool_a: torch.Tensor     # int[C*K, pool] in [0, p_real)
    pool_b: torch.Tensor     # int[C*K, pool]
    u_lead: torch.Tensor     # float32[C*K] leadership rotation if < p_lead_swap
    u_cpl: torch.Tensor      # float32[C*K] coupled endpoints if < p_couple
    u_ga: torch.Tensor       # float32[C*K, pool] in [1e-12, 1): Gumbel noise of pick a
    u_gb: torch.Tensor       # float32[C*K, pool]
    single: SingleDraws      # [C*K]
    swap: SwapDraws          # [C*K]
    u_acc: torch.Tensor      # float32[C*K] in [1e-12, 1): Metropolis uniform


def couple_pool_size(pp: ProposalParams) -> int:
    """Endpoint pool size of the batched engine (1 without coupling)."""
    return max(int(pp.couple_pool), 1) if pp.p_couple > 0.0 else 1


def draw_batched(
    gen: torch.Generator, C: int, K: int, m: TensorClusterModel, pp: ProposalParams, n_evac: int
) -> BatchedDraws:
    dev = m.device
    N, pool = C * K, couple_pool_size(pp)
    return BatchedDraws(
        u_sel=_uniform(gen, (N,), dev),
        part=draw_partitions(gen, N, pp, n_evac, dev),
        pool_a=torch.randint(0, pp.p_real, (N, pool), generator=gen, device=dev),
        pool_b=torch.randint(0, pp.p_real, (N, pool), generator=gen, device=dev),
        u_lead=_uniform(gen, (N,), dev),
        u_cpl=_uniform(gen, (N,), dev),
        u_ga=_uniform(gen, (N, pool), dev, 1e-12),
        u_gb=_uniform(gen, (N, pool), dev, 1e-12),
        single=draw_single(gen, N, m, pp),
        swap=draw_swap(gen, N, m),
        u_acc=_uniform(gen, (N,), dev, 1e-12),
    )


def broker_masks(touched: torch.Tensor, B: int) -> torch.Tensor:
    """bool[N, B] — which brokers each candidate's rows ``touched[N, n]``
    touch (negative ids dropped)."""
    ok = touched >= 0
    mask = torch.zeros(touched.shape[0], B + 1, dtype=torch.int32, device=touched.device)
    mask.scatter_add_(1, torch.where(ok, touched, B).long(), ok.int())
    return mask[:, :B] > 0


def _pool_scores(vp: PartitionView, chain: torch.Tensor, press, over: bool, m, sdt):
    """Coupled endpoint quality of pool views ``vp`` (chain ``chain``):
    (replica-swap logit, leadership-rotation logit, best slot). Endpoint a
    (``over``) wants a hot replica on an over-band broker, endpoint b a cool
    one on an under-band broker; a rotation endpoint is the leader broker's
    leader-bytes pressure times the leader's bytes in."""
    B, R = m.B, m.R
    uw = usage_weights(m.device)
    b = vp.assign.clamp(0, B - 1).long()
    c = chain.long()[:, None]
    ok = (vp.assign >= 0) & vp.pvalid[:, None] & ~vp.immovable[:, None]
    is_l = torch.arange(R, device=m.device)[None, :] == vp.leader[:, None]
    u = torch.where(is_l, (vp.lead_load @ uw)[:, None], (vp.foll_load @ uw)[:, None]).to(sdt)
    if over:
        sc = press.usage_over[c, b].to(sdt) * u * ok
    else:
        sc = press.usage_under[c, b].to(sdt) * (1.0 / (1.0 + u)) * ok
    slot = sc.argmax(1).int()
    rs_logit = torch.log(sc.amax(1).float() + 1e-12)
    lsafe = vp.leader.clamp(0, R - 1).long()[:, None]
    lb = b.gather(1, lsafe)[:, 0]
    has_lead = vp.pvalid & (vp.assign.gather(1, lsafe)[:, 0] >= 0)
    lbytes = vp.lead_load[:, Resource.NW_IN].to(sdt)
    if over:
        lsc = press.lbi_over[chain.long(), lb].to(sdt) * lbytes
    else:
        lsc = press.lbi_under[chain.long(), lb].to(sdt) * (1.0 / (1.0 + lbytes))
    lsc = torch.where(has_lead, lsc.float(), 0.0)
    return rs_logit, torch.log(lsc + 1e-12), slot


def _lex_not_worse(vec: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """bool[...] — ``vec`` is not lexicographically worse than ``ref``
    (per-goal tolerance)."""
    d = vec - ref
    sig = d.abs() > goal_tols(ref)
    first = sig.int().argmax(-1, keepdim=True)
    return ~(sig.any(-1) & (d.gather(-1, first)[..., 0] > 0))


def _anneal_step_batched(
    state: SearchState,
    d: BatchedDraws,
    temperature: float | torch.Tensor,
    swap_share: float,
    evac: torch.Tensor,
    n_evac: int,
    *,
    m: TensorClusterModel,
    pp: ProposalParams,
    hard_arr: torch.Tensor,
    weights: torch.Tensor,
    moves_per_step: int,
    swap_scorer,
    vector_fn,
    group,
    cfg: GoalConfig,
) -> None:
    """``moves_per_step`` proposals per chain, drawn, scored and accepted
    against the step's base state, then applied as a disjoint batch.

    Candidates whose touched brokers or topics overlap an earlier accepted
    one (in draw order) are dropped; disjointness makes every
    sum-decomposable goal term exactly additive, and the selected subset is
    composed in one weighted scatter. The composed vector is recomputed
    exactly, and the batch is kept only if it raises no hard goal and is
    lexicographically no worse than the base (a descent) or than the base
    plus the members' own deltas (the exploration each member's Metropolis
    test sanctioned): a deterministic guard against the couplings that are
    not sums (leader evenness, the TRD normalizer)."""
    C, K = state.n_chains, moves_per_step
    N = C * K
    B, T, R = m.B, m.num_topics, m.R
    dev = m.device
    chain = torch.arange(C, device=dev).repeat_interleave(K)
    use_swap = d.u_sel < swap_share
    p_single, use_evac = _draw_partition(d.part, pp, evac, n_evac)
    use_evac = use_evac & ~use_swap
    pool = d.pool_a.shape[1]
    pool_a = torch.cat([torch.where(use_swap, d.pool_a[:, 0].long(), p_single)[:, None],
                        d.pool_a[:, 1:].long()], dim=1)
    pool_b = d.pool_b.long()
    if pp.p_lead_swap > 0:
        use_lead = d.u_lead < pp.p_lead_swap
    else:
        use_lead = torch.zeros(N, dtype=torch.bool, device=dev)
    couple_on = pp.p_couple > 0.0
    use_couple = (d.u_cpl < pp.p_couple) & use_swap if couple_on else torch.zeros_like(use_swap)

    # one stacked gather of all 2 * N * pool endpoint views
    chain_pool = chain.repeat_interleave(pool)
    views = gather_views(
        state, m, torch.cat([chain_pool, chain_pool]),
        torch.cat([pool_a.reshape(-1), pool_b.reshape(-1)]),
    )
    rows = torch.arange(N, device=dev)
    if couple_on:
        press = broker_pressure(m, state.agg, cfg)
        sdt = scoring_dtype(pp.bf16)
        vpa = view_rows(views, slice(0, N * pool))
        vpb = view_rows(views, slice(N * pool, 2 * N * pool))
        rs_a, ls_a, slot_a = _pool_scores(vpa, chain_pool, press, True, m, sdt)
        rs_b, ls_b, slot_b = _pool_scores(vpb, chain_pool, press, False, m, sdt)

        def gumbel_pick(rs, ls, u):
            logit = torch.where(use_lead[:, None], ls.view(N, pool), rs.view(N, pool))
            return torch.where(use_couple, (logit + _gumbel(u)).argmax(1), 0)

        sel_a = gumbel_pick(rs_a, ls_a, d.u_ga)
        sel_b = gumbel_pick(rs_b, ls_b, d.u_gb)
        r1_c = slot_a.view(N, pool)[rows, sel_a]
        r2_c = slot_b.view(N, pool)[rows, sel_b]
    else:
        sel_a = sel_b = torch.zeros(N, dtype=torch.long, device=dev)
        r1_c = r2_c = torch.zeros(N, dtype=torch.int32, device=dev)
    va = view_rows(views, rows * pool + sel_a)
    vb = view_rows(views, N * pool + rows * pool + sel_b)
    pa = pool_a[rows, sel_a]
    pb = pool_b[rows, sel_b]

    _, new_s, feas_s = _single_plan(d.single, state, chain, m, pp, va, use_evac)
    _, n1w, _, n2w, ok_w, _ = _swap_plan(
        d.swap, m, pp, pa, va, pb, vb,
        use_lead=use_lead if pp.p_lead_swap > 0 else None,
        couple=(use_couple & ~use_lead, r1_c, r2_c),
    )
    olda = (va.assign, va.leader, va.disk)
    newa = _pick(use_swap, n1w, new_s)
    oldb = _inert(use_swap, (vb.assign, vb.leader, vb.disk))
    newb = _inert(use_swap, n2w)
    feas = torch.where(use_swap, ok_w, feas_s)
    deltas = swap_scorer(state, chain, va, olda, newa, vb, oldb, newb)
    base = state.cost_vec
    accept = feas & lex_accept(
        base[chain], deltas.cost_vec, hard_arr, weights, _chain_temp(temperature, chain), d.u_acc
    )

    # --- disjoint selection in draw order --------------------------------
    bmask = broker_masks(torch.cat([olda[0], newa[0], oldb[0], newb[0]], dim=1), B).view(C, K, B)
    ta = va.topic.long().clamp(0, T - 1).view(C, K)
    tb = vb.topic.long().clamp(0, T - 1).view(C, K)
    acc_ck, sw_ck = accept.view(C, K), use_swap.view(C, K)
    used_b = torch.zeros(C, B, dtype=torch.bool, device=dev)
    used_t = torch.zeros(C, T, dtype=torch.bool, device=dev)
    take = torch.zeros(C, K, dtype=torch.bool, device=dev)
    crow = torch.arange(C, device=dev)
    for k in range(K):
        conf = (
            (bmask[:, k] & used_b).any(1)
            | used_t[crow, ta[:, k]]
            | (sw_ck[:, k] & used_t[crow, tb[:, k]])
        )
        take_k = acc_ck[:, k] & ~conf
        take[:, k] = take_k
        used_b |= bmask[:, k] & take_k[:, None]
        used_t[crow, ta[:, k]] |= take_k
        used_t[crow, tb[:, k]] |= take_k & sw_ck[:, k]

    # --- exact composition of the selected subset: one weighted scatter --
    tk = take.view(N)
    w, wi = tk.float(), tk.int()
    agg = _take_rows(state.agg, crow)
    scatter_partition(
        agg, m, torch.cat([chain] * 4), cat_views(va, va, vb, vb),
        *(torch.cat(x) for x in zip(olda, newa, oldb, newb)),
        torch.cat([-w, w, -w, w]), torch.cat([-wi, wi, -wi, wi]),
    )
    part = state.part_sums.index_add(0, chain, w[:, None] * (deltas.part_sums - state.part_sums[chain]))
    mtl = state.mtl_sum.index_add(0, chain, w * deltas.d_mtl)
    trd = state.trd_sum.index_add(0, chain, w * deltas.d_trd)
    totals = state.topic_totals.index_put(
        (torch.cat([chain, chain]), torch.cat([va.topic, vb.topic]).long()),
        torch.cat([w * deltas.d_total, w * deltas.d_total2]), accumulate=True,
    )
    cost_vec = vector_fn(agg, part, mtl, trd, tt.trd_normalizer(m, totals))

    # --- the deterministic batch guard -----------------------------------
    dd = cost_vec - base
    hard_regressed = ((dd.abs() > goal_tols(base)) & hard_arr & (dd > 0)).any(1)
    G = base.shape[1]
    predicted = base + torch.where(
        take[..., None], deltas.cost_vec.view(C, K, G) - base[:, None, :], 0.0
    ).sum(1)
    batch_ok = ~hard_regressed & (_lex_not_worse(cost_vec, base) | _lex_not_worse(cost_vec, predicted))

    def keep(new: torch.Tensor, old: torch.Tensor) -> None:
        old.copy_(torch.where(batch_ok.view(C, *([1] * (old.dim() - 1))), new, old))

    for f in BROKER_FIELDS:
        keep(getattr(agg, f), getattr(state.agg, f))
    keep(part, state.part_sums)
    keep(mtl, state.mtl_sum)
    keep(trd, state.trd_sum)
    keep(totals, state.topic_totals)
    keep(cost_vec, state.cost_vec)
    state.n_accepted += torch.where(batch_ok, take.sum(1).int(), 0)
    write_a = tk & batch_ok[chain]
    write_b = write_a & use_swap
    _placement_updates(
        state, group, torch.cat([chain, chain]), torch.cat([pa, pb]),
        torch.cat([va.topic, vb.topic]),
        write=torch.cat([write_a, write_b]),
        mirror=torch.cat([write_a & va.pvalid, write_b & vb.pvalid]),
        rows=torch.cat([newa[0], newb[0]]),
        leads=torch.cat([newa[1], newb[1]]),
        disks=torch.cat([newa[2], newb[2]]),
    )
    kind = torch.where(use_swap, torch.where(use_lead, KIND_LEADERSHIP_SWAP, KIND_REPLICA_SWAP), KIND_SINGLE)
    bump_kind_counters(state, chain, kind, 1, write_a)


def best_chain_index(cost_vecs: np.ndarray) -> int:
    """Lexicographic argmin across chains (host side, tiny array)."""
    order = sorted(range(cost_vecs.shape[0]), key=lambda i: tuple(cost_vecs[i]))
    return int(order[0])


def real_sizes(m: TensorClusterModel) -> tuple[int, int]:
    """(valid partitions, one past the last valid broker)."""
    p_real = int(m.partition_valid.sum())
    bv = torch.nonzero(m.broker_valid)
    return p_real, (int(bv.max()) + 1) if bv.numel() else 0


def _swap_ramp_of(opts: AnnealOptions, n: int) -> float:
    """Per-step change of the swap share (0.0 when ``p_swap_end < 0``)."""
    if opts.p_swap_end < 0:
        return 0.0
    return (opts.p_swap_end - opts.p_swap) / max(n - 1, 1)


def step_engine(opts: AnnealOptions, pp: ProposalParams, R: int, schedule_on: bool) -> str:
    """The SA step engine, chosen as the JAX package chooses it: the batched
    step needs swaps in the mix, several moves per step and room for a
    disjoint batch (each move touches about 2R brokers, so below
    ``4 * R * moves`` brokers most of a batch would conflict)."""
    swaps = pp.p_swap > 0.0 or schedule_on
    if opts.batched and opts.moves_per_step > 1 and swaps and pp.b_real >= 4 * R * opts.moves_per_step:
        return "batched"
    return "sequential" if swaps else "single"


def proposal_params(
    opts: AnnealOptions, goal_names: tuple[str, ...], cfg: GoalConfig, p_real: int, b_real: int
) -> ProposalParams:
    """The proposal knobs of an SA run."""
    allow_inter = allows_inter_broker(goal_names)
    return ProposalParams(
        p_real=p_real,
        b_real=b_real,
        p_leadership=opts.p_leadership,
        p_disk=opts.p_disk,
        p_biased_dest=opts.p_biased_dest,
        p_evac=opts.p_evac,
        target_rack=bool(RACK_TARGET_GOALS & set(goal_names)),
        allow_inter=allow_inter,
        p_swap=opts.p_swap if allow_inter else 0.0,
        target_capacity=bool(CAPACITY_GOALS & set(goal_names)),
        cap_thresholds=tuple(cfg.capacity_threshold),
        p_lead_swap=lead_swap_share(opts.p_leadership),
        p_couple=opts.swap_coupling if allow_inter else 0.0,
        couple_pool=opts.couple_pool,
        bf16=opts.bf16_scoring,
    )


def step_kwargs(
    m: TensorClusterModel, cfg: GoalConfig, goal_names: tuple[str, ...], pp: ProposalParams,
    engine: str, moves: int, group,
) -> dict:
    """The keyword arguments of ``engine``'s step function."""
    hard_mask = tuple(GOAL_REGISTRY[n].hard for n in goal_names)
    kw = dict(
        m=m, pp=pp,
        hard_arr=torch.tensor(hard_mask, device=m.device),
        weights=soft_weights(hard_mask, m.device),
        group=group,
    )
    if engine == "single":
        kw.update(moves_per_step=moves, scorer=make_move_scorer(m, goal_names, cfg))
    else:
        kw.update(swap_scorer=make_swap_scorer(m, goal_names, cfg))
    if engine == "batched":
        kw.update(moves_per_step=moves, vector_fn=make_cost_vector_fn(m, goal_names, cfg), cfg=cfg)
    return kw


# --------------------------------------------------------------------------
# Chunked drives, the plateau exit and the replica-exchange ladder
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PlateauExit:
    """Plateau-terminated budget for one ``drive_chunks`` call.

    ``row(carry)`` returns the convergence tap's current row (the lex-best
    cost vector the chunk just wrote); ``drive_chunks`` reads it at each chunk
    boundary, so the decision always describes the chunk that just ran,
    never the one before it. ``window`` and ``min_chunks`` are host data.
    ``drive_chunks`` fills in the result fields; ``chunks_run`` and
    ``last_improved_chunk`` are both 1-based ordinals."""

    row: object
    window: int = 1
    min_chunks: int = 1
    exited: bool = False
    chunks_run: int = 0
    last_improved_chunk: int = 0

    def to_json(self, budget_chunks: int | None = None) -> dict:
        out = {
            "exited": bool(self.exited),
            "chunksRun": int(self.chunks_run),
            "window": int(self.window),
            "lastImprovedChunk": int(self.last_improved_chunk),
        }
        if budget_chunks is not None:
            out["chunksBudget"] = int(budget_chunks)
        return out


def _row_values(row) -> list[float]:
    """A tap row as floats; a row that is not a sequence of numbers raises
    TypeError or ValueError. Reading a device row is the host sync."""
    if torch.is_tensor(row):
        row = row.tolist()
    return [float(x) for x in row]


class _ProbeReader:
    """Reads a chunk's probe scalar without a host sync of its own. On a
    CUDA tensor the value is copied into pinned memory behind the queued
    work and read once that copy has landed (an event query); until then
    the last landed value stands, so the energy may be a chunk stale. A
    CPU tensor is read directly."""

    def __init__(self) -> None:
        self.buf = None
        self.event = None
        self.pending = False
        self.value: float | None = None

    def push(self, val) -> None:
        if val.device.type != "cuda":
            self.value = float(val)
            return
        if self.buf is None:
            self.buf = torch.zeros((), dtype=val.dtype, pin_memory=True)
            self.event = torch.cuda.Event()
        # a copy still in flight keeps the buffer: the newer value waits
        # for the next chunk rather than racing it
        self.poll()
        if not self.pending:
            self.buf.copy_(val, non_blocking=True)
            self.event.record()
            self.pending = True

    def poll(self) -> float | None:
        if self.pending and self.event.query():
            self.value = float(self.buf)
            self.pending = False
        return self.value


def drive_chunks(run_one, carry, *, total: int, chunk: int, probe=None,
                 plateau: PlateauExit | None = None):
    """Call ``run_one(carry, off)`` once per chunk offset of ``range(0,
    total, chunk)``, threading the carry through. ``run_one`` returns
    ``(carry, done)``; a truthy ``done`` (the descents' stop flag, read
    here: one host read per chunk) ends the loop. SA chunks return None and
    are never read.

    When the calling thread runs under a fleet job
    (``ccx_torch.search.scheduler.FLEET.job``, the optimizer's ``job=``
    entry), the drive counts toward the scheduler's occupancy and every
    chunk DISPATCH (``run_one``) runs under a grant of the multi-job run
    queue: concurrent jobs interleave their chunks on the card, and a
    cancelled job raises ``JobCancelled`` at its next grant. With no
    ambient job the loop is ungated.

    Every chunk emits one flight-recorder heartbeat (``TRACER.heartbeat``:
    chunk index, offset, total and energy). ``probe(carry) -> 0-d tensor``
    (the convergence taps' tier-0 cost) supplies the energy without a host
    sync of its own: its value is copied behind the chunk and read when
    that copy has landed (``_ProbeReader``) — on a descent, after the stop
    flag's read, which drains the queue, so the energy is the current
    chunk's; on SA chunks, usually the previous chunk's. A plateau-armed
    drive takes the energy from its own row read instead.

    ``plateau`` arms the plateau-terminated budget: after each chunk the
    drive reads ``plateau.row(carry)`` and stops once ``plateau.window``
    consecutive chunks fail to lex-improve on the best row so far
    (``ccx_torch.common.convergence.lex_improved``), and not before
    ``plateau.min_chunks`` chunks. A row that is not a sequence of numbers
    drops the plateau exit and the drive runs its fixed budget; an error
    from the read itself (a failed device op) propagates."""
    from ccx_torch.common.convergence import lex_improved
    from ccx_torch.common.tracing import TRACER
    from ccx_torch.search.scheduler import FLEET

    step = max(int(chunk), 1)
    n = max(int(total), 0)
    job = FLEET.current()
    reader = _ProbeReader() if probe is not None else None
    best_vec = None
    since_improve = 0
    with FLEET.drive(job) if job is not None else contextlib.nullcontext():
        for i, off in enumerate(range(0, n, step)):
            if job is not None:
                with FLEET.chunk(job):
                    carry, done = run_one(carry, off)
            else:
                carry, done = run_one(carry, off)
            if reader is not None and plateau is None:
                reader.push(probe(carry))
            stop = done is not None and bool(done)
            energy = None
            done_plateau = False
            if plateau is not None:
                row = plateau.row(carry)
                try:
                    vec = _row_values(row)
                except (TypeError, ValueError):
                    plateau = None
                else:
                    # this read is the chunk's sync: the energy is current
                    energy = vec[0] if vec else None
                    plateau.chunks_run = i + 1
                    if best_vec is None or lex_improved(vec, best_vec):
                        best_vec = list(vec)
                        since_improve = 0
                        plateau.last_improved_chunk = i + 1
                    else:
                        since_improve += 1
                    done_plateau = (
                        i + 1 >= max(plateau.min_chunks, 1)
                        and since_improve >= max(plateau.window, 1)
                    )
                    plateau.exited = done_plateau and off + step < n
            if energy is None and reader is not None:
                energy = reader.poll()
            TRACER.heartbeat(i, offset=off, total=n, energy=energy)
            if stop or done_plateau:
                break
    return carry


def ladder_rungs(n_temps: int, n_chains: int) -> np.ndarray:
    """int32[n_chains] rung of each chain: equal contiguous blocks of
    ``n_chains // K`` chains, rung 0 coldest; remainder chains fold into the
    hottest rung and sit outside the exchange pairing."""
    K = max(int(n_temps), 1)
    size = max(int(n_chains) // K, 1)
    return np.minimum(np.arange(int(n_chains)) // size, K - 1).astype(np.int32)


def ladder_fracs(n_temps: int, n_chains: int) -> np.ndarray:
    """float32[n_chains] decay-exponent fraction of each chain: rung k cools
    as ``t0 * decay**(t * (1 - k/(K-1)))`` — rung 0 the flat schedule, rung
    K-1 holding at ``t0``."""
    K = max(int(n_temps), 1)
    if K == 1:
        return np.ones(int(n_chains), np.float32)
    rung = ladder_rungs(K, n_chains).astype(np.float64)
    return (1.0 - rung / (K - 1)).astype(np.float32)


def ladder_end_temps(opts: AnnealOptions) -> list[float]:
    """End-of-schedule temperature of each rung (for the report)."""
    K = max(int(opts.n_temps), 1)
    if K == 1:
        return [float(opts.t1)]
    return [float(opts.t1 ** (1.0 - k / (K - 1)) * opts.t0 ** (k / (K - 1))) for k in range(K)]


def _lex_lt_rows(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """bool[n]: row ``a[i]`` lexicographically beats ``b[i]`` under the
    ``goal_tols`` rule, optionally over the goals in ``mask`` only."""
    d = a - b
    sig = d.abs() > goal_tols(b)
    if mask is not None:
        sig = sig & mask[None, :]
    first = sig.int().argmax(1, keepdim=True)
    return sig.any(1) & (d.gather(1, first)[:, 0] < 0)


def draw_exchange(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """The Metropolis uniforms of one exchange sweep, in [1e-12, 1)."""
    return _uniform(gen, (n,), device, 1e-12)


def exchange_permutation(
    cost_vec: torch.Tensor,     # float32[n, G] per-chain lex cost vectors
    temps: torch.Tensor,        # float32[n] per-chain current temperature
    u: torch.Tensor,            # float32[n] in [1e-12, 1) (``draw_exchange``)
    *,
    n_temps: int,
    hard_arr: torch.Tensor,     # bool[G]
    weights: torch.Tensor,      # float32[G] soft tier weights
    parity: int,                # 0: pair rungs (0,1),(2,3)...; 1: (1,2),(3,4)...
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One replica-exchange sweep as a permutation of the chain axis.

    Rung r chain j pairs with rung r+1 chain j (alternating pairings by
    ``parity``). Each pair swaps whole chain states or stays; the decision,
    taken at the cold member, is: (1) where the hard tiers differ
    significantly, swap iff the hot member is hard-lex-better; (2) else
    where the soft scalars differ, Metropolis ``log u < (1/T_cold -
    1/T_hot) * (E_cold - E_hot)``; (3) else swap iff the hot member is
    lex-better. The lex-best chain is never moved hotter and always moved
    colder. Returns ``(perm int64[n], attempted, accepted)`` (tensors);
    ``perm`` is an involution."""
    n, G = cost_vec.shape
    dev = cost_vec.device
    K = max(int(n_temps), 1)
    size = max(n // K, 1)
    idx = torch.arange(n, device=dev)
    rung = (idx // size).clamp(max=K - 1)
    in_ladder = idx < K * size
    low = ((rung - parity) % 2) == 0
    partner_rung = torch.where(low, rung + 1, rung - 1)
    valid = in_ladder & (partner_rung >= 0) & (partner_rung < K)
    partner = torch.where(valid, partner_rung.clamp(0, K - 1) * size + idx % size, idx)

    soft_w = torch.where(hard_arr, 0.0, weights)
    E = cost_vec @ soft_w
    cv_p = cost_vec[partner]

    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for g in range(G):
        col = torch.where(alive, cost_vec[:, g], float("inf"))
        mn = col.min()
        alive = alive & (col <= mn + 1e-6 + 1e-6 * mn.abs())
    is_best = idx == alive.int().argmax()

    hard_sig = (((cost_vec - cv_p).abs() > goal_tols(cost_vec)) & hard_arr[None, :]).any(1)
    hot_hard_better = _lex_lt_rows(cv_p, cost_vec, mask=hard_arr)
    E_p = E[partner]
    inv_t = 1.0 / temps.clamp(min=1e-30)
    dlog = (inv_t - inv_t[partner]) * (E - E_p)
    metro = torch.log(u) < dlog
    soft_tie = (E - E_p).abs() <= 1e-6 + 1e-6 * E.abs()
    hot_lex_better = _lex_lt_rows(cv_p, cost_vec)

    d = torch.where(soft_tie, hot_lex_better, metro)
    d = torch.where(hard_sig, hot_hard_better, d)
    d = d & ~is_best
    d = d | is_best[partner]
    d = d & valid & low
    swap = d | d[partner]
    perm = torch.where(swap, partner, idx)
    return perm, (valid & low).sum().int(), d.sum().int()


def permute_chains(state: SearchState, perm: torch.Tensor) -> None:
    """Reorder every chain-axis tensor of ``state`` by ``perm``, in place."""
    C = state.n_chains
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "agg":
            for g in dataclasses.fields(v):
                x = getattr(v, g.name)
                x.copy_(x[perm])
        elif torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == C:
            v.copy_(v[perm])


#: (n_chains, ranks, n_temps) shapes whose rounding was already logged
_ROUNDED_SHAPES: set = set()


def round_up_chains(n_chains: int, ranks: int, where: str, n_temps: int = 1) -> int:
    """The next multiple of ``ranks * n_temps`` at or above ``n_chains``,
    so every ladder rung has as many chains; logged once per shape."""
    mult = max(int(ranks), 1) * max(int(n_temps), 1)
    if mult <= 1 or n_chains % mult == 0:
        return max(n_chains, mult)
    rounded = ((n_chains + mult - 1) // mult) * mult
    shape = (int(n_chains), int(ranks), int(n_temps))
    if shape not in _ROUNDED_SHAPES:
        _ROUNDED_SHAPES.add(shape)
        logging.getLogger(__name__).warning(
            "%s: n_chains=%d not divisible by %d (chain ranks %d x temperature rungs %d); "
            "rounding up to %d", where, n_chains, mult, ranks, n_temps, rounded,
        )
    return rounded


#: the chains' starting state, counted on the cost ledger
_chain_init = costmodel.instrument("chain-init")(init_search_state)


def anneal(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts: AnnealOptions = AnnealOptions(),
    evac: tuple[torch.Tensor, int | torch.Tensor] | None = None,
) -> AnnealResult:
    """Run SA on ``opts.n_chains`` chains and return the best chain's
    placement as a new model.

    Chains never accept hard-cost-increasing moves and the temperature ends
    near zero; the winner is the lexicographic argmin of the cost vectors.
    The returned stack scores are re-evaluated from scratch. ``evac`` is an
    optional precomputed hot list (``hot_partition_list`` or
    ``hot_partition_list_device``; a tensor count is read once here).

    ``chunk_steps > 0`` runs the steps in chunks (module docstring); the
    ladder rounds ``n_chains`` up to a multiple of ``n_temps``."""
    stack_before = evaluate_stack(m, cfg, goal_names)
    p_real, b_real = real_sizes(m)
    evac_idx, n_evac = evac if evac is not None else hot_partition_list(m, goal_names, cfg)
    n_evac = int(n_evac)
    group = (
        make_topic_group(m, max_partitions_per_topic(m)) if stack_needs_topic(goal_names) else None
    )
    pp = proposal_params(opts, goal_names, cfg, p_real, b_real)
    chunked = opts.chunk_steps > 0
    n_temps = max(int(opts.n_temps), 1) if chunked else 1
    if opts.n_temps > 1 and not chunked:
        logging.getLogger(__name__).warning(
            "anneal: n_temps=%d needs chunk_steps > 0 (exchange runs at chunk boundaries); "
            "the one-loop run stays flat", opts.n_temps,
        )
    C = round_up_chains(opts.n_chains, 1, "anneal", n_temps=n_temps) if n_temps > 1 else opts.n_chains
    state = _chain_init(m, cfg, goal_names, group=group, n_chains=C)
    gen = torch.Generator(device=m.device)
    gen.manual_seed(opts.seed)
    n = max(opts.n_steps, 1)
    decay = (opts.t1 / opts.t0) ** (1.0 / max(n - 1, 1))
    ramp = _swap_ramp_of(opts, n)
    schedule_on = pp.allow_inter and opts.p_swap_end >= 0
    engine = step_engine(opts, pp, m.R, schedule_on)
    moves = max(opts.moves_per_step, 1)
    kw = step_kwargs(m, cfg, goal_names, pp, engine, moves, group)
    frac = (
        torch.from_numpy(ladder_fracs(n_temps, C)).to(m.device) if n_temps > 1 else None
    )

    def temperature(t: int):
        if frac is None:
            return opts.t0 * decay**t
        return opts.t0 * torch.pow(torch.full_like(frac, decay), t * frac)

    def run_steps(lo: int, hi: int) -> None:
        for t in range(lo, hi):
            temp = temperature(t)
            share = pp.p_swap + ramp * t
            if engine == "single":
                _anneal_step(state, gen, temp, evac_idx, n_evac, **kw)
            elif engine == "batched":
                d = draw_batched(gen, C, moves, m, pp, n_evac)
                _anneal_step_batched(state, d, temp, share, evac_idx, n_evac, **kw)
            else:
                for _ in range(moves):
                    d = draw_unified(gen, C, m, pp, n_evac)
                    _unified_move(state, d, temp, share, evac_idx, n_evac, **kw)

    convergence = plateau_info = None
    # the cost ledger's signature of this run's chunk: the state's shapes
    # and the step's engine and sizes (never the budget or the seed)
    sig = costmodel.signature(state, engine, moves, n_temps, opts.chunk_steps)
    if not chunked:
        costmodel.instrument("sa-monolith", iters=opts.n_steps, sig=sig, device=m.device)(
            run_steps)(0, opts.n_steps)
    else:
        from ccx_torch.search import telemetry

        chunk = int(opts.chunk_steps)
        G = len(goal_names)
        tap = telemetry.make_tap(G, m.device) if telemetry.enabled() else None
        interval = max(int(opts.exchange_interval), 1)
        ex_kw = {}
        if n_temps > 1:
            ex_kw = dict(n_temps=n_temps, hard_arr=kw["hard_arr"], weights=kw["weights"])

        def run_one(carry, off):
            # steps at or past the budget are inert: never run, never drawn
            hi = min(off + chunk, opts.n_steps)
            run_steps(off, hi)
            t_last = max(min(off + chunk, n) - 1, 0)
            ex_att = ex_acc = None
            chunk_ord = off // chunk
            if n_temps > 1 and (chunk_ord + 1) % interval == 0 and off < n:
                u = draw_exchange(gen, C, m.device)
                perm, ex_att, ex_acc = exchange_permutation(
                    state.cost_vec, temperature(t_last), u,
                    parity=(chunk_ord // interval) % 2, **ex_kw,
                )
                permute_chains(state, perm)
            if tap is not None:
                telemetry.record(
                    tap, telemetry.lex_best_row(state.cost_vec),
                    state.n_prop_kind.sum(0), state.n_acc_kind.sum(0),
                    opts.t0 * decay**t_last, ex_att, ex_acc,
                )
            return carry, None

        plateau = None
        if opts.plateau_window > 0 and tap is not None:
            plateau = PlateauExit(
                row=lambda _: telemetry.current_row(tap, G), window=int(opts.plateau_window)
            )
        # heartbeat energy: the best chain's top-tier cost
        probe = (lambda _: state.cost_vec[:, 0].min()) if tap is not None else None
        run_one = costmodel.instrument("sa-chunk", iters=chunk, sig=sig, device=m.device)(run_one)
        drive_chunks(run_one, None, total=n, chunk=chunk, probe=probe, plateau=plateau)
        ladder = None
        if n_temps > 1:
            ladder = {
                "nTemps": n_temps, "interval": interval, "rungSize": C // n_temps,
                "t0": float(opts.t0), "endTemps": ladder_end_temps(opts),
            }
        convergence = telemetry.decode(tap, goal_names, chunk_size=chunk, budget=n, ladder=ladder)
        if plateau is not None:
            plateau_info = plateau.to_json(budget_chunks=(n + chunk - 1) // chunk)

    best = best_chain_index(state.cost_vec.cpu().numpy())
    result_model = with_placement(m, state, best)
    return AnnealResult(
        model=result_model,
        stack_before=stack_before,
        stack_after=evaluate_stack(result_model, cfg, goal_names),
        n_accepted=int(state.n_accepted[best]),
        n_chains=C,
        n_steps=opts.n_steps,
        best_chain=best,
        n_prop_kind=tuple(state.n_prop_kind[best].tolist()),
        n_acc_kind=tuple(state.n_acc_kind[best].tolist()),
        engine=engine,
        convergence=convergence,
        plateau=plateau_info,
    )
