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

Every random number comes from the caller's ``torch.Generator`` through the
``draw_*`` functions; the plan and accept functions take those draws as
tensors, so a test can hand them exactly the draws another implementation
made. The two-partition swap move class is not part of this package yet:
``p_swap`` must be 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack, soft_weights
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.search.state import (
    KIND_SINGLE,
    PartitionView,
    SearchState,
    apply_move,
    bump_kind_counters,
    gather_views,
    init_search_state,
    make_move_scorer,
    make_topic_group,
    max_partitions_per_topic,
    stack_needs_topic,
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
    #: proposals per chain per step, composed sequentially (each scores the
    #: state the previous one left)
    moves_per_step: int = 1
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
    #: share of two-partition REPLICA_SWAP proposals; the swap move class is
    #: not ported yet, so only 0 is accepted
    p_swap: float = 0.0
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
    #: stack scores capacity goals: hot draws target replicas on brokers
    #: above effective capacity and biased destinations avoid them
    target_capacity: bool = True
    cap_thresholds: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


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
    a = m.assignment
    valid = m.replica_valid
    safe_b = a.clamp(0, m.B - 1).long()
    hot = torch.zeros(m.P, dtype=torch.bool, device=m.device)
    inter = allows_inter_broker(goal_names)
    if inter:
        hot |= (valid & ~m.broker_ok[safe_b]).any(1)
    rd = m.replica_disk
    dead_disk = valid & (rd >= 0) & ~m.disk_alive[safe_b, rd.clamp(0, m.D - 1).long()]
    hot |= dead_disk.any(1)
    if RACK_TARGET_GOALS & set(goal_names):
        slots = torch.arange(m.R, device=m.device)
        racks = torch.where(valid, m.broker_rack[safe_b], -1 - slots[None, :].int())
        dup = (racks[:, :, None] == racks[:, None, :]) & (slots[:, None] < slots[None, :])
        hot |= dup.any(2).any(1) & m.partition_valid
    if inter and CAPACITY_GOALS & set(goal_names) and not bool(hot.any()):
        cap = effective_capacity(m, (cfg or GoalConfig()).capacity_threshold)
        load = broker_aggregates(m).broker_load
        util = torch.where(cap > 0, load / torch.where(cap > 0, cap, 1.0), 0.0).amax(0)
        over_b = m.broker_ok & (util > 1.0)
        hot |= (valid & over_b[safe_b]).any(1)
    idx = torch.nonzero(hot)[:, 0].int()
    n = idx.numel()
    bucket = _evac_bucket(m.P)
    size = max(bucket if n <= bucket else m.P, 1)
    out = torch.zeros(size, dtype=torch.int32, device=m.device)
    out[:n] = idx
    return out, n


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


def goal_tols(cost_vec: torch.Tensor) -> torch.Tensor:
    """Per-goal significance tolerance for vector comparisons."""
    return 1e-6 + 1e-6 * cost_vec.abs()


def lex_accept(
    cur_vec: torch.Tensor,      # float32[K, G]
    new_vec: torch.Tensor,      # float32[K, G]
    hard_arr: torch.Tensor,     # bool[G]
    weights: torch.Tensor,      # float32[G] tier weights
    temperature: float,
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
    metropolis = torch.log(u) < (-soft_d / max(temperature, 1e-30))
    return ~hard_up & (lex_lt | ~any_sig | metropolis)


def _anneal_step(
    state: SearchState,
    gen: torch.Generator,
    temperature: float,
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


def best_chain_index(cost_vecs: np.ndarray) -> int:
    """Lexicographic argmin across chains (host side, tiny array)."""
    order = sorted(range(cost_vecs.shape[0]), key=lambda i: tuple(cost_vecs[i]))
    return int(order[0])


def real_sizes(m: TensorClusterModel) -> tuple[int, int]:
    """(valid partitions, one past the last valid broker)."""
    p_real = int(m.partition_valid.sum())
    bv = torch.nonzero(m.broker_valid)
    return p_real, (int(bv.max()) + 1) if bv.numel() else 0


def anneal(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts: AnnealOptions = AnnealOptions(),
    evac: tuple[torch.Tensor, int] | None = None,
) -> AnnealResult:
    """Run SA on ``opts.n_chains`` chains and return the best chain's
    placement as a new model.

    Chains never accept hard-cost-increasing moves and the temperature ends
    near zero; the winner is the lexicographic argmin of the cost vectors.
    The returned stack scores are re-evaluated from scratch. ``evac`` is an
    optional precomputed ``hot_partition_list``."""
    if opts.p_swap > 0 and allows_inter_broker(goal_names):
        raise NotImplementedError("the two-partition swap move class is not ported; set p_swap=0")
    stack_before = evaluate_stack(m, cfg, goal_names)
    p_real, b_real = real_sizes(m)
    evac_idx, n_evac = evac if evac is not None else hot_partition_list(m, goal_names, cfg)
    group = (
        make_topic_group(m, max_partitions_per_topic(m)) if stack_needs_topic(goal_names) else None
    )
    hard_mask = tuple(GOAL_REGISTRY[n].hard for n in goal_names)
    allow_inter = allows_inter_broker(goal_names)
    pp = ProposalParams(
        p_real=p_real,
        b_real=b_real,
        p_leadership=opts.p_leadership,
        p_disk=opts.p_disk,
        p_biased_dest=opts.p_biased_dest,
        p_evac=opts.p_evac,
        target_rack=bool(RACK_TARGET_GOALS & set(goal_names)),
        allow_inter=allow_inter,
        target_capacity=bool(CAPACITY_GOALS & set(goal_names)),
        cap_thresholds=tuple(cfg.capacity_threshold),
    )
    state = init_search_state(m, cfg, goal_names, group=group, n_chains=opts.n_chains)
    gen = torch.Generator(device=m.device)
    gen.manual_seed(opts.seed)
    n = max(opts.n_steps, 1)
    decay = (opts.t1 / opts.t0) ** (1.0 / max(n - 1, 1))
    step_kw = dict(
        m=m, pp=pp,
        hard_arr=torch.tensor(hard_mask, device=m.device),
        weights=soft_weights(hard_mask, m.device),
        moves_per_step=max(opts.moves_per_step, 1),
        scorer=make_move_scorer(m, goal_names, cfg),
        group=group,
    )
    for t in range(opts.n_steps):
        _anneal_step(state, gen, opts.t0 * decay**t, evac_idx, n_evac, **step_kw)

    best = best_chain_index(state.cost_vec.cpu().numpy())
    result_model = with_placement(m, state, best)
    return AnnealResult(
        model=result_model,
        stack_before=stack_before,
        stack_after=evaluate_stack(result_model, cfg, goal_names),
        n_accepted=int(state.n_accepted[best]),
        n_chains=opts.n_chains,
        n_steps=opts.n_steps,
        best_chain=best,
        n_prop_kind=tuple(state.n_prop_kind[best].tolist()),
        n_acc_kind=tuple(state.n_acc_kind[best].tolist()),
    )
