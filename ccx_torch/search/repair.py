"""Vectorized hard-goal repair sweeps and preferred-leader canonicalization.

The reference optimizes goals sequentially: ``RackAwareGoal.optimize``
relocates every violating replica before any balancing goal runs. Random
search finds those repairs one accepted move at a time, which is hopeless
with thousands of violations. One sweep here selects, for every violating
partition at once, the offending slot (a replica on a dead broker or disk,
a duplicate broker, a rack duplicate, a replica on an over-capacity broker)
and a destination on an unused rack with the most headroom
(noise-perturbed so simultaneous choosers spread out), then applies all
moves with one scatter. ``hard_repair`` loops sweeps until no offender is
left or the capacity shedding stops making progress.
"""

from __future__ import annotations

import torch

from ccx_torch.goals.base import GoalConfig
from ccx_torch.model.aggregates import broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.search.annealer import (
    CAPACITY_GOALS,
    RACK_TARGET_GOALS,
    _evac_bucket,
    allows_inter_broker,
    effective_capacity,
)


def _pairs_before(x: torch.Tensor) -> torch.Tensor:
    """bool[n, R] — slot j equals some earlier slot k < j of its row."""
    R = x.shape[1]
    i = torch.arange(R, device=x.device)
    return ((x[:, :, None] == x[:, None, :]) & (i[:, None] > i[None, :])).any(2)


def _sweep_impl(
    m: TensorClusterModel,
    assignment: torch.Tensor,    # int32[P, R]
    leader_slot: torch.Tensor,   # int32[P]
    replica_disk: torch.Tensor,  # int32[P, R]
    gen: torch.Generator,
    *,
    target_rack: bool,
    target_capacity: bool,
    cfg: GoalConfig,
    nk: int,
):
    """One repair sweep. Returns (assignment, replica_disk, n_moved,
    n_over_brokers, n_structural_offenders); the counts are 0-d tensors."""
    P, R, B, K = m.P, m.R, m.B, m.num_racks
    dev = m.device
    slots = torch.arange(R, device=dev)
    pvalid = m.partition_valid
    valid = (assignment >= 0) & pvalid[:, None]
    safe_b = assignment.clamp(0, B - 1).long()
    alive_b = m.broker_ok
    recv_ok = alive_b & ~m.broker_excl_replicas
    agg = broker_aggregates(
        m.replace(assignment=assignment, leader_slot=leader_slot, replica_disk=replica_disk)
    )

    # --- offender selection --------------------------------------------------
    on_dead = valid & ~alive_b[safe_b]
    safe_d = replica_disk.clamp(0, m.D - 1).long()
    on_dead_disk = valid & (replica_disk >= 0) & ~m.disk_alive[safe_b, safe_d]
    neg = -1 - slots[None, :].int()
    dup_broker = _pairs_before(torch.where(valid, assignment, neg))
    racks = torch.where(valid, m.broker_rack[safe_b], neg)
    dup_rack = _pairs_before(racks)

    # capacity offenders: replicas on brokers above effective capacity,
    # selected with probability ~ the broker's excess fraction so a sweep
    # sheds roughly the overflow
    cap_eff = effective_capacity(m, cfg.capacity_threshold)
    util = torch.where(
        cap_eff > 0, agg.broker_load / torch.where(cap_eff > 0, cap_eff, 1.0), 0.0
    ).amax(0)                                                   # [B]
    if target_capacity:
        over_b = alive_b & (util > 1.0)
        exc_frac = torch.where(over_b, (1.0 - 1.0 / util.clamp(min=1e-9)).clamp(0.0, 1.0), 0.0)
        # shed at most roughly what the under-capacity brokers can absorb
        excess_rel = torch.where(over_b, util - 1.0, 0.0).sum()
        head_rel = torch.where(alive_b & ~over_b, (1.0 - util).clamp(min=0), 0.0).sum()
        absorb = (head_rel / excess_rel.clamp(min=1e-9)).clamp(0.0, 1.0)
        u_cap = torch.rand(P, R, generator=gen, device=dev)
        on_over_b = valid & over_b[safe_b]
        on_over = on_over_b & (u_cap < 1.5 * absorb * exc_frac[safe_b])
        # the lowest-draw replica on every over-capacity broker is always
        # selected, so every sweep makes progress until the overload clears
        u_rank = torch.where(on_over_b, u_cap, float("inf"))
        min_u = torch.full((B,), float("inf"), device=dev).scatter_reduce(
            0, safe_b.reshape(-1), u_rank.reshape(-1), reduce="amin"
        )
        on_over = on_over | (on_over_b & (u_rank <= min_u[safe_b]))
    else:
        over_b = torch.zeros_like(alive_b)
        on_over = torch.zeros_like(valid)

    score = (
        3.0 * on_dead + 2.5 * on_dead_disk + 2.0 * dup_broker
        + (1.0 * dup_rack if target_rack else 0.0) + 0.75 * on_over
    )
    slot = score.argmax(1)                                       # [P]
    score_max = score.amax(1)

    def at_slot(x):
        return x.gather(1, slot[:, None])[:, 0]

    off_is_disk_only = (
        at_slot(on_dead_disk) & ~at_slot(on_dead) & ~at_slot(dup_broker) & ~at_slot(on_over)
    )
    if target_rack:
        off_is_disk_only &= ~at_slot(dup_rack)

    # --- bounded offender set, most severe first -----------------------------
    eligible = pvalid & (score_max > 0.0)
    order = torch.argsort(
        torch.where(eligible, -score_max, float("inf")), stable=True
    )[:nk]
    n_sel = order.shape[0]
    sel_ok = eligible[order]
    slot_s = slot[order]
    valid_s = valid[order]
    safe_b_s = safe_b[order]
    racks_s = racks[order]
    rows = torch.arange(n_sel, device=dev)[:, None].expand(n_sel, R)

    # brokers and racks already hosting the partition (except the offender)
    keep = valid_s & (slots[None, :] != slot_s[:, None])
    in_part = torch.zeros(n_sel, B, dtype=torch.int32, device=dev).index_put_(
        (rows, safe_b_s), keep.int(), accumulate=True
    ) > 0
    used_rack = torch.zeros(n_sel, K, dtype=torch.int32, device=dev).index_put_(
        (rows, racks_s.clamp(0, K - 1).long()), (keep & (racks_s >= 0)).int(), accumulate=True
    ) > 0

    # prefer destinations under effective capacity, fall back to any alive
    # receiver; prefer a rack the partition does not use
    allowed_any = recv_ok[None, :] & ~in_part
    allowed_cap = allowed_any & ~over_b[None, :]
    allowed_base = torch.where(allowed_cap.any(1, keepdim=True), allowed_cap, allowed_any)
    rack_free = ~used_rack[:, m.broker_rack.clamp(0, K - 1).long()]
    allowed_rack = allowed_base & rack_free
    allowed = torch.where(allowed_rack.any(1, keepdim=True), allowed_rack, allowed_base)

    # headroom across every resource plus replica-count headroom, noise-spread
    count_head = 1.0 - agg.replica_count / agg.replica_count.max().clamp(min=1).float()
    base_score = (1.0 - util) + 0.5 * count_head
    noise = torch.rand(n_sel, B, generator=gen, device=dev) * 0.35
    dest_score = torch.where(allowed, base_score[None, :] + noise, float("-inf"))
    dest = dest_score.argmax(1).int()
    dest_found = torch.isfinite(dest_score.amax(1))

    # --- disk-only offenders move to the least-loaded alive disk ------------
    cur_b = safe_b_s.gather(1, slot_s[:, None])[:, 0]
    disk_util = agg.disk_load[cur_b] / m.disk_capacity[cur_b].clamp(min=1e-9)
    disk_score = torch.where(m.disk_alive[cur_b], -disk_util, float("-inf"))
    best_disk = disk_score.argmax(1).int()
    disk_found = torch.isfinite(disk_score.amax(1))

    # --- apply ---------------------------------------------------------------
    disk_only_s = off_is_disk_only[order]
    do_move = sel_ok & dest_found & ~disk_only_s
    do_disk = sel_ok & disk_only_s & disk_found
    new_assignment = assignment.clone()
    new_replica_disk = replica_disk.clone()
    cur_a = new_assignment[order, slot_s]
    cur_d = new_replica_disk[order, slot_s]
    new_assignment[order, slot_s] = torch.where(do_move, dest, cur_a)
    new_replica_disk[order, slot_s] = torch.where(
        do_move, 0, torch.where(do_disk, best_disk, cur_d)
    )
    n_moved = do_move.sum() + do_disk.sum()
    n_over_b = over_b.sum()
    # fixable structural offenders present before this sweep (rack
    # duplicates only while the row is rack-feasible)
    rack_has_recv = torch.zeros(K, dtype=torch.int32, device=dev).index_put_(
        (m.broker_rack.clamp(0, K - 1).long(),), (recv_ok & m.broker_valid).int(),
        accumulate=True,
    ) > 0
    rack_fixable = valid.sum(1) <= rack_has_recv.sum()
    structural = on_dead | on_dead_disk | dup_broker
    if target_rack:
        structural = structural | (dup_rack & rack_fixable[:, None])
    n_struct = (pvalid & structural.any(1)).sum()
    return new_assignment, new_replica_disk, n_moved, n_over_b, n_struct


def _leader_fix(m: TensorClusterModel, assignment: torch.Tensor, leader_slot: torch.Tensor) -> torch.Tensor:
    """Point leaders at an alive, non-excluded replica where possible:
    keep the current leader when it may lead, else the first slot that may."""
    valid = (assignment >= 0) & m.partition_valid[:, None]
    safe_b = assignment.clamp(0, m.B - 1).long()
    lead_ok = (m.broker_ok & ~m.broker_excl_leadership)[safe_b] & valid
    cur_ok = lead_ok.gather(1, leader_slot.long()[:, None])[:, 0]
    first_ok = lead_ok.int().argmax(1).int()
    return torch.where(cur_ok | ~lead_ok.any(1), leader_slot, first_ok)


def _repair_nk(m: TensorClusterModel, nk: int | None) -> int:
    # per-sweep offender bound: [nk, B] scoring matrices instead of [P, B];
    # the sweep loop retries while offenders remain
    return _evac_bucket(m.P) if nk is None else nk


def hard_repair(
    m: TensorClusterModel,
    cfg: GoalConfig,
    goal_names: tuple[str, ...],
    max_sweeps: int = 8,
    seed: int = 17,
    nk: int | None = None,
) -> tuple[TensorClusterModel, int]:
    """Sweep until no targetable hard offenders remain (or ``max_sweeps``).

    Returns (repaired model, total moves). Only stacks that allow
    inter-broker movement get placement sweeps; leader placement is fixed
    in all cases. The loop stops after a sweep that moved nothing, or when
    capacity shedding stops reducing the over-capacity broker count while no
    structural offender (dead broker or disk, duplicate, rack) remained."""
    assignment, leader_slot, replica_disk = m.assignment, m.leader_slot, m.replica_disk
    total = 0
    if allows_inter_broker(goal_names):
        gen = torch.Generator(device=m.device)
        gen.manual_seed(seed)
        kw = dict(
            target_rack=bool(RACK_TARGET_GOALS & set(goal_names)),
            target_capacity=bool(CAPACITY_GOALS & set(goal_names)),
            cfg=cfg, nk=_repair_nk(m, nk),
        )
        prev_over = None
        for _ in range(max_sweeps):
            assignment, replica_disk, n, n_over, n_struct = _sweep_impl(
                m, assignment, leader_slot, replica_disk, gen, **kw
            )
            n, n_over, n_struct = (int(x) for x in torch.stack([n, n_over, n_struct]).tolist())
            total += n
            if n == 0:
                break
            if n_struct == 0 and prev_over is not None and 0 < prev_over <= n_over:
                break
            prev_over = n_over
    leader_slot = _leader_fix(m, assignment, leader_slot)
    return (
        m.replace(assignment=assignment, leader_slot=leader_slot, replica_disk=replica_disk),
        total,
    )


def canonicalize_preferred_leaders(m: TensorClusterModel) -> tuple[TensorClusterModel, int]:
    """Reorder replica lists so every chosen leader sits in the preferred
    slot 0 — the reference's proposals carry leadership as replica-list
    order. Swapping two slots of a row relabels positions only, so every
    goal except PreferredLeaderElection is unchanged and the pass ends with
    zero fixable PLE violations. Immovable partitions are never touched.
    Returns (model, partitions reordered)."""
    a, lead = m.assignment, m.leader_slot
    b0 = a[:, 0].clamp(0, m.B - 1).long()
    eligible = (
        m.partition_valid & (a[:, 0] >= 0) & (m.broker_ok & ~m.broker_excl_leadership)[b0]
    )
    idx = torch.nonzero(eligible & (lead != 0) & ~m.partition_immovable)[:, 0]
    n = idx.numel()
    if n == 0:
        return m, 0
    j = lead[idx].long()

    def swap0(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        first, other = x[idx, 0], x[idx, j]
        out[idx, 0] = other
        out[idx, j] = first
        return out

    new_lead = lead.clone()
    new_lead[idx] = 0
    return (
        m.replace(assignment=swap0(a), leader_slot=new_lead, replica_disk=swap0(m.replica_disk)),
        n,
    )


def finalize_preferred_leaders(model: TensorClusterModel, cfg: GoalConfig, goal_names, stack_after):
    """The pipeline's last stage: canonicalize preferred leaders and
    re-evaluate the stack when anything changed. Returns (model,
    stack_after, n_canonicalized); a no-op for stacks without
    PreferredLeaderElectionGoal."""
    if "PreferredLeaderElectionGoal" not in goal_names:
        return model, stack_after, 0
    model, n = canonicalize_preferred_leaders(model)
    if n:
        from ccx_torch.goals.stack import evaluate_stack

        stack_after = evaluate_stack(model, cfg, goal_names)
    return model, stack_after, n
