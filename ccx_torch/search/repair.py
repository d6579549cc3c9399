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

``topic_rebalance`` sheds TopicReplicaDistribution's over-band (topic,
broker) cells the same way, for a soft goal; it runs on the host in numpy
(one copy of the placement each way).
"""

from __future__ import annotations

import numpy as np
import torch

from ccx_torch.common.resources import NUM_RESOURCES, Resource
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


def _group_ranks(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rank, group_start) per element of a SORTED key array: rank counts
    earlier elements with the same key; group_start indexes each element's
    first group member."""
    idx = np.arange(keys.size)
    seg = np.r_[True, keys[1:] != keys[:-1]] if keys.size else np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(seg, idx, 0))
    return idx - start, start


def topic_rebalance(
    m: TensorClusterModel,
    cfg: GoalConfig,
    max_sweeps: int = 1024,
    rounds_per_sweep: int = 16,
    seed: int = 23,
    move_leaders: bool = True,
) -> tuple[TensorClusterModel, int]:
    """Targeted TopicReplicaDistribution sweep: shed (topic, broker) cells
    above their per-topic band by relocating replicas to brokers with topic
    room, never violating a hard constraint.

    Random proposals almost never align a drawn partition's topic with a
    topic-underloaded destination, so this pass enumerates the offending
    cells directly. It serves a soft goal, so the optimizer re-polishes the
    result and adopts it only on a lexicographic improvement.

    Aggregates ((topic, broker) counts, role-resolved broker loads, replica
    counts, per-disk loads) are built once and kept per accepted move. Per
    sweep: one replica per over cell (one per partition) is routed to its
    topic's best destination: live band room, rack-distinct, not already
    hosting, alive and receiving, within effective capacity on every
    resource, under the replica-count band and cap, and utilization below
    0.9. Destinations take batched intake per round under cumulative
    band-room, replica-count and capacity checks. The loop stops after a
    sweep that moved nothing, or after ``max_sweeps``.

    Followers are preferred; with ``move_leaders`` a leader-held over cell
    is shed by first handing leadership to a co-replica whose broker may
    lead, absorbs the leader-load delta within capacity and (for
    MinTopicLeaders topics) leaves the source its minimum of leaders.
    Randomness comes from ``np.random.default_rng(seed)``, so a seed gives
    the same placement as the JAX package's ``topic_rebalance``. Returns
    (model, moves applied)."""
    a = m.assignment.cpu().numpy().copy()
    dsk = m.replica_disk.cpu().numpy().copy()
    pvalid = m.partition_valid.cpu().numpy()
    topic = m.partition_topic.cpu().numpy()
    alive = m.broker_ok.cpu().numpy()
    recv_ok = alive & ~m.broker_excl_replicas.cpu().numpy()
    imm = m.partition_immovable.cpu().numpy()
    rack = m.broker_rack.cpu().numpy()
    lslot = m.leader_slot.cpu().numpy().copy()
    T, B, P, R = m.num_topics, m.B, m.P, m.R

    thr = cfg.topic_replica_balance_threshold
    capthr = np.asarray(cfg.capacity_threshold)
    cap_eff = m.broker_capacity.cpu().numpy() * capthr[:, None]    # [RES, B]
    cap_eff = np.where(cap_eff > 0, cap_eff, np.inf)
    lead_load = m.leader_load.cpu().numpy()                        # [RES, P]
    foll_load = m.follower_load.cpu().numpy()
    rng = np.random.default_rng(seed)
    total_moved = 0

    is_l = np.zeros((P, R), bool)
    is_l[np.arange(P), np.clip(lslot, 0, R - 1)] = True
    # role-resolved slot loads; a leadership transfer updates is_l and
    # slot_load in place for its two slots, so nothing derived from them is
    # cached across moves
    tmat = np.repeat(topic, R).reshape(P, R)
    slot_load = np.where(is_l[None], lead_load[:, :, None], foll_load[:, :, None])  # [RES, P, R]
    D = m.D
    disk_alive = m.disk_alive.cpu().numpy()                        # [B, D]

    # aggregates kept per accepted move; per-topic totals (so the band
    # uppers and the replica-count cap) do not change under moves
    valid = (a >= 0) & pvalid[:, None]
    counts = np.zeros((T, B), np.int64)
    np.add.at(counts, (tmat[valid], a[valid]), 1)
    counts[:, ~alive] = 0
    tot = counts.sum(1).astype(np.float64)
    avg = tot / max(int(alive.sum()), 1)
    upper = np.ceil(avg * thr)

    bload = np.zeros((NUM_RESOURCES, B))
    for res in range(NUM_RESOURCES):
        np.add.at(bload[res], a[valid], slot_load[res][valid])
    dload = np.zeros((B, D))
    dvalid = valid & (dsk >= 0)
    np.add.at(
        dload,
        (a[dvalid], np.clip(dsk, 0, D - 1)[dvalid]),
        slot_load[int(Resource.DISK)][dvalid],
    )
    rc = np.bincount(a[valid], minlength=B).astype(np.int64)
    rc_avg = rc[alive].sum() / max(int(alive.sum()), 1)
    rc_cap = min(
        int(np.floor(rc_avg * cfg.replica_balance_threshold)),
        int(cfg.max_replicas_per_broker),
    )

    excl_lead = m.broker_excl_leadership.cpu().numpy()
    tmin = m.topic_min_leaders.cpu().numpy()
    need_tlc = move_leaders and bool(tmin.any())
    if need_tlc:
        tlc = np.zeros((T, B), np.int64)
        lv = valid & is_l
        np.add.at(tlc, (tmat[lv], a[lv]), 1)
        k_min = int(cfg.min_topic_leaders_per_broker)

    for _ in range(max_sweeps):
        util = np.max(bload / cap_eff, axis=0)
        over = counts > upper[:, None]
        on_over = valid & over[tmat, np.clip(a, 0, B - 1)] & ~imm[:, None]
        cand_f = on_over & ~is_l
        pf, rf = np.nonzero(cand_f)
        if move_leaders:
            # leaders need a co-replica to hand leadership to
            cand_l = on_over & is_l & (valid.sum(1) >= 2)[:, None]
            pl, rl = np.nonzero(cand_l)
        else:
            pl = rl = np.zeros(0, np.int64)
        if pf.size + pl.size == 0:
            break
        # one candidate per partition and per (topic, source broker) cell,
        # followers first; the permutations keep cell picks fair
        of = rng.permutation(pf.size)
        ol = rng.permutation(pl.size)
        ps = np.concatenate([pf[of], pl[ol]])
        rs = np.concatenate([rf[of], rl[ol]])
        # np.unique returns first occurrences in value order; np.sort
        # restores array order, so followers stay ahead of leaders
        fp = np.sort(np.unique(ps, return_index=True)[1])
        ps, rs = ps[fp], rs[fp]
        cell = topic[ps].astype(np.int64) * B + a[ps, rs]
        fc = np.sort(np.unique(cell, return_index=True)[1])
        ps, rs = ps[fc], rs[fc]
        ts = topic[ps]
        # occurrence rank within the topic: one topic's candidates fan out
        # over different destinations in the same round
        t_order = np.argsort(ts, kind="stable")
        t_inv = np.empty_like(t_order)
        t_inv[t_order] = np.arange(ts.size)
        occ = _group_ranks(ts[t_order])[0][t_inv]
        lead_row = is_l[ps, rs]
        # new-leader slot: the first other valid slot whose broker may lead
        ov = valid[ps].copy()
        ov[np.arange(ps.size), rs] = False
        ab = np.clip(a[ps], 0, B - 1)
        elig = ov & alive[ab] & ~excl_lead[ab]
        nl = np.where(elig.any(axis=1), np.argmax(elig, axis=1), np.argmax(ov, axis=1))
        b2 = np.where(lead_row, a[ps, nl], -1)

        room = np.where(recv_ok[None, :], np.maximum(upper[:, None] - counts, 0), 0)
        dest_ok_b = (
            (rc[None, :] < rc_cap)
            & (util[None, :] < 0.9)
            & (room > 0)
            & disk_alive.any(axis=1)[None, :]
        )
        dest_score = np.where(dest_ok_b, room + (0.9 - util[None, :]), -np.inf)
        # top destinations per topic, W wide; each topic starts at its own
        # rotation offset so topics spread over different brokers
        width = min(B, max(rounds_per_sweep, 64))
        top_dest = np.argsort(-dest_score, axis=1)[:, :width]
        moved = 0
        kf = kl = 0
        for k in range(min(rounds_per_sweep, top_dest.shape[1])):
            if ps.size == 0:
                break
            have_f = bool((~lead_row).any())
            have_l = move_leaders and bool(lead_row.any())
            if not (have_f or have_l):
                break
            # follower and leader rounds alternate; a leader round draws a
            # random broker bipartition, so its destinations and new-leader
            # brokers are disjoint and the new leader's capacity check
            # stays exact under batched intake
            lead_round = have_l and (not have_f or k % 2 == 1)
            if lead_round:
                rank_k, kl = kl, kl + 1
            else:
                rank_k, kf = kf, kf + 1
            dest = top_dest[ts, (rank_k + ts + occ) % top_dest.shape[1]]
            ok = np.isfinite(dest_score[ts, dest])
            ok &= lead_row if lead_round else ~lead_row
            ok &= (upper[ts] - counts[ts, dest]) > 0
            ok &= rc[dest] < rc_cap
            ok &= ~(a[ps] == dest[:, None]).any(axis=1)
            rrows = np.where(a[ps] >= 0, rack[np.clip(a[ps], 0, B - 1)], -1)
            rrows[np.arange(ps.size), rs] = -1
            ok &= ~(rrows == rack[dest][:, None]).any(axis=1)
            ok &= np.all(bload[:, dest] + foll_load[:, ps] <= cap_eff[:, dest], axis=0)
            if lead_round:
                b2c = np.clip(b2, 0, B - 1)
                delta = lead_load[:, ps] - foll_load[:, ps]
                b2_ok = (
                    alive[b2c]
                    & ~excl_lead[b2c]
                    & np.all(bload[:, b2c] + delta <= cap_eff[:, b2c], axis=0)
                )
                if need_tlc:
                    srcb = np.clip(a[ps, rs], 0, B - 1)
                    b2_ok &= ~tmin[ts] | (tlc[ts, srcb] - 1 >= k_min)
                coin = rng.integers(0, 2, B).astype(bool)
                ok &= b2_ok & ~coin[dest] & coin[b2c]
            if ok.any():
                oi = np.nonzero(ok)[0]
                if lead_round:
                    # one leadership transfer per new-leader broker per round
                    _, fb2 = np.unique(b2[oi], return_index=True)
                    oi = oi[np.sort(fb2)]
                if oi.size == 0:
                    continue
                # batched intake: within each destination's group, sorted by
                # (dest, topic), a row is taken only while the band room, the
                # replica-count cap and every resource capacity still hold
                # with all earlier rows of the group counted (rows later
                # rejected count too, which only under-accepts)
                order = np.lexsort((ts[oi], dest[oi]))
                ois = oi[order]
                d_s, t_s = dest[ois], ts[ois]
                rank_d, start_d = _group_ranks(d_s)
                rank_td, _ = _group_ranks(d_s.astype(np.int64) * T + t_s)
                load_s = foll_load[:, ps[ois]]               # [RES, n]
                cum = np.cumsum(load_s, axis=1)
                grp_base = (cum - load_s)[:, start_d]
                cum_within = cum - grp_base                  # incl. self
                take = rank_td < (upper[t_s] - counts[t_s, d_s])
                take &= rank_d < (rc_cap - rc[d_s])
                take &= np.all(bload[:, d_s] + cum_within <= cap_eff[:, d_s], axis=0)
                oi, rank_acc = ois[take], rank_d[take]
                if oi.size == 0:
                    continue
                ai, ri, di = ps[oi], rs[oi], dest[oi]
                lr = lead_row[oi]
                src = a[ai, ri]
                old_d = dsk[ai, ri]
                # the source sheds its current role-resolved load, the
                # destination gains follower load, and a leader row's new
                # leader gains the (leader - follower) delta
                cur = slot_load[:, ai, ri]          # [RES, n]
                for res in range(NUM_RESOURCES):
                    np.subtract.at(bload[res], src, cur[res])
                    np.add.at(bload[res], di, foll_load[res, ai])
                if lr.any():
                    ail, nll = ai[lr], nl[oi][lr]
                    b2l = a[ail, nll]
                    for res in range(NUM_RESOURCES):
                        np.add.at(bload[res], b2l, lead_load[res, ail] - foll_load[res, ail])
                    d2 = dsk[ail, nll]
                    np.add.at(
                        dload,
                        (b2l, np.clip(d2, 0, D - 1)),
                        np.where(
                            d2 >= 0,
                            lead_load[int(Resource.DISK), ail] - foll_load[int(Resource.DISK), ail],
                            0.0,
                        ),
                    )
                    if need_tlc:
                        np.subtract.at(tlc, (topic[ail], a[ail, ri[lr]]), 1)
                        np.add.at(tlc, (topic[ail], b2l), 1)
                    lslot[ail] = nll
                    is_l[ail, ri[lr]] = False
                    is_l[ail, nll] = True
                    for res in range(NUM_RESOURCES):
                        slot_load[res, ail, ri[lr]] = foll_load[res, ail]
                        slot_load[res, ail, nll] = lead_load[res, ail]
                a[ai, ri] = di
                np.subtract.at(
                    dload,
                    (src, np.clip(old_d, 0, D - 1)),
                    np.where(old_d >= 0, cur[int(Resource.DISK)], 0.0),
                )
                # the k-th intake of a destination this round lands on its
                # k-th least-loaded alive disk
                dchoice = np.where(disk_alive[di], dload[di], np.inf)
                ranked = np.argsort(dchoice, axis=1)
                n_alive_d = np.maximum(disk_alive[di].sum(axis=1), 1)
                best_d = ranked[np.arange(di.size), rank_acc % n_alive_d].astype(dsk.dtype)
                dsk[ai, ri] = best_d
                np.add.at(dload, (di, best_d), foll_load[int(Resource.DISK), ai])
                np.subtract.at(counts, (ts[oi], src), 1)
                np.add.at(counts, (ts[oi], di), 1)
                np.subtract.at(rc, src, 1)
                np.add.at(rc, di, 1)
                moved += oi.size
                keep = np.ones(ps.size, bool)
                keep[oi] = False
                ps, rs, ts = ps[keep], rs[keep], ts[keep]
                lead_row, b2, nl = lead_row[keep], b2[keep], nl[keep]
                occ = occ[keep]
            # candidates that found no destination retry the next-ranked
            # destination in the following round
        total_moved += moved
        if moved == 0:
            break

    if total_moved == 0:
        return m, 0

    def back(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(x).to(device=like.device, dtype=like.dtype)

    out = m.replace(
        assignment=back(a, m.assignment),
        replica_disk=back(dsk, m.replica_disk),
        leader_slot=back(lslot, m.leader_slot),
    )
    return out, total_moved


def finalize_preferred_leaders(model: TensorClusterModel, cfg: GoalConfig, goal_names, stack_after,
                               reevaluate: bool = True):
    """The pipeline's last stage: canonicalize preferred leaders and
    re-evaluate the stack when anything changed. Returns (model,
    stack_after, n_canonicalized); a no-op for stacks without
    PreferredLeaderElectionGoal. ``reevaluate=False`` (the warm pipeline,
    which evaluates the final placement once anyway) returns
    ``stack_after=None`` instead of re-evaluating when anything changed."""
    if "PreferredLeaderElectionGoal" not in goal_names:
        return model, stack_after, 0
    model, n = canonicalize_preferred_leaders(model)
    if n:
        if not reevaluate:
            return model, None, n
        from ccx_torch.goals.stack import evaluate_stack

        stack_after = evaluate_stack(model, cfg, goal_names)
    return model, stack_after, n
