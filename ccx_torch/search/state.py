"""Per-chain search state with O(R)-per-move incremental cost maintenance.

A move changes one partition's contribution, so search keeps everything it
scores incrementally instead of re-running the O(P*R) aggregate pass:

* the [B]-level aggregates (broker_load, replica/leader counts, potential
  nw-out, leader bytes-in, disk_load) — O(R) scatter-adds per move; the
  aggregate goals re-score them in O(B) per candidate;
* the two topic goals as exact scalar accumulators; the one topic row a move
  touches is derived on demand from a topic-grouped mirror of the placement
  (``grouped_placement``) and re-scored with ``ccx_torch.goals.topic_terms``;
* the per-partition goal sums (``ccx_torch.goals.partition_terms``) as row
  deltas;
* the full per-goal cost vector, assembled exactly per candidate so
  acceptance compares lexicographically.

Every accumulator except the broker-load-style float sums is integer-valued
and exact in float32; the float goals are recomputed from the aggregates at
every move, never accumulated.

Two-partition swaps (``make_swap_scorer``/``apply_swap``) compose both
partitions' deltas exactly; a single move is a swap whose second partition
is inert (rows -1, weight 0).

Layout: a ``SearchState`` carries a leading chain axis C on every field (the
annealer's chains; the greedy descent runs one chain). Candidate moves carry
a leading axis K and name the chain they are scored against (``chain``,
int64[K]). The state is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ccx_torch.common.resources import NUM_RESOURCES, Resource
from ccx_torch.goals import partition_terms as pt
from ccx_torch.goals import topic_terms as tt
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.model.aggregates import BROKER_FIELDS, BrokerAggregates, broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel

#: per-move-type proposal/acceptance counters
MOVE_KIND_NAMES = ("single", "replicaSwap", "leadershipSwap")
NUM_MOVE_KINDS = len(MOVE_KIND_NAMES)
KIND_SINGLE = 0
KIND_REPLICA_SWAP = 1
KIND_LEADERSHIP_SWAP = 2


@dataclasses.dataclass
class SearchState:
    """Dynamic state of C chains. The static cluster attributes live in the
    model the search started from; only placement and the bookkeeping
    derived from it change."""

    assignment: torch.Tensor    # int32[C, P, R]
    leader_slot: torch.Tensor   # int32[C, P]
    replica_disk: torch.Tensor  # int32[C, P, R]
    agg: BrokerAggregates       # [C, ...] broker fields; topic matrices unused
    part_sums: torch.Tensor     # float32[C, len(PARTITION_GOALS)] (exact ints)
    topic_totals: torch.Tensor  # float32[C, T] alive-broker replica totals
    mtl_sum: torch.Tensor       # float32[C] raw MinTopicLeaders deficit
    trd_sum: torch.Tensor       # float32[C] raw TopicReplicaDistribution pen
    cost_vec: torch.Tensor      # float32[C, G] per-goal costs, priority order
    n_accepted: torch.Tensor    # int32[C]
    hard_mask: tuple[bool, ...]
    #: topic-grouped mirror of the placement, present iff the stack scores
    #: topic goals
    grouped_assign: torch.Tensor | None  # int32[C, T, max_pt, R]
    grouped_leader: torch.Tensor | None  # int32[C, T, max_pt]
    n_prop_kind: torch.Tensor   # int32[C, NUM_MOVE_KINDS]
    n_acc_kind: torch.Tensor    # int32[C, NUM_MOVE_KINDS]

    @property
    def n_chains(self) -> int:
        return self.assignment.shape[0]


@dataclasses.dataclass
class MoveDelta:
    """Everything needed to accept K scored candidate moves exactly."""

    cost_vec: torch.Tensor   # float32[K, G] candidate states' cost vectors
    part_sums: torch.Tensor  # float32[K, 4] candidate partition-goal sums
    d_mtl: torch.Tensor      # float32[K] MinTopicLeaders deficit delta
    d_trd: torch.Tensor      # float32[K] TopicReplicaDistribution pen delta
    d_total: torch.Tensor    # float32[K] topic(p) alive-replica-total delta


@dataclasses.dataclass
class SwapDelta(MoveDelta):
    """MoveDelta of a two-partition swap: the combined accumulator deltas
    plus the second topic's total delta (0 when both share a topic, whose
    ``d_total`` then carries both)."""

    d_total2: torch.Tensor   # float32[K] topic(p2) alive-replica-total delta


@dataclasses.dataclass
class PartitionView:
    """Every per-partition datum a move needs, for K partitions."""

    pvalid: torch.Tensor     # bool[K]
    immovable: torch.Tensor  # bool[K]
    topic: torch.Tensor      # int32[K]
    lead_load: torch.Tensor  # float32[K, RES] leader-role load
    foll_load: torch.Tensor  # float32[K, RES]
    assign: torch.Tensor     # int32[K, R] current row in the search state
    leader: torch.Tensor     # int32[K]
    disk: torch.Tensor       # int32[K, R]


def gather_views(
    state: SearchState, m: TensorClusterModel, chain: torch.Tensor, ps: torch.Tensor
) -> PartitionView:
    """Partition ``ps[k]``'s view in chain ``chain[k]``."""
    c, p = chain.long(), ps.long()
    return PartitionView(
        pvalid=m.partition_valid[p],
        immovable=m.partition_immovable[p],
        topic=m.partition_topic[p],
        lead_load=m.leader_load[:, p].T,
        foll_load=m.follower_load[:, p].T,
        assign=state.assignment[c, p],
        leader=state.leader_slot[c, p],
        disk=state.replica_disk[c, p],
    )


def cat_views(*views: PartitionView) -> PartitionView:
    """The views stacked along their leading axis."""
    return PartitionView(**{
        f.name: torch.cat([getattr(v, f.name) for v in views])
        for f in dataclasses.fields(PartitionView)
    })


def view_rows(view: PartitionView, idx: torch.Tensor) -> PartitionView:
    """Rows ``idx`` of a stacked view."""
    return PartitionView(**{
        f.name: getattr(view, f.name)[idx] for f in dataclasses.fields(PartitionView)
    })


def bump_kind_counters(
    state: SearchState,
    chain: torch.Tensor,
    kind: int | torch.Tensor,
    proposed: torch.Tensor | int,
    accepted: torch.Tensor,
) -> None:
    """Add to the per-move-kind proposal/acceptance counters of ``chain``
    (``kind`` one KIND_* for all, or one per entry)."""
    c = chain.long()
    k = kind.long() if torch.is_tensor(kind) else torch.full_like(c, kind)
    prop = proposed if torch.is_tensor(proposed) else torch.full_like(c, proposed, dtype=torch.int32)
    state.n_prop_kind.index_put_((c, k), prop, accumulate=True)
    state.n_acc_kind.index_put_((c, k), accepted.int(), accumulate=True)


# --------------------------------------------------------------------------
# Broker band pressure (the sampling weights of the coupled swap draws)
# --------------------------------------------------------------------------

#: static resource weights of the combined per-replica usage scalar
#: (CPU, NW_IN, NW_OUT, DISK)
USAGE_WEIGHTS = (0.3, 0.0, 1.0, 0.0)


def usage_weights(device) -> torch.Tensor:
    return torch.tensor(USAGE_WEIGHTS, dtype=torch.float32, device=device)


@dataclasses.dataclass
class BrokerPressure:
    """Per-broker over/under band-deviation scores (leading dims of the
    aggregates, then [B])."""

    usage_over: torch.Tensor
    usage_under: torch.Tensor
    lead_over: torch.Tensor
    lead_under: torch.Tensor
    lbi_over: torch.Tensor
    lbi_under: torch.Tensor


def _band_pressure(values, alive, avg, threshold):
    """(over, under) hinge distances outside the goal band plus a 0.1x
    toward-average term inside it, normalized by avg."""
    a = avg[..., None]
    safe_avg = a.clamp(min=1e-9)
    over = (values - a * threshold).clamp(min=0) + 0.1 * (values - a).clamp(min=0)
    under = (a * (2.0 - threshold) - values).clamp(min=0) + 0.1 * (a - values).clamp(min=0)
    return (
        torch.where(alive, over / safe_avg, 0.0),
        torch.where(alive, under / safe_avg, 0.0),
    )


def broker_pressure(
    m: TensorClusterModel, agg: BrokerAggregates, cfg: GoalConfig
) -> BrokerPressure:
    """Live per-broker pressure from the incrementally-kept aggregates."""
    alive = m.broker_ok
    lead_shape = agg.leader_count.shape
    usage_over = torch.zeros(lead_shape, dtype=torch.float32, device=m.device)
    usage_under = torch.zeros_like(usage_over)
    for res in (Resource.NW_OUT, Resource.CPU):
        wr = float(USAGE_WEIGHTS[int(res)])
        cap = m.broker_capacity[res]
        load = torch.where(alive, agg.broker_load[..., int(res), :], 0.0)
        avg_util = load.sum(-1) / torch.where(alive, cap, 0.0).sum().clamp(min=1e-9)
        util = load / torch.where(cap > 0, cap, 1.0)
        over, under = _band_pressure(
            util, alive & (cap > 0), avg_util, cfg.balance_threshold[int(res)]
        )
        usage_over = usage_over + wr * over
        usage_under = usage_under + wr * under

    lead_ok = alive & ~m.broker_excl_leadership
    n_lead = lead_ok.sum().clamp(min=1).float()
    counts = agg.leader_count.float()
    lead_avg = torch.where(lead_ok, counts, 0.0).sum(-1) / n_lead
    lead_over, lead_under = _band_pressure(
        counts, lead_ok, lead_avg, cfg.leader_balance_threshold
    )
    lbi = torch.where(lead_ok, agg.leader_bytes_in, 0.0)
    lbi_over, lbi_under = _band_pressure(
        lbi, lead_ok, lbi.sum(-1) / n_lead, cfg.leader_bytes_in_balance_threshold
    )
    return BrokerPressure(
        usage_over=usage_over, usage_under=usage_under,
        lead_over=lead_over, lead_under=lead_under,
        lbi_over=lbi_over, lbi_under=lbi_under,
    )


# --------------------------------------------------------------------------
# Topic groups: the grouped mirror the topic goals' rows are derived from
# --------------------------------------------------------------------------


def max_partitions_per_topic(m: TensorClusterModel) -> int:
    """Capacity of a topic's member list: the densest topic's partition
    count, rounded up to a power of two (at least 8)."""
    topic = m.partition_topic[m.partition_valid].long()
    if topic.numel() == 0:
        return 1
    exact = max(int(torch.bincount(topic, minlength=m.num_topics).max()), 1)
    return max(1 << (exact - 1).bit_length(), 8)


def topic_member_index(m: TensorClusterModel, max_pt: int) -> torch.Tensor:
    """int32[T, max_pt] — partition ids of each topic's valid partitions in
    ascending order, -1 padded."""
    T, P = m.num_topics, m.P
    topic = torch.where(m.partition_valid, m.partition_topic, T).long()
    order = torch.argsort(topic, stable=True)
    counts = torch.bincount(topic, minlength=T + 1)[:T]
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(max_pt, device=m.device)
    idx = (starts[:, None] + j[None, :]).clamp(0, P - 1)
    return torch.where(j[None, :] < counts[:, None], order[idx], -1).int()


@dataclasses.dataclass
class TopicGroup:
    """Static topic membership: ``members[t, j]`` is topic t's j-th valid
    partition (-1 pad); ``member_slot[p]`` is j with ``members[topic(p), j]
    == p`` (0 for invalid partitions)."""

    members: torch.Tensor      # int32[T, max_pt]
    member_slot: torch.Tensor  # int32[P]


def make_topic_group(m: TensorClusterModel, max_pt: int) -> TopicGroup:
    members = topic_member_index(m, max_pt)
    slots = torch.arange(max_pt, dtype=torch.int32, device=m.device).expand_as(members)
    ok = members >= 0
    member_slot = torch.zeros(m.P, dtype=torch.int32, device=m.device)
    member_slot[members[ok].long()] = slots[ok]
    return TopicGroup(members=members, member_slot=member_slot)


def grouped_placement(
    m: TensorClusterModel, group: TopicGroup
) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's placement grouped by topic: ``(grouped_assign[t, j] =
    assignment[members[t, j]], grouped_leader)``, -1 for pad entries."""
    ok = group.members >= 0
    mpc = group.members.clamp(0, m.P - 1).long()
    ga = torch.where(ok[..., None], m.assignment[mpc], -1)
    gl = torch.where(ok, m.leader_slot[mpc], -1)
    return ga, gl


def stack_needs_topic(goal_names: tuple[str, ...]) -> bool:
    """True when the stack scores topic goals (the search then carries the
    grouped mirror)."""
    return bool(set(tt.TOPIC_GOALS) & set(goal_names))


def _count_rows(b: torch.Tensor, w: torch.Tensor, B: int) -> torch.Tensor:
    """int32[K, B] — per-row bincount of broker ids ``b[K, n]`` weighted by
    ``w[K, n]``."""
    out = torch.zeros(b.shape[0], B, dtype=torch.int32, device=b.device)
    return out.scatter_add_(1, b.long(), w.int())


def derived_topic_rows(
    state: SearchState, chain: torch.Tensor, ts: torch.Tensor, B: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(replica_count, leader_count) int32[K, B] rows of topic ``ts[k]`` in
    chain ``chain[k]``, derived from the grouped mirror."""
    if state.grouped_assign is None:
        raise ValueError(
            "goal stack scores topic goals but the search state carries no "
            "grouped placement mirror — init_search_state(group=...) required"
        )
    c, t = chain.long(), ts.long()
    blocks = state.grouped_assign[c, t]     # [K, max_pt, R]
    leads = state.grouped_leader[c, t]      # [K, max_pt]
    valid = blocks >= 0
    R = blocks.shape[-1]
    slots = torch.arange(R, device=blocks.device)
    is_lead = (slots == leads[..., None]) & valid
    K = blocks.shape[0]
    b = blocks.clamp(0, B - 1).reshape(K, -1)
    return _count_rows(b, valid.reshape(K, -1), B), _count_rows(b, is_lead.reshape(K, -1), B)


def topic_row_delta(
    m: TensorClusterModel,
    view: PartitionView,
    old: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    new: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_replica_count, d_leader_count) int32[K, B] — each move's delta to
    its topic's count rows."""

    def contrib(assign_row, leader_slot_p):
        valid = (assign_row >= 0) & view.pvalid[:, None]
        slots = torch.arange(assign_row.shape[1], device=assign_row.device)
        is_lead = (slots[None, :] == leader_slot_p[:, None]) & valid
        b = assign_row.clamp(0, m.B - 1)
        return _count_rows(b, valid, m.B), _count_rows(b, is_lead, m.B)

    rc_o, lc_o = contrib(old[0], old[1])
    rc_n, lc_n = contrib(new[0], new[1])
    return rc_n - rc_o, lc_n - lc_o


# --------------------------------------------------------------------------
# Aggregate scatter, cost vectors, move scoring and application
# --------------------------------------------------------------------------


def scatter_partition(
    agg: BrokerAggregates,
    m: TensorClusterModel,
    chain: torch.Tensor,          # int[K] row of agg's leading axis
    view: PartitionView,
    assign_row: torch.Tensor,     # int32[K, R]
    leader_slot_p: torch.Tensor,  # int32[K]
    disk_row: torch.Tensor,       # int32[K, R]
    w_f: torch.Tensor,            # float32[K] weight (+1 add, -1 remove, 0 no-op)
    w_i: torch.Tensor,            # int32[K]
) -> None:
    """Add ``w`` times K partitions' contributions to the [B]-level fields
    of ``agg`` at rows ``chain``, in place. The [T, B] topic matrices are not
    kept during search (rows come from ``derived_topic_rows``)."""
    K, R = assign_row.shape
    valid = (assign_row >= 0) & view.pvalid[:, None]
    b = assign_row.clamp(0, m.B - 1).long()
    slots = torch.arange(R, device=b.device)
    is_lead = (slots[None, :] == leader_slot_p[:, None]) & valid
    # [K, RES, R] role-resolved slot loads, zero for invalid slots
    slot_load = torch.where(
        is_lead[:, None, :], view.lead_load[:, :, None], view.foll_load[:, :, None]
    )
    slot_load = torch.where(valid[:, None, :], slot_load, 0.0)
    c = chain.long()[:, None].expand(K, R)
    wf = w_f[:, None]
    wi = w_i[:, None]
    res = torch.arange(NUM_RESOURCES, device=b.device)[None, :, None].expand(K, -1, R)
    agg.broker_load.index_put_(
        (c[:, None, :].expand(K, NUM_RESOURCES, R), res, b[:, None, :].expand(K, NUM_RESOURCES, R)),
        w_f[:, None, None] * slot_load,
        accumulate=True,
    )
    agg.replica_count.index_put_((c, b), wi * valid.int(), accumulate=True)
    agg.leader_count.index_put_((c, b), wi * is_lead.int(), accumulate=True)
    agg.potential_nw_out.index_put_(
        (c, b), wf * view.lead_load[:, Resource.NW_OUT, None] * valid.float(), accumulate=True
    )
    agg.leader_bytes_in.index_put_(
        (c, b), wf * view.lead_load[:, Resource.NW_IN, None] * is_lead.float(), accumulate=True
    )
    d = disk_row.clamp(0, m.D - 1).long()
    disk_ok = valid & (disk_row >= 0)
    agg.disk_load.index_put_(
        (c, b, d), wf * slot_load[:, Resource.DISK, :] * disk_ok.float(), accumulate=True
    )


def _take_rows(agg: BrokerAggregates, chain: torch.Tensor) -> BrokerAggregates:
    """Copies of the [B]-level fields at rows ``chain`` (candidate scratch)."""
    c = chain.long()
    fields = {f: getattr(agg, f)[c] for f in BROKER_FIELDS}
    return agg.replace(**fields)


def partition_row_sums(
    m: TensorClusterModel,
    view: PartitionView,
    assign_row: torch.Tensor,
    leader_slot_p: torch.Tensor,
    disk_row: torch.Tensor,
) -> torch.Tensor:
    """float32[K, 4] — each partition's contribution to PARTITION_GOALS."""
    return pt.partition_rows(m, assign_row, leader_slot_p, disk_row, view.pvalid)


#: KafkaAssignerEvenRackAwareGoal decomposes into the kept RackAwareGoal sum
#: plus an aggregate-side leader-evenness term, so it needs no own slot.
DECOMPOSED = {"KafkaAssignerEvenRackAwareGoal"}


def check_searchable(goal_names: tuple[str, ...]) -> None:
    for name in goal_names:
        if (
            GOAL_REGISTRY[name].placement_dependent
            and name not in pt.PARTITION_GOALS
            and name not in DECOMPOSED
        ):
            raise ValueError(
                f"goal {name} reads per-partition placement but has no "
                "incrementally-kept sum; it cannot be searched"
            )


def _kaera_evenness(m: TensorClusterModel, leader_count: torch.Tensor) -> torch.Tensor:
    """Leader-evenness half of KafkaAssignerEvenRackAwareGoal's cost."""
    alive = m.broker_ok
    avg = leader_count.sum(-1).float() / alive.sum().float().clamp(min=1.0)
    over = torch.where(alive, (leader_count - torch.ceil(avg)[..., None]).clamp(min=0), 0.0)
    return over.sum(-1) / avg.clamp(min=1e-9)


def make_cost_vector_fn(
    m: TensorClusterModel, goal_names: tuple[str, ...], cfg: GoalConfig
):
    """``(agg, part_sums, mtl_sum, trd_sum, trd_norm) -> costs float32[..., G]``.

    Topic goals come from the exact accumulators, partition goals from the
    kept sums, every other goal re-scores the [B]-level aggregates. Inputs
    may carry one leading batch axis (candidates)."""
    check_searchable(goal_names)
    part_idx = {n: i for i, n in enumerate(pt.PARTITION_GOALS)}

    def vector_fn(agg, part_sums, mtl_sum, trd_sum, trd_norm) -> torch.Tensor:
        inv_np = 1.0 / agg.leader_count.sum(-1).float().clamp(min=1.0)
        costs = []
        for name in goal_names:
            if name in part_idx:
                c = part_sums[..., part_idx[name]]
                if name == "PreferredLeaderElectionGoal":
                    c = c * inv_np
            elif name == "MinTopicLeadersPerBrokerGoal":
                c = mtl_sum
            elif name == "TopicReplicaDistributionGoal":
                c = trd_sum / trd_norm
            elif name == "KafkaAssignerEvenRackAwareGoal":
                c = part_sums[..., part_idx["RackAwareGoal"]] + _kaera_evenness(
                    m, agg.leader_count
                )
            else:
                c = GOAL_REGISTRY[name].fn(m, agg, cfg).cost
            costs.append(c.float())
        return torch.stack(costs, dim=-1)

    return vector_fn


def make_move_scorer(m: TensorClusterModel, goal_names: tuple[str, ...], cfg: GoalConfig):
    """``score(state, chain, view, old, new) -> MoveDelta`` for K candidate
    moves, each against its chain's current state. Per move this touches
    O(R) aggregate cells, one derived topic row and O(B) goal re-scores."""
    vector_fn = make_cost_vector_fn(m, goal_names, cfg)
    needs_topic = stack_needs_topic(goal_names)
    T = m.num_topics
    n_alive = m.broker_ok.sum().clamp(min=1).float()

    def score(state: SearchState, chain, view: PartitionView, old, new) -> MoveDelta:
        K = chain.shape[0]
        dev = chain.device
        agg = _take_rows(state.agg, chain)
        rows = torch.arange(K, device=dev)
        one_f = torch.ones(K, device=dev)
        one_i = torch.ones(K, dtype=torch.int32, device=dev)
        scatter_partition(agg, m, rows, view, *old, -one_f, -one_i)
        scatter_partition(agg, m, rows, view, *new, one_f, one_i)
        part_new = (
            state.part_sums[chain.long()]
            - partition_row_sums(m, view, *old)
            + partition_row_sums(m, view, *new)
        )
        if needs_topic:
            t = view.topic.long()
            drc, dlc = topic_row_delta(m, view, old, new)
            trc_row, tlc_row = derived_topic_rows(state, chain, view.topic, m.B)
            new_trc, new_tlc = trc_row + drc, tlc_row + dlc
            flagged = m.topic_min_leaders[t]
            d_mtl = tt.mtl_row(m, cfg, flagged, new_tlc) - tt.mtl_row(m, cfg, flagged, tlc_row)
            pen_new, _ = tt.trd_row_pen(m, cfg, new_trc)
            pen_old, _ = tt.trd_row_pen(m, cfg, trc_row)
            d_trd = pen_new - pen_old
            total_old = tt.trd_row_total(m, trc_row)
            total_new = tt.trd_row_total(m, new_trc)
            d_total = total_new - total_old
            # normalizer shift: only topic t's average term changes
            norm_old = tt.trd_normalizer(m, state.topic_totals[chain.long()])
            norm_new = norm_old + (
                (total_new / n_alive).clamp(min=1.0) - (total_old / n_alive).clamp(min=1.0)
            ) / float(T)
            norm_new = torch.where(norm_new > 0, norm_new, 1.0)
        else:
            d_mtl = d_trd = d_total = torch.zeros(K, device=dev)
            norm_new = torch.ones(K, device=dev)
        c = chain.long()
        cost_vec = vector_fn(
            agg, part_new, state.mtl_sum[c] + d_mtl, state.trd_sum[c] + d_trd, norm_new
        )
        return MoveDelta(
            cost_vec=cost_vec, part_sums=part_new, d_mtl=d_mtl, d_trd=d_trd,
            d_total=d_total,
        )

    return score


def _masked_put(buf: torch.Tensor, idx: tuple, values: torch.Tensor, mask: torch.Tensor) -> None:
    """``buf[idx] = values`` for the entries where ``mask``; the others are
    dropped. Each write adds its difference to the current cell, and a
    dropped one adds zero, so a dropped entry never writes an old value
    back over an accepted entry that shares its index (the scatter order
    of duplicate indices is undefined on CUDA)."""
    cur = buf[idx]
    keep = mask.view(mask.shape + (1,) * (values.dim() - mask.dim()))
    buf.index_put_(idx, torch.where(keep, values - cur, 0), accumulate=True)


def _placement_updates(
    state: SearchState,
    group: TopicGroup | None,
    chain: torch.Tensor,   # int[k]
    ps: torch.Tensor,      # int[k]
    ts: torch.Tensor,      # int[k]
    write: torch.Tensor,   # bool[k] placement-row writes to perform
    mirror: torch.Tensor,  # bool[k] grouped-mirror writes to perform
    rows: torch.Tensor,    # int32[k, R] new assignment rows
    leads: torch.Tensor,   # int32[k]
    disks: torch.Tensor,   # int32[k, R]
) -> None:
    """Write k placement rows (and their grouped-mirror entries) in place.
    Entries whose mask is False are dropped, never written back, so
    (chain, partition) pairs may repeat as long as at most one of them
    writes: an accepted row is never clobbered by a rejected one. Invalid
    partitions have no mirror entry (their ``mirror`` must be False)."""
    c, p = chain.long(), ps.long()
    _masked_put(state.assignment, (c, p), rows, write)
    _masked_put(state.leader_slot, (c, p), leads, write)
    _masked_put(state.replica_disk, (c, p), disks, write)
    if state.grouped_assign is None:
        return
    if group is None:
        raise ValueError("state carries a grouped mirror; pass group=")
    t = ts.long()
    j = group.member_slot[p].long()
    _masked_put(state.grouped_assign, (c, t, j), rows, mirror)
    _masked_put(state.grouped_leader, (c, t, j), leads, mirror)


def apply_move(
    state: SearchState,
    m: TensorClusterModel,
    chain: torch.Tensor,
    p: torch.Tensor,
    view: PartitionView,
    old: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    new: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    delta: MoveDelta,
    accept: torch.Tensor,   # bool[K]
    group: TopicGroup | None = None,
) -> None:
    """Apply the scored moves where ``accept``, in place; a rejected move
    changes nothing (its scatters carry weight 0 and its row writes are
    dropped). ``chain`` entries must be distinct."""
    af, ai = accept.float(), accept.int()
    scatter_partition(state.agg, m, chain, view, *old, -af, -ai)
    scatter_partition(state.agg, m, chain, view, *new, af, ai)
    c = chain.long()
    state.part_sums[c] = torch.where(accept[:, None], delta.part_sums, state.part_sums[c])
    state.topic_totals.index_put_((c, view.topic.long()), af * delta.d_total, accumulate=True)
    state.mtl_sum.index_put_((c,), af * delta.d_mtl, accumulate=True)
    state.trd_sum.index_put_((c,), af * delta.d_trd, accumulate=True)
    state.cost_vec[c] = torch.where(accept[:, None], delta.cost_vec, state.cost_vec[c])
    state.n_accepted.index_put_((c,), ai, accumulate=True)
    _placement_updates(
        state, group, chain, p, view.topic,
        write=accept, mirror=accept & view.pvalid,
        rows=new[0], leads=new[1], disks=new[2],
    )


def make_swap_scorer(m: TensorClusterModel, goal_names: tuple[str, ...], cfg: GoalConfig):
    """``score(state, chain, view1, old1, new1, view2, old2, new2) ->
    SwapDelta`` for K two-partition candidates, each against its chain's
    current state.

    A replica swap exchanges two replicas between brokers, so it keeps every
    broker's replica count: it reaches usage-balanced states a single
    relocation cannot without breaking the count band on the way. Scoring
    composes both partitions' deltas exactly, including the same-topic case
    where one [T, B] row takes both. A single move passes an inert second
    partition (rows -1), whose every contribution is zero."""
    vector_fn = make_cost_vector_fn(m, goal_names, cfg)
    needs_topic = stack_needs_topic(goal_names)
    T = m.num_topics
    n_alive = m.broker_ok.sum().clamp(min=1).float()

    def score(state: SearchState, chain, view1, old1, new1, view2, old2, new2) -> SwapDelta:
        K = chain.shape[0]
        dev = chain.device
        c = chain.long()
        agg = _take_rows(state.agg, chain)
        rows = torch.arange(K, device=dev)
        one_f = torch.ones(K, device=dev)
        one_i = torch.ones(K, dtype=torch.int32, device=dev)
        scatter_partition(agg, m, rows, view1, *old1, -one_f, -one_i)
        scatter_partition(agg, m, rows, view1, *new1, one_f, one_i)
        scatter_partition(agg, m, rows, view2, *old2, -one_f, -one_i)
        scatter_partition(agg, m, rows, view2, *new2, one_f, one_i)
        part_new = (
            state.part_sums[c]
            - partition_row_sums(m, view1, *old1)
            + partition_row_sums(m, view1, *new1)
            - partition_row_sums(m, view2, *old2)
            + partition_row_sums(m, view2, *new2)
        )
        if needs_topic:
            t1, t2 = view1.topic, view2.topic
            same = t1 == t2
            drc1, dlc1 = topic_row_delta(m, view1, old1, new1)
            drc2, dlc2 = topic_row_delta(m, view2, old2, new2)
            trc, tlc = derived_topic_rows(state, torch.cat([chain, chain]), torch.cat([t1, t2]), m.B)
            trc1, trc2, tlc1, tlc2 = trc[:K], trc[K:], tlc[:K], tlc[K:]
            flag = m.topic_min_leaders[torch.cat([t1, t1, t2]).long()]
            # three row variants at once: one row taking both deltas (same
            # topic), then each partition's row on its own
            row_trc = torch.cat([trc1, trc1, trc2])
            row_tlc = torch.cat([tlc1, tlc1, tlc2])
            new_trc = row_trc + torch.cat([drc1 + drc2, drc1, drc2])
            new_tlc = row_tlc + torch.cat([dlc1 + dlc2, dlc1, dlc2])
            d_mtl3 = tt.mtl_row(m, cfg, flag, new_tlc) - tt.mtl_row(m, cfg, flag, row_tlc)
            pen_n, _ = tt.trd_row_pen(m, cfg, new_trc)
            pen_o, _ = tt.trd_row_pen(m, cfg, row_trc)
            d_trd3 = pen_n - pen_o
            tot_o = tt.trd_row_total(m, row_trc)
            tot_n = tt.trd_row_total(m, new_trc)
            d_tot3 = tot_n - tot_o
            d_norm3 = ((tot_n / n_alive).clamp(min=1.0) - (tot_o / n_alive).clamp(min=1.0)) / float(T)
            sm, a1, a2 = slice(0, K), slice(K, 2 * K), slice(2 * K, 3 * K)
            d_mtl = torch.where(same, d_mtl3[sm], d_mtl3[a1] + d_mtl3[a2])
            d_trd = torch.where(same, d_trd3[sm], d_trd3[a1] + d_trd3[a2])
            d_total = torch.where(same, d_tot3[sm], d_tot3[a1])
            d_total2 = torch.where(same, 0.0, d_tot3[a2])
            d_norm = torch.where(same, d_norm3[sm], d_norm3[a1] + d_norm3[a2])
            norm_new = tt.trd_normalizer(m, state.topic_totals[c]) + d_norm
            norm_new = torch.where(norm_new > 0, norm_new, 1.0)
        else:
            d_mtl = d_trd = d_total = d_total2 = torch.zeros(K, device=dev)
            norm_new = torch.ones(K, device=dev)
        cost_vec = vector_fn(
            agg, part_new, state.mtl_sum[c] + d_mtl, state.trd_sum[c] + d_trd, norm_new
        )
        return SwapDelta(
            cost_vec=cost_vec, part_sums=part_new, d_mtl=d_mtl, d_trd=d_trd,
            d_total=d_total, d_total2=d_total2,
        )

    return score


def apply_swap(
    state: SearchState,
    m: TensorClusterModel,
    chain: torch.Tensor,
    p1: torch.Tensor,
    view1: PartitionView,
    old1,
    new1,
    p2: torch.Tensor,
    view2: PartitionView,
    old2,
    new2,
    delta: SwapDelta,
    accept: torch.Tensor,   # bool[K]
    group: TopicGroup | None = None,
    active2: torch.Tensor | bool = True,
) -> None:
    """Apply the scored two-partition candidates where ``accept``, in place
    (a rejected one changes nothing, as in ``apply_move``). ``chain``
    entries must be distinct. Where ``active2`` is False partition 2 is
    inert (a single move): its writes are dropped, which also covers a
    partner drawn equal to partition 1."""
    af, ai = accept.float(), accept.int()
    scatter_partition(state.agg, m, chain, view1, *old1, -af, -ai)
    scatter_partition(state.agg, m, chain, view1, *new1, af, ai)
    scatter_partition(state.agg, m, chain, view2, *old2, -af, -ai)
    scatter_partition(state.agg, m, chain, view2, *new2, af, ai)
    c = chain.long()
    state.part_sums[c] = torch.where(accept[:, None], delta.part_sums, state.part_sums[c])
    state.topic_totals.index_put_(
        (torch.cat([c, c]), torch.cat([view1.topic, view2.topic]).long()),
        torch.cat([af * delta.d_total, af * delta.d_total2]), accumulate=True,
    )
    state.mtl_sum.index_put_((c,), af * delta.d_mtl, accumulate=True)
    state.trd_sum.index_put_((c,), af * delta.d_trd, accumulate=True)
    state.cost_vec[c] = torch.where(accept[:, None], delta.cost_vec, state.cost_vec[c])
    state.n_accepted.index_put_((c,), ai, accumulate=True)
    write2 = accept & active2
    _placement_updates(
        state, group, torch.cat([chain, chain]), torch.cat([p1, p2]),
        torch.cat([view1.topic, view2.topic]),
        write=torch.cat([accept, write2]),
        mirror=torch.cat([accept & view1.pvalid, write2 & view2.pvalid]),
        rows=torch.cat([new1[0], new2[0]]),
        leads=torch.cat([new1[1], new2[1]]),
        disks=torch.cat([new1[2], new2[2]]),
    )


def _repeat(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unsqueeze(0).repeat(n, *([1] * x.dim())).contiguous()


def init_search_state(
    m: TensorClusterModel,
    cfg: GoalConfig,
    goal_names: tuple[str, ...],
    group: TopicGroup | None = None,
    agg: BrokerAggregates | None = None,
    n_chains: int = 1,
) -> SearchState:
    """Full (non-incremental) evaluation of the starting placement, copied
    into ``n_chains`` chains. The cost vector is assembled by the same
    functions the incremental path uses."""
    if agg is None:
        agg = broker_aggregates(m)
    part_sums = pt.partition_sums(
        m, m.assignment, m.leader_slot, m.replica_disk, m.partition_valid
    )
    mtl_sum = tt.mtl_row(m, cfg, m.topic_min_leaders, agg.topic_leader_count).sum()
    pen, _ = tt.trd_row_pen(m, cfg, agg.topic_replica_count)
    trd_sum = pen.sum()
    topic_totals = tt.trd_row_total(m, agg.topic_replica_count)
    trd_norm = tt.trd_normalizer(m, topic_totals)
    cost_vec = make_cost_vector_fn(m, goal_names, cfg)(
        agg, part_sums, mtl_sum, trd_sum, trd_norm
    )
    C = n_chains
    dummy = torch.zeros(C, 1, 1, dtype=torch.int32, device=m.device)
    agg_c = agg.replace(
        **{f: _repeat(getattr(agg, f), C) for f in BROKER_FIELDS},
        topic_replica_count=dummy, topic_leader_count=dummy.clone(),
    )
    ga = gl = None
    if group is not None:
        ga, gl = grouped_placement(m, group)
        ga, gl = _repeat(ga, C), _repeat(gl, C)
    i32 = dict(dtype=torch.int32, device=m.device)
    return SearchState(
        assignment=_repeat(m.assignment, C),
        leader_slot=_repeat(m.leader_slot, C),
        replica_disk=_repeat(m.replica_disk, C),
        agg=agg_c,
        part_sums=_repeat(part_sums, C),
        topic_totals=_repeat(topic_totals, C),
        mtl_sum=_repeat(mtl_sum, C),
        trd_sum=_repeat(trd_sum, C),
        cost_vec=_repeat(cost_vec, C),
        n_accepted=torch.zeros(C, **i32),
        hard_mask=tuple(GOAL_REGISTRY[n].hard for n in goal_names),
        grouped_assign=ga,
        grouped_leader=gl,
        n_prop_kind=torch.zeros(C, NUM_MOVE_KINDS, **i32),
        n_acc_kind=torch.zeros(C, NUM_MOVE_KINDS, **i32),
    )


def with_placement(m: TensorClusterModel, s: SearchState, chain: int = 0) -> TensorClusterModel:
    """The model carrying chain ``chain``'s placement."""
    return m.replace(
        assignment=s.assignment[chain].clone(),
        leader_slot=s.leader_slot[chain].clone(),
        replica_disk=s.replica_disk[chain].clone(),
    )
