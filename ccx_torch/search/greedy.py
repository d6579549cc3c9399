"""Greedy lexicographic hill-climbing — the polish and leadership passes.

The reference's ``GoalOptimizer.optimizations`` walks goals in priority
order and takes a move only when every already-optimized goal accepts it:
lexicographic order on the per-goal cost vector. Each iteration here scores
``n_candidates`` proposals in O(R) each with the incremental move scorer
(``ccx_torch.search.state``), takes the lexicographically best DISJOINT
subset of the improving, hard-safe ones (disjoint partitions, topics and
touched brokers make every per-broker, per-topic and per-partition term
exactly additive), re-checks the composed batch exactly, applies it, and
stops after ``patience`` consecutive iterations without an improving
candidate. Candidates are single moves: the two-partition swap class is
not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ccx_torch.goals import topic_terms as tt
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack
from ccx_torch.model.aggregates import BROKER_FIELDS
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.search.annealer import (
    CAPACITY_GOALS,
    RACK_TARGET_GOALS,
    ProposalParams,
    _draw_partition,
    _single_plan,
    allows_inter_broker,
    draw_partitions,
    draw_single,
    goal_tols,
    hot_partition_list,
    real_sizes,
)
from ccx_torch.search.state import (
    KIND_SINGLE,
    SearchState,
    _placement_updates,
    bump_kind_counters,
    gather_views,
    init_search_state,
    make_cost_vector_fn,
    make_move_scorer,
    make_topic_group,
    max_partitions_per_topic,
    scatter_partition,
    stack_needs_topic,
    with_placement,
)


@dataclasses.dataclass(frozen=True)
class GreedyOptions:
    #: candidate moves scored per iteration
    n_candidates: int = 512
    max_iters: int = 2000
    #: stop after this many consecutive iterations with no improving candidate
    patience: int = 8
    p_leadership: float = 0.25
    p_disk: float = 0.0
    p_biased_dest: float = 0.5
    p_evac: float = 0.3
    #: apply up to this many non-conflicting improving moves per iteration
    batch_moves: int = 16
    #: every proposal is a leadership movement (the final leadership pass)
    leadership_only: bool = False
    seed: int = 0


@dataclasses.dataclass
class GreedyResult:
    model: TensorClusterModel
    stack_before: StackResult
    stack_after: StackResult
    n_moves: int
    n_iters: int
    n_prop_kind: tuple[int, ...] = (0, 0, 0)
    n_acc_kind: tuple[int, ...] = (0, 0, 0)


def _lex_lt_batch(costs: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """bool[N] — candidate vector lexicographically below ``cur`` (with the
    per-goal tolerance): the first significantly changed goal improved."""
    d = costs - cur[None, :]
    sig = d.abs() > goal_tols(cur)[None, :]
    first = sig.int().argmax(1, keepdim=True)
    return sig.any(1) & (d.gather(1, first)[:, 0] < 0)


def _lex_argmin(costs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index of the lexicographically smallest masked row of costs[N, G]
    (ties within tolerance go to the first index)."""
    alive = mask
    for g in range(costs.shape[1]):
        col = torch.where(alive, costs[:, g], float("inf"))
        mn = col.min()
        alive = alive & (col <= mn + (1e-6 + 1e-6 * mn.abs()))
    return alive.int().argmax()


def _select_disjoint(cost_vec, better, bmask, ta, n_batch, T):
    """Greedily take the lexicographically best remaining candidate whose
    partition topic and touched brokers are disjoint from everything already
    taken. Returns int64[n_batch] with N as the not-taken sentinel; slot 0
    holds the lex-best improving candidate."""
    N, B = bmask.shape
    dev = bmask.device
    alive = better.clone()
    used_b = torch.zeros(B, dtype=torch.bool, device=dev)
    used_t = torch.zeros(T, dtype=torch.bool, device=dev)
    sel = torch.full((n_batch,), N, dtype=torch.long, device=dev)
    ids = torch.arange(N, device=dev)
    for k in range(n_batch):
        ok = alive & ~((bmask & used_b[None, :]).any(1) | used_t[ta])
        any_ok = ok.any()
        idx = _lex_argmin(cost_vec, ok)
        sel[k] = torch.where(any_ok, idx, N)
        used_b |= bmask[idx] & any_ok
        used_t[ta[idx]] |= any_ok
        alive &= ids != idx
    return sel


def _broker_masks(touched: torch.Tensor, N: int, B: int) -> torch.Tensor:
    """bool[N, B] — which brokers each candidate touches (negative ids
    dropped)."""
    ok = touched >= 0
    mask = torch.zeros(N, B + 1, dtype=torch.int32, device=touched.device)
    mask.scatter_add_(1, torch.where(ok, touched, B).long(), ok.int())
    return mask[:, :B] > 0


def _compose_pairs(ss: SearchState, m, view, old, new, deltas, sel, vector_fn, guard_on, guard_cols):
    """Exact composition of the selected disjoint candidates onto chain 0.

    Disjointness makes sum-decomposable terms additive, but the leader
    evenness and the TRD normalizer are not, so the composed vector is
    recomputed exactly; when it is not lex-better than the iteration's base
    (or trips the TRD guard) only the best single candidate (slot 0) is
    taken. Returns (indices of the applied candidates, composed fields)."""
    dev = sel.device

    def compose(take):
        k = take.numel()
        agg = ss.agg.replace(**{f: getattr(ss.agg, f)[:1].clone() for f in BROKER_FIELDS})
        v = dataclasses.replace(view, **{
            f.name: getattr(view, f.name)[take] for f in dataclasses.fields(view)
        })
        zeros = torch.zeros(k, dtype=torch.long, device=dev)
        one_f = torch.ones(k, device=dev)
        one_i = torch.ones(k, dtype=torch.int32, device=dev)
        scatter_partition(agg, m, zeros, v, *(x[take] for x in old), -one_f, -one_i)
        scatter_partition(agg, m, zeros, v, *(x[take] for x in new), one_f, one_i)
        part = ss.part_sums[0] + (deltas.part_sums[take] - ss.part_sums[0]).sum(0)
        mtl = ss.mtl_sum[0] + deltas.d_mtl[take].sum()
        trd = ss.trd_sum[0] + deltas.d_trd[take].sum()
        totals = ss.topic_totals[:1].clone()
        totals.index_put_((zeros, v.topic.long()), deltas.d_total[take], accumulate=True)
        return agg, part, mtl, trd, totals

    full = compose(sel)
    agg, part, mtl, trd, totals = full
    cost_full = vector_fn(agg, part[None], mtl[None], trd[None], tt.trd_normalizer(m, totals))[0]
    if sel.numel() <= 1:
        return sel, full, cost_full
    cur = ss.cost_vec[0]
    d_full = cost_full - cur
    full_guard_up = guard_on and bool(
        ((d_full.abs() > goal_tols(cur)) & guard_cols & (d_full > 0)).any()
    )
    if bool(_lex_lt_batch(cost_full[None], cur)[0]) and not full_guard_up:
        return sel, full, cost_full
    first = sel[:1]
    return first, compose(first), deltas.cost_vec[sel[0]]


def _apply_pairs(ss: SearchState, group, ps, view, new, take, composed, cost_vec) -> None:
    """Write the composed accumulators and the taken placements into chain 0."""
    agg, part, mtl, trd, totals = composed
    for f in BROKER_FIELDS:
        getattr(ss.agg, f)[:1] = getattr(agg, f)
    ss.part_sums[0] = part
    ss.mtl_sum[0] = mtl
    ss.trd_sum[0] = trd
    ss.topic_totals[:1] = totals
    ss.cost_vec[0] = cost_vec
    ss.n_accepted[0] += take.numel()
    chain = torch.zeros_like(take)
    _placement_updates(
        ss, group, chain, ps[take], view.topic[take], view.pvalid[take],
        rows=new[0][take], leads=new[1][take], disks=new[2][take],
    )


def greedy_optimize(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts: GreedyOptions = GreedyOptions(),
    trd_guard: bool = False,
) -> GreedyResult:
    """Hill-climb the lexicographic goal-cost vector to a local optimum.

    ``trd_guard`` also vetoes candidates that significantly worsen the
    TopicReplicaDistribution tier."""
    stack_before = evaluate_stack(m, cfg, goal_names)
    p_real, b_real = real_sizes(m)
    lead_only = opts.leadership_only
    pp = ProposalParams(
        p_real=p_real,
        b_real=b_real,
        p_leadership=1.0 if lead_only else opts.p_leadership,
        p_disk=0.0 if lead_only else opts.p_disk,
        p_biased_dest=0.0 if lead_only else opts.p_biased_dest,
        p_evac=0.0 if lead_only else opts.p_evac,
        target_rack=(not lead_only) and bool(RACK_TARGET_GOALS & set(goal_names)),
        allow_inter=allows_inter_broker(goal_names) and not lead_only,
        target_capacity=(not lead_only) and bool(CAPACITY_GOALS & set(goal_names)),
        cap_thresholds=tuple(cfg.capacity_threshold),
    )
    if lead_only:
        # leadership moves cannot heal placement offenders
        evac, n_evac = None, 0
    else:
        evac, n_evac = hot_partition_list(m, goal_names, cfg)
    group = (
        make_topic_group(m, max_partitions_per_topic(m)) if stack_needs_topic(goal_names) else None
    )
    ss = init_search_state(m, cfg, goal_names, group=group)
    scorer = make_move_scorer(m, goal_names, cfg)
    vector_fn = make_cost_vector_fn(m, goal_names, cfg)
    dev = m.device
    hard_arr = torch.tensor(tuple(GOAL_REGISTRY[n].hard for n in goal_names), device=dev)
    guard_cols = torch.tensor(
        tuple(n == "TopicReplicaDistributionGoal" for n in goal_names), device=dev
    )
    N = max(opts.n_candidates, 1)
    n_batch = max(min(opts.batch_moves, N), 1)
    chain = torch.zeros(N, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(opts.seed + 1)

    it = stale = moves = 0
    while it < opts.max_iters and stale < opts.patience:
        ps, use_evac = _draw_partition(draw_partitions(gen, N, pp, n_evac, dev), pp, evac, n_evac)
        view = gather_views(ss, m, chain, ps)
        old, new, feas = _single_plan(draw_single(gen, N, m, pp), ss, chain, m, pp, view, use_evac)
        deltas = scorer(ss, chain, view, old, new)
        # hard-safety veto on top of lex improvement: every member of a
        # batch must leave every hard goal no worse
        cur = ss.cost_vec[0]
        d_all = deltas.cost_vec - cur[None, :]
        sig_all = d_all.abs() > goal_tols(cur)[None, :]
        hard_up = (sig_all & hard_arr & (d_all > 0)).any(1)
        better = feas & ~hard_up & _lex_lt_batch(deltas.cost_vec, cur)
        if trd_guard:
            better &= ~(sig_all & guard_cols & (d_all > 0)).any(1)
        n_prop = N
        if bool(better.any()):
            bmask = _broker_masks(torch.cat([old[0], new[0]], dim=1), N, m.B)
            ta = view.topic.long().clamp(0, m.num_topics - 1)
            sel = _select_disjoint(deltas.cost_vec, better, bmask, ta, n_batch, m.num_topics)
            sel = sel[sel < N]
            take, composed, cost_vec = _compose_pairs(
                ss, m, view, old, new, deltas, sel, vector_fn, trd_guard, guard_cols
            )
            _apply_pairs(ss, group, ps, view, new, take, composed, cost_vec)
            moves += take.numel()
            n_acc = take.numel()
            stale = 0
        else:
            n_acc = 0
            stale += 1
        bump_kind_counters(
            ss, chain[:1], KIND_SINGLE, n_prop,
            torch.full((1,), n_acc, dtype=torch.int32, device=dev),
        )
        it += 1

    result_model = with_placement(m, ss)
    return GreedyResult(
        model=result_model,
        stack_before=stack_before,
        stack_after=evaluate_stack(result_model, cfg, goal_names),
        n_moves=moves,
        n_iters=it,
        n_prop_kind=tuple(ss.n_prop_kind[0].tolist()),
        n_acc_kind=tuple(ss.n_acc_kind[0].tolist()),
    )
