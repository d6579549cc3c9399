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
candidate. With ``swap_fraction > 0`` a share of the candidates are uniform
two-partition swaps (``PolishIteration``), competing with the single moves
in the same disjoint batch.

``swap_polish`` is the count-preserving descent: each iteration ranks every
partition by broker band pressure times replica usage, draws hot/cold
replica-swap pairs and coupled leadership transfers by Gumbel top-k, scores
them exactly with the swap scorer and applies the best disjoint subset.
Both descents share one pair-candidate core (``_select_disjoint``,
``_compose_pairs``, ``_apply_pairs``): a single move is a pair whose b side
is inert (rows -1).

An iteration reads nothing back to the host: its selection has a fixed
size, its writes are masked, and the stop rule (``max_iters``, ``patience``)
is a device flag that makes every later iteration inert. With
``chunk_iters > 0`` the iterations run in chunks through
``annealer.drive_chunks``, which reads the stop flag once per chunk, and each
chunk writes one convergence-tap row; ``chunk_iters=0`` runs one loop that
reads the flag every iteration. Inert iterations change nothing, so both
give the same result. Within a chunk the host also looks at the flag without
waiting (``_poll_stop``) and stops queueing iterations once it sees it set;
it never queues one past the budget.
Each iteration is one aggregate span (``<label>-iter``, ``TRACER.step``),
and each read of device data a counted host sync (``TRACER.blocked``).

On a card a run's iterations after the first are replays of one CUDA
graph: the first runs eagerly (its caches and shapes warm), the second is
captured (``_iteration_graph``, ``graphs.step_graph`` under this module's
name, the seam the tests replace) and every later one replays it, the draws
advancing the run's Philox stream as eager launches would, so the result
is the eager one bit for bit. The stop read, the polls, the taps and the
heartbeats stay on the host, outside the graph. The run's phase span counts
``graphCaptures``, ``graphReplays`` and ``graphCaptureSeconds``.
"""

from __future__ import annotations

import dataclasses

import torch

from ccx_torch.common import costmodel
from ccx_torch.common.resources import Resource
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals import topic_terms as tt
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack
from ccx_torch.model.aggregates import BROKER_FIELDS
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.search.annealer import (
    CAPACITY_GOALS,
    RACK_TARGET_GOALS,
    PartitionDraws,
    ProposalParams,
    SingleDraws,
    SwapProposalDraws,
    _at,
    _draw_partition,
    _gumbel,
    _inert,
    _single_plan,
    _slot_mask,
    _uniform,
    allows_inter_broker,
    broker_masks,
    draw_partitions,
    draw_single,
    draw_swap,
    drive_chunks,
    goal_tols,
    hot_partition_list,
    lead_swap_share,
    propose_swap,
    real_sizes,
)
from ccx_torch.search.graphs import GraphedLoop
from ccx_torch.search.graphs import step_graph as _iteration_graph
from ccx_torch.search.state import (
    KIND_SINGLE,
    PartitionView,
    SearchState,
    SwapDelta,
    _placement_updates,
    cat_views,
    broker_pressure,
    bump_kind_counters,
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
    #: share of the candidates proposed as uniform two-partition swaps
    #: (replica swaps and leadership rotations), competing with the single
    #: moves in one disjoint batch. 0 (the JAX package's default): the
    #: count-preserving moves belong to ``swap_polish``
    swap_fraction: float = 0.0
    #: apply up to this many non-conflicting improving moves per iteration
    batch_moves: int = 16
    #: every proposal is a leadership movement (the final leadership pass)
    leadership_only: bool = False
    #: iterations per chunk (one host read and one tap row per chunk); 0 runs
    #: one loop that reads the stop flag every iteration
    chunk_iters: int = 50
    seed: int = 0


@dataclasses.dataclass
class GreedyResult:
    model: TensorClusterModel
    stack_before: StackResult
    #: None when the caller asked to defer the final evaluation
    stack_after: StackResult | None
    n_moves: int
    n_iters: int
    n_prop_kind: tuple[int, ...] = (0, 0, 0)
    n_acc_kind: tuple[int, ...] = (0, 0, 0)
    #: decoded convergence segment of a chunked run with taps on
    convergence: dict | None = None


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


def _at_index(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, as a gather: indexing with a 0-d
    tensor reads it back to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _select_disjoint(cost_vec, better, bmask, ta, tb, dual, n_batch, T):
    """Greedily take the lexicographically best remaining candidate whose
    topics and touched brokers are disjoint from everything already taken.
    ``ta``/``tb`` are the two sides' topics; ``dual[i]`` marks candidates
    whose b side is real (None when no candidate has one). Returns
    int64[n_batch] with N as the not-taken sentinel; slot 0 holds the
    lex-best improving candidate."""
    N, B = bmask.shape
    dev = bmask.device
    alive = better.clone()
    used_b = torch.zeros(B, dtype=torch.bool, device=dev)
    used_t = torch.zeros(T, dtype=torch.bool, device=dev)
    sel = torch.full((n_batch,), N, dtype=torch.long, device=dev)
    ids = torch.arange(N, device=dev)
    for k in range(n_batch):
        conf = (bmask & used_b[None, :]).any(1) | used_t[ta]
        if dual is not None:
            conf |= dual & used_t[tb]
        ok = alive & ~conf
        any_ok = ok.any()
        idx = _lex_argmin(cost_vec, ok)
        sel[k] = torch.where(any_ok, idx, N)
        used_b |= _at_index(bmask, idx) & any_ok
        t = ta.index_select(0, idx.reshape(1))
        used_t.index_copy_(0, t, used_t.index_select(0, t) | any_ok)
        if dual is not None:
            t = tb.index_select(0, idx.reshape(1))
            used_t.index_copy_(0, t, used_t.index_select(0, t) | (any_ok & _at_index(dual, idx)))
        alive &= ids != idx
    return sel


@dataclasses.dataclass
class Pairs:
    """N pair candidates on chain 0: the a side's and (where ``has_pairs``)
    the b side's partition, view, old and new rows, and their scores."""

    pa: torch.Tensor
    va: PartitionView
    olda: tuple
    newa: tuple
    deltas: object           # MoveDelta, or SwapDelta with pairs
    pb: torch.Tensor | None = None
    vb: PartitionView | None = None
    oldb: tuple | None = None
    newb: tuple | None = None

    @property
    def has_pairs(self) -> bool:
        return self.vb is not None


def _compose_pairs(ss: SearchState, m, c: Pairs, safe, taken, vector_fn, guard_on, guard_cols):
    """Exact composition of the selected disjoint candidates onto chain 0.

    Disjointness makes sum-decomposable terms additive, but the leader
    evenness and the TRD normalizer are not, so the composed vector is
    recomputed exactly; when it is not lex-better than the iteration's base
    (or trips the TRD guard) only the best single candidate (slot 0) is
    taken, with the scorer's own vector. Both compositions are built in one
    scatter (two rows of scratch aggregates), so nothing is read back.
    Returns (the chosen accumulators, its cost vector, batch_ok)."""
    dev = safe.device
    n = safe.numel()
    deltas = c.deltas
    slot = torch.arange(n, device=dev)
    first = taken & (slot == 0)
    w = torch.cat([taken, first]).float()
    wi = w.int()
    rows = torch.cat([torch.zeros(n, dtype=torch.long, device=dev),
                      torch.ones(n, dtype=torch.long, device=dev)])
    agg = ss.agg.replace(**{f: getattr(ss.agg, f)[:1].repeat_interleave(2, 0) for f in BROKER_FIELDS})
    totals = ss.topic_totals[:1].repeat_interleave(2, 0)
    sides = [(c.va, c.olda, c.newa, deltas.d_total)]
    if c.has_pairs:
        sides.append((c.vb, c.oldb, c.newb, deltas.d_total2))
    for view, old, new, d_tot in sides:
        v = view_rows(view, safe)
        v2 = cat_views(v, v)
        scatter_partition(agg, m, rows, v2, *(x[safe].repeat(2, *([1] * (x.dim() - 1))) for x in old), -w, -wi)
        scatter_partition(agg, m, rows, v2, *(x[safe].repeat(2, *([1] * (x.dim() - 1))) for x in new), w, wi)
        totals.index_put_((rows, v2.topic.long()), w * d_tot[safe].repeat(2), accumulate=True)
    wf = w.view(2, n)
    part = ss.part_sums[:1] + (wf[:, :, None] * (deltas.part_sums[safe] - ss.part_sums[0])[None]).sum(1)
    mtl = ss.mtl_sum[0] + (wf * deltas.d_mtl[safe][None]).sum(1)
    trd = ss.trd_sum[0] + (wf * deltas.d_trd[safe][None]).sum(1)
    full_agg = agg.replace(**{f: getattr(agg, f)[:1] for f in BROKER_FIELDS})
    cost_full = vector_fn(full_agg, part[:1], mtl[:1], trd[:1], tt.trd_normalizer(m, totals[:1]))[0]
    cur = ss.cost_vec[0]
    d_full = cost_full - cur
    batch_ok = (taken.sum() <= 1) | _lex_lt_batch(cost_full[None], cur)[0]
    if guard_on:
        batch_ok &= (taken.sum() <= 1) | ~((d_full.abs() > goal_tols(cur)) & guard_cols & (d_full > 0)).any()
    pick = torch.where(batch_ok, 0, 1)
    cost_first = torch.where(taken[0], _at_index(deltas.cost_vec, safe[0]), cur)
    composed = (
        {f: _at_index(getattr(agg, f), pick) for f in BROKER_FIELDS},
        _at_index(part, pick), _at_index(mtl, pick), _at_index(trd, pick), _at_index(totals, pick),
    )
    return composed, torch.where(batch_ok, cost_full, cost_first), batch_ok


def _apply_pairs(ss: SearchState, group, c: Pairs, safe, write_a, keep, composed, cost_vec, dual) -> None:
    """Write the composed accumulators (where ``keep``) and the written
    slots' placements (``write_a``; b sides where ``dual``, None: no b sides)
    into chain 0."""
    agg, part, mtl, trd, totals = composed

    def put(dst: torch.Tensor, new: torch.Tensor) -> None:
        dst.copy_(torch.where(keep, new, dst))

    for f in BROKER_FIELDS:
        put(getattr(ss.agg, f)[0], agg[f])
    put(ss.part_sums[0], part)
    put(ss.mtl_sum[0], mtl)
    put(ss.trd_sum[0], trd)
    put(ss.topic_totals[0], totals)
    put(ss.cost_vec[0], cost_vec)
    ss.n_accepted[0] += write_a.sum().int()
    va = view_rows(c.va, safe)
    sides = [(c.pa[safe], va, tuple(x[safe] for x in c.newa), write_a)]
    if dual is not None:
        sides.append((c.pb[safe], view_rows(c.vb, safe), tuple(x[safe] for x in c.newb),
                      write_a & dual[safe]))
    write = torch.cat([w for *_, w in sides])
    _placement_updates(
        ss, group, torch.zeros_like(write, dtype=torch.long),
        torch.cat([p for p, *_ in sides]), torch.cat([v.topic for _, v, _, _ in sides]),
        write=write, mirror=write & torch.cat([v.pvalid for _, v, _, _ in sides]),
        rows=torch.cat([new[0] for _, _, new, _ in sides]),
        leads=torch.cat([new[1] for _, _, new, _ in sides]),
        disks=torch.cat([new[2] for _, _, new, _ in sides]),
    )


def _descend(ss, m, group, c: Pairs, feas, hard_arr, guard_on, guard_cols, vector_fn,
             n_batch, dual, live):
    """One descent iteration's selection and application: the improving,
    hard-safe (optionally TRD-guarded) candidates, their best disjoint
    subset composed exactly and applied. Nothing is applied where ``live``
    (a device bool) is False. Returns (the selected candidates int64[n_batch],
    which of them were written bool[n_batch])."""
    cur = ss.cost_vec[0]
    d_all = c.deltas.cost_vec - cur[None, :]
    sig_all = d_all.abs() > goal_tols(cur)[None, :]
    hard_up = (sig_all & hard_arr & (d_all > 0)).any(1)
    better = feas & ~hard_up & _lex_lt_batch(c.deltas.cost_vec, cur) & live
    if guard_on:
        better &= ~(sig_all & guard_cols & (d_all > 0)).any(1)
    any_better = better.any()
    rows = [c.olda[0], c.newa[0]]
    if c.has_pairs:
        rows += [c.oldb[0], c.newb[0]]
    N = better.shape[0]
    bmask = broker_masks(torch.cat(rows, dim=1), m.B)
    T = m.num_topics
    ta = c.va.topic.long().clamp(0, T - 1)
    tb = c.vb.topic.long().clamp(0, T - 1) if c.has_pairs else None
    sel = _select_disjoint(c.deltas.cost_vec, better, bmask, ta, tb, dual, n_batch, T)
    taken = sel < N
    safe = sel.clamp(max=N - 1)
    composed, cost_vec, batch_ok = _compose_pairs(
        ss, m, c, safe, taken, vector_fn, guard_on, guard_cols
    )
    slot0 = torch.arange(sel.numel(), device=sel.device) == 0
    write_a = taken & (batch_ok | slot0) & any_better
    _apply_pairs(ss, group, c, safe, write_a, any_better, composed, cost_vec, dual)
    return safe, write_a


def _poll_stop(poll: dict, live: torch.Tensor) -> bool:
    """Whether the host can see, without waiting, that the descent has
    stopped. On the CPU the flag is read directly (a counted read). On a
    card the flag is copied to pinned memory behind the queued work and read
    once that copy has landed, so the answer may lag a few iterations (the
    iterations in between are inert); that read never waits and is not
    counted as a sync."""
    if live.device.type != "cuda":
        with TRACER.blocked():
            return not bool(live)
    if "buf" not in poll:
        poll["buf"] = torch.zeros((), dtype=torch.bool, pin_memory=True)
        poll["event"] = torch.cuda.Event()
        poll["pending"] = False
    if poll["pending"] and poll["event"].query():
        poll["pending"] = False
        if not bool(poll["buf"]):
            return True
    if not poll["pending"]:
        poll["buf"].copy_(live, non_blocking=True)
        poll["event"].record()
        poll["pending"] = True
    return False


def _goal_masks(goal_names, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(hard goals, the TopicReplicaDistribution column) as bool masks on
    ``dev``: two host-to-device copies, counted host syncs on a card."""
    with TRACER.blocked():
        hard = torch.tensor(tuple(GOAL_REGISTRY[n].hard for n in goal_names), device=dev)
    with TRACER.blocked():
        guard = torch.tensor(tuple(n == "TopicReplicaDistributionGoal" for n in goal_names),
                             device=dev)
    return hard, guard


def _kind_counts(ss: SearchState) -> tuple[tuple, tuple]:
    """The proposed and accepted counts per move kind, read to the host."""
    with TRACER.blocked():
        prop = tuple(ss.n_prop_kind[0].tolist())
    with TRACER.blocked():
        acc = tuple(ss.n_acc_kind[0].tolist())
    return prop, acc


def _drive_descent(iteration, ss: SearchState, goal_names, opts, dev, label: str,
                   gen: torch.Generator):
    """Run ``iteration(live) -> applied`` (int tensor, 0 where not live) to
    the stop rule: ``opts.max_iters`` iterations, or ``opts.patience``
    consecutive ones that applied nothing. Returns (iterations, moves,
    convergence segment or None). Each chunk counts on the cost ledger as
    ``<label>-chunk`` (the one loop as ``<label>-loop``).

    Where ``_iteration_graph`` gives a graph and the budget leaves an
    iteration after the first, the first iteration runs eagerly, the second
    is captured, and it and every later one replay the capture (``gen``:
    the iteration's draws). The counts land on the open span."""
    from ccx_torch.search import telemetry

    # the ledger's signature: the state's shapes and the options that shape
    # an iteration, never the budget or the seed
    sig = costmodel.signature(ss, dataclasses.replace(opts, max_iters=0, patience=0, seed=0))

    i32 = dict(dtype=torch.int32, device=dev)
    it = torch.zeros((), **i32)
    stale = torch.zeros((), **i32)
    moves = torch.zeros((), **i32)

    def live() -> torch.Tensor:
        return (it < opts.max_iters) & (stale < opts.patience)

    step = f"{label}-iter"

    def body() -> None:
        lv = live()
        n = iteration(lv)
        it.add_(lv.int())
        stale.copy_(torch.where(lv, torch.where(n > 0, 0, stale + 1), stale))
        moves.add_(n)

    graphed = GraphedLoop(_iteration_graph(dev, gen) if opts.max_iters > 1 else None, body)

    def one() -> None:
        with TRACER.step(step):
            graphed()

    convergence = None
    try:
        if opts.chunk_iters > 0:
            tap = telemetry.make_tap(len(goal_names), dev) if telemetry.enabled() else None
            poll: dict = {}

            def run_one(carry, off):
                # calls past the budget are inert: the host need not queue them
                for _ in range(min(opts.chunk_iters, opts.max_iters - off)):
                    if _poll_stop(poll, live()):
                        break
                    one()
                if tap is not None:
                    telemetry.record(tap, ss.cost_vec[0], ss.n_prop_kind[0], ss.n_acc_kind[0], 0.0)
                return carry, ~live()

            # heartbeat energy: the top-tier cost, read after the stop flag
            probe = (lambda _: ss.cost_vec[0, 0]) if tap is not None else None
            run_one = costmodel.instrument(f"{label}-chunk", iters=opts.chunk_iters, sig=sig,
                                           device=dev)(run_one)
            drive_chunks(run_one, None, total=opts.max_iters, chunk=opts.chunk_iters, probe=probe)
            convergence = telemetry.decode(
                tap, goal_names, chunk_size=opts.chunk_iters, budget=opts.max_iters
            )
        else:
            def loop() -> None:
                while True:
                    with TRACER.blocked():
                        go = bool(live())
                    if not go:
                        break
                    one()

            costmodel.instrument(f"{label}-loop", iters=opts.max_iters, sig=sig, device=dev)(loop)()
        with TRACER.blocked():
            n_iters = int(it)
        with TRACER.blocked():
            n_moves = int(moves)
    finally:
        graphed.close()
    return n_iters, n_moves, convergence


@dataclasses.dataclass
class PolishDraws:
    """Draws of one polish iteration: the single moves' partitions and
    plans, and the uniform swaps' (None without pair candidates)."""

    part: PartitionDraws
    single: SingleDraws
    swap: SwapProposalDraws | None = None


def draw_polish(gen: torch.Generator, n_single: int, n_swap: int, m: TensorClusterModel,
                pp: ProposalParams, n_evac: int) -> PolishDraws:
    dev = m.device
    part = draw_partitions(gen, n_single, pp, n_evac, dev)
    single = draw_single(gen, n_single, m, pp)
    swap = None
    if n_swap:
        swap = SwapProposalDraws(
            p1=torch.randint(0, pp.p_real, (n_swap,), generator=gen, device=dev),
            p2=torch.randint(0, pp.p_real, (n_swap,), generator=gen, device=dev),
            plan=draw_swap(gen, n_swap, m),
        )
    return PolishDraws(part, single, swap)


def polish_params(m: TensorClusterModel, cfg: GoalConfig, goal_names: tuple[str, ...],
                  opts: GreedyOptions) -> ProposalParams:
    """The polish's proposal knobs (the JAX package's ``greedy_optimize``)."""
    p_real, b_real = real_sizes(m)
    lead_only = opts.leadership_only
    allow_inter = allows_inter_broker(goal_names)
    return ProposalParams(
        p_real=p_real,
        b_real=b_real,
        p_leadership=1.0 if lead_only else opts.p_leadership,
        p_disk=0.0 if lead_only else opts.p_disk,
        p_biased_dest=0.0 if lead_only else opts.p_biased_dest,
        p_evac=0.0 if lead_only else opts.p_evac,
        target_rack=(not lead_only) and bool(RACK_TARGET_GOALS & set(goal_names)),
        allow_inter=allow_inter and not lead_only,
        p_swap=opts.swap_fraction if allow_inter else 0.0,
        target_capacity=(not lead_only) and bool(CAPACITY_GOALS & set(goal_names)),
        cap_thresholds=tuple(cfg.capacity_threshold),
        # in leadership-only mode every swap is a leadership rotation: a
        # replica swap would move replicas between brokers
        p_lead_swap=1.0 if lead_only else lead_swap_share(opts.p_leadership),
    )


class PolishIteration:
    """One polish iteration on a single-chain state: ``n_single`` single
    moves and, with ``swap_fraction > 0`` where inter-broker moves are
    allowed, ``n_swap`` uniform two-partition swaps, all scored exactly and
    competing in one disjoint batch (a single move is a pair whose b side
    is inert)."""

    def __init__(self, m: TensorClusterModel, cfg: GoalConfig, goal_names: tuple[str, ...],
                 opts: GreedyOptions, pp: ProposalParams, evac, n_evac: int, trd_guard: bool,
                 group=None):
        self.m, self.pp, self.evac, self.n_evac, self.trd_guard = m, pp, evac, n_evac, trd_guard
        self.group = group
        dev = m.device
        self.n_swap = int(opts.n_candidates * opts.swap_fraction) if pp.p_swap > 0 else 0
        self.n_single = max(opts.n_candidates - self.n_swap, 1)
        self.n_batch = max(min(opts.batch_moves, self.n_single), 1)
        self.scorer = make_move_scorer(m, goal_names, cfg)
        self.swap_scorer = make_swap_scorer(m, goal_names, cfg) if self.n_swap else None
        self.vector_fn = make_cost_vector_fn(m, goal_names, cfg)
        self.hard_arr, self.guard_cols = _goal_masks(goal_names, dev)
        self.chain = torch.zeros(self.n_single, dtype=torch.long, device=dev)
        #: candidates whose b side is real (None: singles only)
        self.dual = None
        if self.n_swap:
            self.chain_sw = torch.zeros(self.n_swap, dtype=torch.long, device=dev)
            self.dual = torch.arange(self.n_single + self.n_swap, device=dev) >= self.n_single
            self.kinds = torch.arange(3, device=dev)
            self.rows0 = torch.zeros(3, dtype=torch.long, device=dev)

    def draw(self, gen: torch.Generator) -> PolishDraws:
        return draw_polish(gen, self.n_single, self.n_swap, self.m, self.pp, self.n_evac)

    def __call__(self, ss: SearchState, d: PolishDraws, live: torch.Tensor) -> torch.Tensor:
        """Run one iteration in place, nothing applied where ``live`` (a
        device bool) is False; returns the candidates applied."""
        m, pp = self.m, self.pp
        ps, use_evac = _draw_partition(d.part, pp, self.evac, self.n_evac)
        view = gather_views(ss, m, self.chain, ps)
        old, new, feas = _single_plan(d.single, ss, self.chain, m, pp, view, use_evac)
        deltas = self.scorer(ss, self.chain, view, old, new)
        if not self.n_swap:
            _, write_a = _descend(
                ss, m, self.group, Pairs(pa=ps, va=view, olda=old, newa=new, deltas=deltas), feas,
                self.hard_arr, self.trd_guard, self.guard_cols, self.vector_fn, self.n_batch,
                dual=None, live=live,
            )
            n_acc = write_a.sum().int()
            bump_kind_counters(ss, self.chain[:1], KIND_SINGLE,
                               (live.int() * self.n_single).reshape(1), n_acc.reshape(1))
            return n_acc
        p1, v1, o1, n1, p2, v2, o2, n2, sw_ok, sw_lead = propose_swap(d.swap, ss, self.chain_sw, m, pp)
        wd = self.swap_scorer(ss, self.chain_sw, v1, o1, n1, v2, o2, n2)
        inert = tuple(torch.full_like(x, -1) for x in old)

        def cat(a, b):
            return torch.cat([a, b])

        pairs = Pairs(
            pa=cat(ps, p1), va=cat_views(view, v1),
            olda=tuple(map(cat, old, o1)), newa=tuple(map(cat, new, n1)),
            deltas=SwapDelta(
                cost_vec=cat(deltas.cost_vec, wd.cost_vec),
                part_sums=cat(deltas.part_sums, wd.part_sums),
                d_mtl=cat(deltas.d_mtl, wd.d_mtl),
                d_trd=cat(deltas.d_trd, wd.d_trd),
                d_total=cat(deltas.d_total, wd.d_total),
                d_total2=cat(torch.zeros_like(deltas.d_total), wd.d_total2),
            ),
            pb=cat(ps, p2), vb=cat_views(view, v2),
            oldb=tuple(map(cat, inert, o2)), newb=tuple(map(cat, inert, n2)),
        )
        safe, write_a = _descend(
            ss, m, self.group, pairs, cat(feas, sw_ok), self.hard_arr, self.trd_guard,
            self.guard_cols, self.vector_fn, self.n_batch, dual=self.dual, live=live,
        )
        lead = cat(torch.zeros_like(feas), sw_lead)
        dual_s, lead_s = self.dual[safe], lead[safe]
        n_lead_prop = sw_lead.sum().int()
        prop = torch.stack([torch.full_like(n_lead_prop, self.n_single),
                            self.n_swap - n_lead_prop, n_lead_prop]) * live.int()
        acc = torch.stack([(write_a & ~dual_s).sum(), (write_a & dual_s & ~lead_s).sum(),
                           (write_a & dual_s & lead_s).sum()]).int()
        bump_kind_counters(ss, self.rows0, self.kinds, prop, acc)
        return acc.sum()


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
    pp = polish_params(m, cfg, goal_names, opts)
    if opts.leadership_only:
        # leadership moves cannot heal placement offenders
        evac, n_evac = None, 0
    else:
        evac, n_evac = hot_partition_list(m, goal_names, cfg)
    group = (
        make_topic_group(m, max_partitions_per_topic(m)) if stack_needs_topic(goal_names) else None
    )
    ss = init_search_state(m, cfg, goal_names, group=group)
    step = PolishIteration(m, cfg, goal_names, opts, pp, evac, n_evac, trd_guard, group)
    dev = m.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(opts.seed + 1)

    def iteration(live: torch.Tensor) -> torch.Tensor:
        return step(ss, step.draw(gen), live)

    n_iters, moves, convergence = _drive_descent(iteration, ss, goal_names, opts, dev, "polish",
                                                 gen)
    result_model = with_placement(m, ss)
    n_prop_kind, n_acc_kind = _kind_counts(ss)
    return GreedyResult(
        model=result_model,
        stack_before=stack_before,
        stack_after=evaluate_stack(result_model, cfg, goal_names),
        n_moves=moves,
        n_iters=n_iters,
        n_prop_kind=n_prop_kind,
        n_acc_kind=n_acc_kind,
        convergence=convergence,
    )


# --------------------------------------------------------------------------
# Usage-coupled swap polish: the count-preserving descent
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SwapPolishOptions:
    #: coupled replica-swap pairs proposed per iteration
    n_swap_candidates: int = 64
    #: coupled leadership transfers proposed per iteration
    n_lead_candidates: int = 64
    max_iters: int = 200
    #: stop after this many consecutive iterations with no improving candidate
    patience: int = 10
    #: disjoint candidates applied per iteration (lex-best first)
    batch_moves: int = 16
    #: veto candidates that significantly worsen TopicReplicaDistribution
    trd_guard: bool = True
    #: iterations per chunk (``GreedyOptions.chunk_iters``); 0: one loop
    chunk_iters: int = 50
    seed: int = 0


@dataclasses.dataclass
class SwapPolishDraws:
    """Draws of one swap-polish iteration: Gumbel noise of the three top-k
    picks over the partitions and of the candidates' new disks."""

    u_hot: torch.Tensor      # float32[P] in [1e-12, 1)
    u_cold: torch.Tensor     # float32[P]
    u_lead: torch.Tensor     # float32[P]
    u_disk: torch.Tensor     # float32[N, 2, D]


def draw_swap_polish(gen: torch.Generator, m: TensorClusterModel, n: int) -> SwapPolishDraws:
    dev = m.device
    return SwapPolishDraws(
        u_hot=_uniform(gen, (m.P,), dev, 1e-12),
        u_cold=_uniform(gen, (m.P,), dev, 1e-12),
        u_lead=_uniform(gen, (m.P,), dev, 1e-12),
        u_disk=_uniform(gen, (n, 2, m.D), dev, 1e-12),
    )


class SwapPolishIteration:
    """One swap-polish iteration on a single-chain state: the candidate
    budget, the model's static per-partition usage and the scorers, built
    once per run."""

    def __init__(self, m, cfg, goal_names, opts: SwapPolishOptions):
        self.m, self.cfg = m, cfg
        dev = m.device
        P = m.P
        self.k_sw = max(min(int(opts.n_swap_candidates), P), 1)
        self.k_ld = max(min(int(opts.n_lead_candidates), P), 0)
        self.N = self.k_sw + self.k_ld
        self.n_batch = max(min(opts.batch_moves, self.N), 1)
        self.group = (
            make_topic_group(m, max_partitions_per_topic(m)) if stack_needs_topic(goal_names) else None
        )
        self.swap_scorer = make_swap_scorer(m, goal_names, cfg)
        self.vector_fn = make_cost_vector_fn(m, goal_names, cfg)
        self.hard_arr, self.guard_cols = _goal_masks(goal_names, dev)
        uw = usage_weights(dev)
        self.u_lead_p = uw @ m.leader_load      # [P] combined usage, leader role
        self.u_foll_p = uw @ m.follower_load
        self.lbytes_p = m.leader_load[Resource.NW_IN]
        n_valid = m.partition_valid.sum().clamp(min=1)
        self.avg_lb = torch.where(m.partition_valid, self.lbytes_p, 0.0).sum() / n_valid
        self.recv_ok = m.broker_ok & ~m.broker_excl_replicas
        self.lead_allowed = m.broker_ok & ~m.broker_excl_leadership
        self.is_swap = torch.arange(self.N, device=dev) < self.k_sw
        #: proposals per iteration by move kind (coupled leadership
        #: transfers are single moves, the pairs replica swaps)
        with TRACER.blocked():
            self.proposed = torch.tensor([self.k_ld, self.k_sw, 0], dtype=torch.int32, device=dev)
        # the usage a leadership transfer moves, and its damping: the count
        # fix wants low-usage-delta leaders, which the usage tiers above
        # LeaderReplica do not veto
        u_delta = (self.u_lead_p - self.u_foll_p).clamp(min=0.0)
        avg_du = torch.where(m.partition_valid, u_delta, 0.0).sum() / n_valid
        self.damp = 1.0 / (1.0 + u_delta / avg_du.clamp(min=1e-9))

    def candidates(self, ss: SearchState, d: SwapPolishDraws):
        """(pa, pb, r1, r2) int[N]: K_sw hot/cold replica-swap pairs, then
        K_ld leadership transfers (partner inert)."""
        m = self.m
        B, R, P = m.B, m.R, m.P
        press = broker_pressure(m, ss.agg, self.cfg)
        over, under = press.usage_over[0], press.usage_under[0]
        a, lead_slot = ss.assignment[0], ss.leader_slot[0]
        valid = (a >= 0) & m.partition_valid[:, None]
        movable = valid & ~m.partition_immovable[:, None]
        b = a.clamp(0, B - 1).long()
        is_l = torch.arange(R, device=m.device)[None, :] == lead_slot[:, None]
        u = torch.where(is_l, self.u_lead_p[:, None], self.u_foll_p[:, None])
        hot_sc = over[b] * u * movable
        cold_sc = under[b] * (1.0 / (1.0 + u)) * movable
        hot_score, hot_slot = hot_sc.amax(1), hot_sc.argmax(1).int()
        cold_score, cold_slot = cold_sc.amax(1), cold_sc.argmax(1).int()

        # coupled leadership transfer: a leader on a leader-count or
        # leader-bytes over broker to a follower slot on an under broker
        lsafe = lead_slot.clamp(0, R - 1).long()
        lb = b.gather(1, lsafe[:, None])[:, 0]
        has_lead = valid.gather(1, lsafe[:, None])[:, 0]
        dest_ok = movable & ~is_l & self.lead_allowed[b]
        dest_sc = (press.lead_under[0][b] + 0.3 * press.lbi_under[0][b]) * dest_ok
        dest_best, dest_slot = dest_sc.amax(1), dest_sc.argmax(1).int()
        src_lr = press.lead_over[0][lb] * self.damp
        src_lbi = press.lbi_over[0][lb] * (self.lbytes_p / self.avg_lb.clamp(min=1e-9))
        lead_score = (src_lr + src_lbi) * dest_best * has_lead * movable[torch.arange(P, device=m.device), lsafe]

        def gumbel_topk(score, k, u):
            return torch.topk(torch.log(score + 1e-12) + _gumbel(u), k).indices

        hot_ps = gumbel_topk(hot_score, self.k_sw, d.u_hot)
        cold_ps = gumbel_topk(cold_score, self.k_sw, d.u_cold)
        if self.k_ld:
            lead_ps = gumbel_topk(lead_score, self.k_ld, d.u_lead)
            pa = torch.cat([hot_ps, lead_ps])
            pb = torch.cat([cold_ps, lead_ps])
            r1 = torch.cat([hot_slot[hot_ps], dest_slot[lead_ps]])
            r2 = torch.cat([cold_slot[cold_ps], torch.zeros_like(dest_slot[lead_ps])])
        else:
            pa, pb, r1, r2 = hot_ps, cold_ps, hot_slot[hot_ps], cold_slot[cold_ps]
        return pa, pb, r1, r2

    def plan(self, ss: SearchState, d: SwapPolishDraws, pa, pb, r1, r2) -> tuple[Pairs, torch.Tensor]:
        """Score the candidates: (pairs, feasible bool[N])."""
        m = self.m
        B, R, D, N = m.B, m.R, m.D, self.N
        views = gather_views(ss, m, torch.zeros(2 * N, dtype=torch.long, device=m.device),
                             torch.cat([pa, pb]))
        va, vb = view_rows(views, slice(0, N)), view_rows(views, slice(N, 2 * N))
        r1, r2 = r1.long(), r2.long()
        x, y = _at(va.assign, r1), _at(vb.assign, r2)
        sx, sy = x.clamp(0, B - 1).long(), y.clamp(0, B - 1).long()
        excl_lead = m.broker_excl_leadership
        ok_sw = (
            (pa != pb) & va.pvalid & vb.pvalid & ~va.immovable & ~vb.immovable
            & (x >= 0) & (y >= 0) & (x != y) & self.recv_ok[sx] & self.recv_ok[sy]
            & ~(va.assign == y[:, None]).any(1) & ~(vb.assign == x[:, None]).any(1)
            & ~((r1 == va.leader) & excl_lead[sy]) & ~((r2 == vb.leader) & excl_lead[sx])
        )
        if D > 1:
            gd = _gumbel(d.u_disk)
            neg_inf = float("-inf")
            d1 = torch.where(m.disk_alive[sy], gd[:, 0], neg_inf).argmax(1).int()
            d2 = torch.where(m.disk_alive[sx], gd[:, 1], neg_inf).argmax(1).int()
        else:
            d1 = d2 = torch.zeros_like(x)
        # the leadership transfer mirrors a single MOVE_LEADERSHIP's checks
        ok_ld = va.pvalid & ~va.immovable & (x >= 0) & (r1 != va.leader) & self.lead_allowed[sx]
        sw = self.is_swap
        at1, at2 = _slot_mask(r1, R), _slot_mask(r2, R)
        sw_rows = sw[:, None]
        olda = (va.assign, va.leader, va.disk)
        newa = (
            torch.where(sw_rows & at1, y[:, None], va.assign),
            torch.where(sw, va.leader, r1.int()),
            torch.where(sw_rows & at1, d1[:, None], va.disk),
        )
        oldb = _inert(sw, (vb.assign, vb.leader, vb.disk))
        newb = _inert(sw, (
            torch.where(at2, x[:, None], vb.assign), vb.leader,
            torch.where(at2, d2[:, None], vb.disk),
        ))
        deltas = self.swap_scorer(
            ss, torch.zeros(N, dtype=torch.long, device=m.device), va, olda, newa, vb, oldb, newb
        )
        pairs = Pairs(pa=pa, va=va, olda=olda, newa=newa, deltas=deltas,
                      pb=pb, vb=vb, oldb=oldb, newb=newb)
        return pairs, torch.where(sw, ok_sw, ok_ld)

    def __call__(self, ss: SearchState, d: SwapPolishDraws, guard_on: bool,
                 live: torch.Tensor | None = None) -> torch.Tensor:
        """Run one iteration in place, nothing applied where ``live`` (a
        device bool, default True) is False; returns the candidates applied
        (an int tensor; 0: none improved)."""
        if live is None:
            live = torch.ones((), dtype=torch.bool, device=self.m.device)
        pairs, feas = self.plan(ss, d, *self.candidates(ss, d))
        safe, write_a = _descend(
            ss, self.m, self.group, pairs, feas, self.hard_arr, guard_on, self.guard_cols,
            self.vector_fn, self.n_batch, dual=self.is_swap, live=live,
        )
        sw = self.is_swap[safe]
        n_sw = (write_a & sw).sum().int()
        n_ld = (write_a & ~sw).sum().int()
        ss.n_prop_kind[0] += self.proposed * live.int()
        ss.n_acc_kind[0] += torch.stack([n_ld, n_sw, torch.zeros_like(n_sw)])
        return n_sw + n_ld


def swap_polish(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts: SwapPolishOptions = SwapPolishOptions(),
    *,
    init: tuple[SearchState, StackResult] | None = None,
    defer_stack_after: bool = False,
) -> GreedyResult:
    """Run the usage-coupled swap-polish descent to a local optimum.

    Only lex-improving, hard-safe candidates are applied, so the result is
    never lexicographically worse than the input, and every broker keeps its
    replica count (replica swaps exchange brokers, leadership transfers move
    no replica). Intra-broker-only stacks have no swap space.

    ``init`` is an optional ``(state, stack_before)`` of ``m`` from a caller
    that already evaluated it (the warm pipeline's fused init, which shares
    one aggregates launch); the state is run in place.
    ``defer_stack_after`` skips the final evaluation (``stack_after`` is
    None) for a caller that evaluates after a later stage anyway."""
    if not allows_inter_broker(goal_names):
        raise ValueError(
            "swap_polish proposes inter-broker swaps; intra-broker-only stacks must not run it"
        )
    step = SwapPolishIteration(m, cfg, goal_names, opts)
    if init is not None:
        ss, stack_before = init
    else:
        stack_before = evaluate_stack(m, cfg, goal_names)
        ss = init_search_state(m, cfg, goal_names, group=step.group)
    gen = torch.Generator(device=m.device)
    gen.manual_seed(opts.seed + 1)

    def iteration(live: torch.Tensor) -> torch.Tensor:
        return step(ss, draw_swap_polish(gen, m, step.N), opts.trd_guard, live)

    n_iters, moves, convergence = _drive_descent(iteration, ss, goal_names, opts, m.device,
                                                 "swap-polish", gen)
    result_model = with_placement(m, ss)
    n_prop_kind, n_acc_kind = _kind_counts(ss)
    return GreedyResult(
        model=result_model,
        stack_before=stack_before,
        stack_after=None if defer_stack_after else evaluate_stack(result_model, cfg, goal_names),
        n_moves=moves,
        n_iters=n_iters,
        n_prop_kind=n_prop_kind,
        n_acc_kind=n_acc_kind,
        convergence=convergence,
    )
