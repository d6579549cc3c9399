"""The optimizer entry point — the reference's GoalOptimizer.optimizations.

``optimize`` turns a cluster model into verified replica and leadership
proposals, in the JAX package's stages and order:

    stack_before -> hard_repair -> hot list -> anneal -> polish (+ repair
    rounds while hard violations remain; only the repair rounds when
    ``run_polish`` is off) -> portfolio (a cold greedy run from the input,
    kept if lexicographically better) -> topic-rebalance rounds (each a
    TopicReplicaDistribution shed plus a TRD-guarded re-polish, adopted only
    on a lexicographic improvement) -> swap-polish -> leadership pass ->
    swap-polish-post -> finalize_preferred_leaders -> columnar_diff ->
    verify_optimization

With ``warm_start`` (a ``ccx_torch.search.incremental.WarmStart``) and
``opts.incremental`` armed, ``optimize`` runs the warm pipeline instead:
the previous placement grafted onto the snapshot's metrics, a short
drift-targeted descent (repair and a plateau-terminated warm SA first when
the drift holds structural damage), preferred-leader finalize, the minimal
diff and the same verification; a warm result never ships lexicographically
behind its own base, nor unverified while its base verifies. When the base
cannot be applied it falls back to the cold pipeline and says why in
``OptimizerResult.incremental``. With ``plan_enabled`` every result carries
a wave-scheduled movement plan of its diff (``ccx_torch.search.movement``),
and ``plan_cost_tier`` breaks a lexicographic tie in the portfolio toward
the placement that moves fewer bytes.

Every call runs under a tracing root span (``ccx_torch.common.tracing``):
each stage is a child span, chunk heartbeats attach to it, and the
completed tree rides out as ``OptimizerResult.span_tree``. ``job=`` runs the
call as a fleet job (``ccx_torch.search.scheduler.FLEET``): its chunk
dispatches interleave with other jobs' at chunk boundaries, and a set
``cancel`` event ends it with ``JobCancelled`` at the next one.

With ``overlap_repair`` (and chunked SA with more steps than one chunk),
hard repair runs in a background thread while the first SA chunk anneals
the unrepaired input; the lexicographically better of the two continues.

Every result, cold or warm, carries a ``cost_model`` block
(``ccx_torch.common.costmodel``): the run's instrumented calls per program
and per phase, projected onto the card's roofline. With capture armed a
cold run also measures the first call of each new shape and reads the
measurements in a ``cost-capture`` phase; a warm run never captures. Each
phase runs under a named profiler range (``ccx_torch.common.profiling``).

It runs on the model's device (build the model on CUDA, the default, or pass
``device="cpu"`` to the model builder). ``OptimizeOptions`` carries the JAX
package's defaults for every field it has. The JAX package's device mesh is
not part of this pipeline; ``OptimizerResult.to_json`` leaves out its key
(``mesh``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from ccx_torch.common import costmodel
from ccx_torch.common.profiling import annotate
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack
from ccx_torch.model.stats import ClusterModelStats, balancedness_score, cluster_model_stats
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.proposals import ColumnarDiff, columnar_diff
from ccx_torch.search.annealer import AnnealOptions, allows_inter_broker, anneal, hot_partition_list
from ccx_torch.search.greedy import GreedyOptions, SwapPolishOptions, greedy_optimize, swap_polish
from ccx_torch.search.incremental import ColdStartRequired, IncrementalOptions, WarmStart
from ccx_torch.search.repair import finalize_preferred_leaders, hard_repair, topic_rebalance
from ccx_torch.search.state import MOVE_KIND_NAMES
from ccx_torch.verify import Verification, verify_optimization

#: goals the final leadership pass serves
LEADERSHIP_GOALS = frozenset(
    {
        "PreferredLeaderElectionGoal",
        "LeaderReplicaDistributionGoal",
        "LeaderBytesInDistributionGoal",
        "MinTopicLeadersPerBrokerGoal",
        "KafkaAssignerEvenRackAwareGoal",
    }
)


@dataclasses.dataclass(frozen=True)
class OptimizeOptions:
    anneal: AnnealOptions = AnnealOptions()
    polish: GreedyOptions = GreedyOptions(n_candidates=256, max_iters=400)
    run_polish: bool = True
    #: polish rounds in all while hard violations remain, each after a fresh
    #: hard_repair of the current placement
    max_repair_rounds: int = 3
    #: verification holds every hard goal at zero violations (off: no hard
    #: goal's violations may increase)
    require_hard_zero: bool = True
    #: hard repair's loop driver, by the JAX package's names (``"device"``
    #: or ``"host"``; the port's one driver serves both)
    repair_backend: str = "device"
    #: overlap hard repair with the first SA chunk: repair runs in a
    #: background thread while ``anneal.chunk_steps`` steps anneal the
    #: unrepaired input; the lexicographically better state continues with
    #: the remaining steps. Needs chunked SA with more steps than one chunk
    #: and inter-broker moves; skipped otherwise. On one card both threads
    #: launch onto one stream, so it buys no wall time there
    overlap_repair: bool = False
    #: verification checks that no replica is left on a dead broker
    #: (never for a stack that moves replicas within brokers only)
    check_evacuation: bool = True
    #: end with a leadership-only greedy pass
    run_leader_pass: bool = True
    #: shed-and-re-polish rounds of the TopicReplicaDistribution stage (0: off)
    topic_rebalance_rounds: int = 2
    #: sweep cap per round (the shed stops by itself once a sweep moves
    #: nothing; this bounds latency)
    topic_rebalance_max_sweeps: int = 1024
    #: let the shed move leader-held over cells by a leadership transfer
    topic_rebalance_move_leaders: bool = True
    #: re-polish with the TRD guard first, unguarded if that is not adopted
    topic_rebalance_guarded: bool = True
    #: re-polish iterations (None: polish.max_iters)
    topic_rebalance_polish_iters: int | None = None
    #: iteration cap of the final leadership pass (None: polish.max_iters)
    leader_pass_max_iters: int | None = None
    #: swap-polish iterations before the leadership pass (0: off)
    swap_polish_iters: int = 0
    #: swap-polish iterations after the leadership pass (0: off)
    swap_polish_post_iters: int = 0
    #: coupled candidates per swap-polish iteration, split evenly between
    #: replica-swap pairs and leadership transfers
    swap_polish_candidates: int = 128
    swap_polish_chunk_iters: int = 50
    swap_polish_guarded: bool = True
    #: also run a plain greedy from the input and keep the lexicographic
    #: winner (the portfolio)
    run_cold_greedy: bool = True
    #: the warm pipeline's knobs (``optimize(warm_start=...)``); inert on
    #: cold runs
    incremental: IncrementalOptions = dataclasses.field(default_factory=IncrementalOptions)
    #: wave-schedule the diff into a movement plan (``OptimizerResult.plan``)
    plan_enabled: bool = False
    #: break a lexicographic tie in the portfolio by (bytes moved, peak
    #: per-broker inflow) from the input placement
    plan_cost_tier: bool = False
    #: waves of the plan's per-wave state
    plan_max_waves: int = 64
    #: per-broker concurrent moves per wave
    plan_broker_cap: int = 5
    #: per-broker per-wave byte budget in model load units (MB); <= 0:
    #: uncapped
    plan_wave_bytes_mb: float = 0.0
    #: replication rate that prices the waves in seconds; <= 0: byte units
    plan_throttle_mb_per_sec: float = 0.0


@dataclasses.dataclass
class OptimizerResult:
    diff: ColumnarDiff
    stack_before: StackResult
    stack_after: StackResult
    verification: Verification
    model: TensorClusterModel
    wall_seconds: float
    n_sa_accepted: int
    n_polish_moves: int
    #: wall seconds per pipeline stage, each ended by a device synchronize
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    #: per-move-kind proposal/acceptance counts over every search stage
    move_counters: dict = dataclasses.field(default_factory=dict)
    #: the SA step engine that ran (``annealer.step_engine``)
    sa_engine: str = ""
    #: warm runs, and cold runs that were asked to start warm: the warm
    #: pipeline's report or the reason it fell back
    incremental: dict | None = None
    #: ``{"goals": [...], "phases": {phase: [segment, ...]}}``: the decoded
    #: convergence taps of every chunked engine run, by pipeline phase
    convergence: dict | None = None
    #: warm runs: the float32[6, B] pressure stack of the shipped placement
    #: under the shipped metrics, for the next window's ``remember``
    warm_pressure: torch.Tensor | None = None
    #: the movement plan of the diff (``plan_enabled``)
    plan: object | None = None
    #: the input model, kept so the ClusterModelStats blocks can be
    #: derived lazily (each costs an aggregates launch and a host copy)
    input_model: TensorClusterModel | None = None
    #: the completed span tree of this ``optimize`` call
    span_tree: dict | None = None
    #: the cost ledger's rollup of this call (``costmodel.cost_model_json``)
    cost_model: dict | None = None

    @property
    def stats_before(self) -> ClusterModelStats | None:
        if self.input_model is None:
            return None
        if not hasattr(self, "_stats_before"):
            self._stats_before = cluster_model_stats(self.input_model)
        return self._stats_before

    @property
    def stats_after(self) -> ClusterModelStats | None:
        if not hasattr(self, "_stats_after"):
            self._stats_after = cluster_model_stats(self.model)
        return self._stats_after

    @property
    def num_replica_movements(self) -> int:
        return self.diff.num_replica_movements

    @property
    def num_leadership_movements(self) -> int:
        return self.diff.num_leadership_movements

    def violation_summary(self) -> dict[str, float]:
        return {n: v for n, (v, _) in self.stack_after.by_name().items() if v > 0}

    def goal_summary_columnar(self) -> dict:
        """``goalSummary`` as flat typed arrays (the streamed result's
        form): one vector per column; values are float32 on the wire, the
        goal names a plain list."""
        before = self.stack_before.by_name()
        after = self.stack_after.by_name()
        names = list(self.stack_after.names)
        return {
            "goal": names,
            "hard": np.array([bool(GOAL_REGISTRY[n].hard) for n in names], np.uint8),
            "violationsBefore": np.array([before[n][0] for n in names], np.float32),
            "violationsAfter": np.array([after[n][0] for n in names], np.float32),
            "costBefore": np.array([before[n][1] for n in names], np.float32),
            "costAfter": np.array([after[n][1] for n in names], np.float32),
        }

    def to_json(
        self,
        include_proposals: bool = True,
        include_stats: bool = True,
        include_goal_summary: bool = True,
    ) -> dict:
        """The result block of the sidecar's wire, keyed as the JAX
        package's (``mesh`` is never present).
        ``include_stats=False`` omits the ClusterModelStats blocks (each an
        aggregates launch and a host copy; the sidecar omits them from warm
        results); ``include_proposals=False`` omits the per-row dicts
        (columnar consumers); ``include_goal_summary=False`` omits the
        per-goal dicts (the streamed result ships
        ``goal_summary_columnar`` instead)."""
        before = self.stack_before.by_name()
        after = self.stack_after.by_name()
        out: dict = {}
        if include_proposals:
            out["proposals"] = self.diff.rows_json()
        out["numReplicaMovements"] = self.num_replica_movements
        out["numLeadershipMovements"] = self.num_leadership_movements
        if include_goal_summary:
            out["goalSummary"] = [
                {
                    "goal": n,
                    "hard": GOAL_REGISTRY[n].hard,
                    "violationsBefore": before[n][0],
                    "violationsAfter": after[n][0],
                    "costBefore": before[n][1],
                    "costAfter": after[n][1],
                }
                for n in self.stack_after.names
            ]
        out["verified"] = self.verification.ok
        out["verificationFailures"] = self.verification.failures
        out["optimizationFailures"] = self.verification.infeasible
        out["wallSeconds"] = self.wall_seconds
        out["phaseSeconds"] = {k: round(v, 3) for k, v in self.phase_seconds.items()}
        out["moveCounters"] = self.move_counters
        if self.plan is not None:
            out["plan"] = self.plan.summary_json()
        for key, val in (
            ("spanTree", self.span_tree),
            ("incremental", self.incremental),
            ("convergence", self.convergence),
            ("costModel", self.cost_model),
        ):
            if val:
                out[key] = val
        if include_stats and self.stats_before is not None and self.stats_after is not None:
            out["clusterModelStats"] = {
                "before": self.stats_before.to_json(),
                "after": self.stats_after.to_json(),
            }
            out["onDemandBalancednessScoreBefore"] = balancedness_score(self.stats_before)
            out["onDemandBalancednessScoreAfter"] = balancedness_score(self.stats_after)
        return out


def _lex_better(a: StackResult, b: StackResult) -> bool:
    """True when a's (hard violations, cost vector) beats b's
    lexicographically (hard feasibility outranks every soft tier)."""
    ka = [float(a.hard_violations)] + a.costs.tolist()
    kb = [float(b.hard_violations)] + b.costs.tolist()
    tol = 1e-6
    for x, y in zip(ka, kb):
        if x < y - tol:
            return True
        if x > y + tol:
            return False
    return False


def _movement_lex_better(a_stack, a_model, b_stack, b_model, m, opts: OptimizeOptions) -> bool:
    """``_lex_better`` with the movement-cost tier appended: only a full
    lexicographic tie falls through to (bytes moved, peak per-broker
    inflow) of each candidate from the input ``m``. With
    ``plan_cost_tier`` off this is ``_lex_better``."""
    if _lex_better(a_stack, b_stack):
        return True
    if not opts.plan_cost_tier or _lex_better(b_stack, a_stack):
        return False
    from ccx_torch.search.movement import movement_cost

    tol = 1e-6
    for x, y in zip(movement_cost(m, a_model), movement_cost(m, b_model)):
        if x < y - tol:
            return True
        if x > y + tol:
            return False
    return False


def _compute_plan(m: TensorClusterModel, dcols: ColumnarDiff, opts: OptimizeOptions):
    """The plan phase: wave-schedule the shipped diff under the executor's
    caps (``ccx_torch.search.movement``). A failure propagates."""
    from ccx_torch.common.resources import Resource
    from ccx_torch.search.movement import PlanOptions, plan_movement

    return plan_movement(
        dcols,
        m.leader_load[Resource.DISK],
        int(m.B),
        PlanOptions(
            broker_cap=opts.plan_broker_cap,
            wave_bytes=opts.plan_wave_bytes_mb,
            max_waves=opts.plan_max_waves,
            throttle_mb_per_sec=opts.plan_throttle_mb_per_sec,
        ),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Run:
    """The bookkeeping one pipeline run shares between its stages: phase
    seconds, the per-move-kind counters and the convergence segments by
    phase. Each phase calls ``progress_cb(name)`` as it starts, runs under
    a tracing span and a named profiler range, and ends with a device
    synchronize, so its span wall (the ``phase_seconds`` entry) covers its
    device work."""

    def __init__(self, device: torch.device, progress_cb=None) -> None:
        self.device = device
        self.progress_cb = progress_cb
        self.phases: dict[str, float] = {}
        self.kind_prop = [0, 0, 0]
        self.kind_acc = [0, 0, 0]
        self.conv_phases: dict[str, list] = {}

    def tally(self, r, phase: str | None = None) -> None:
        for i in range(3):
            self.kind_prop[i] += int(r.n_prop_kind[i])
            self.kind_acc[i] += int(r.n_acc_kind[i])
        if phase is not None and getattr(r, "convergence", None):
            self.conv_phases.setdefault(phase, []).append(r.convergence)

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        if self.progress_cb is not None:
            self.progress_cb(name)
        s = TRACER.start(name, kind="phase", device=self.device, **attrs)
        try:
            with annotate(f"ccx:{name}", self.device):
                yield
            _sync(self.device)
        finally:
            TRACER.end(s)
            self.phases[name] = s.wall_s

    def move_counters(self) -> dict:
        return {
            name: {"proposed": self.kind_prop[i], "accepted": self.kind_acc[i]}
            for i, name in enumerate(MOVE_KIND_NAMES)
        }

    def convergence(self, goal_names) -> dict | None:
        if not self.conv_phases:
            return None
        return {"goals": list(goal_names), "phases": self.conv_phases}


def optimize(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts: OptimizeOptions = OptimizeOptions(),
    warm_start: WarmStart | None = None,
    progress_cb=None,
    job: tuple[str, int] | str | None = None,
    cancel: threading.Event | None = None,
) -> OptimizerResult:
    """Full-stack proposal computation: hard-goal repair sweeps establish
    feasibility, batched SA balances the soft goals without breaking hard
    ones, greedy polish and leadership passes clean up residuals, and the
    result is diffed and verified. With ``warm_start`` and
    ``opts.incremental`` armed, the warm pipeline (module docstring).

    ``progress_cb(phase)`` is called as each phase starts. ``job`` (a
    cluster id, or ``(cluster_id, priority)``) registers the call on the
    fleet scheduler for its whole duration, and ``cancel`` (an event the
    transport sets when its client goes away) cancels it at the next chunk
    boundary with ``JobCancelled``. With no other job registered the
    scheduled run equals the unscheduled one."""
    if job is not None:
        from ccx_torch.search.scheduler import FLEET

        cluster_id, priority = job if isinstance(job, tuple) else (job, 0)
        with FLEET.job(str(cluster_id), int(priority), cancel_event=cancel):
            return optimize(m, cfg, goal_names, opts, warm_start, progress_cb)
    cost0 = costmodel.exec_snapshot()
    warm = warm_start if (warm_start is not None and opts.incremental.armed) else None
    root = TRACER.start(
        "optimize", kind="op", P=int(m.P), B=int(m.B), goals=len(goal_names),
        **({"warm": True} if warm is not None else {}),
    )
    try:
        res = None
        if warm is not None:
            try:
                res = _optimize_warm(m, cfg, goal_names, opts, warm, progress_cb)
            except ColdStartRequired as e:
                res = _optimize(m, cfg, goal_names, opts, progress_cb)
                res = dataclasses.replace(
                    res, incremental={"warmStart": False, "coldStart": True, "reason": str(e)}
                )
        if res is None:
            res = _optimize(m, cfg, goal_names, opts, progress_cb)
    finally:
        # the root closes on every exit path: a leaked root would nest
        # every later call on this thread under a dead tree
        TRACER.end(root)
    # rendered after the cold run's cost-capture phase banked its records,
    # so the phase spans price them too
    tree = root.to_json()
    cost_model = costmodel.cost_model_json(costmodel.exec_delta(cost0), tree, m.device)
    return dataclasses.replace(res, span_tree=tree, cost_model=cost_model)


def _optimize(
    m: TensorClusterModel,
    cfg: GoalConfig,
    goal_names: tuple[str, ...],
    opts: OptimizeOptions,
    progress_cb=None,
) -> OptimizerResult:
    """The cold pipeline (module docstring), the one place the cost ledger
    captures."""
    with costmodel.cold_window():
        return _optimize_cold(m, cfg, goal_names, opts, progress_cb)


class _BackgroundRepair:
    """``hard_repair`` of ``m`` in a background thread (``overlap_repair``),
    started at construction."""

    def __init__(self, m, cfg, goal_names, backend: str) -> None:
        self._box: dict = {}
        dev = m.device

        def repair() -> None:
            t_bg = time.monotonic()
            try:
                # the current CUDA device is per thread
                with (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                    with costmodel.cold_window():
                        self._box["res"] = hard_repair(m, cfg, goal_names, backend=backend)
                        _sync(dev)
            except BaseException as e:  # noqa: BLE001 — re-raised by the joining thread
                self._box["err"] = e
            self._box["wall"] = time.monotonic() - t_bg

        self._thread = threading.Thread(target=repair, name="ccx-overlap-repair", daemon=True)
        self._thread.start()

    def join(self) -> None:
        self._thread.join()

    def result(self, run: _Run) -> tuple[TensorClusterModel, int]:
        """Join, record ``repair-join`` (the wait) and ``repair-concurrent``
        (the thread's wall), and return (repaired model, moves); the
        thread's exception is raised here with its own traceback."""
        t_join = time.monotonic()
        self.join()
        run.phases["repair-join"] = time.monotonic() - t_join
        run.phases["repair-concurrent"] = self._box.get("wall", 0.0)
        if "err" in self._box:
            raise self._box["err"]
        return self._box["res"]


def _anneal_overlapped(m, cfg, goal_names, anneal_opts: AnnealOptions, run: _Run,
                       bg: _BackgroundRepair):
    """The first SA chunk anneals the unrepaired ``m`` while ``bg`` repairs
    it; the lexicographically better of the two anneals the remaining steps
    (seed + 1). Returns (the SA result, the repair moves it carries)."""
    chunk = anneal_opts.chunk_steps
    # no hot list is passed: anneal() lists the unrepaired input's offenders
    sa1 = anneal(m, cfg, goal_names, dataclasses.replace(anneal_opts, n_steps=chunk))
    run.tally(sa1, "anneal")
    repaired, n_repair = bg.result(run)
    if _lex_better(sa1.stack_after, evaluate_stack(repaired, cfg, goal_names)):
        # the repaired state is dropped, so its moves are not in the result
        start, n_sa1, n_repair = sa1.model, sa1.n_accepted, 0
    else:
        start, n_sa1 = repaired, 0
    sa = anneal(start, cfg, goal_names, dataclasses.replace(
        anneal_opts, n_steps=anneal_opts.n_steps - chunk, seed=anneal_opts.seed + 1))
    return dataclasses.replace(sa, n_accepted=sa.n_accepted + n_sa1), n_repair


def _optimize_cold(
    m: TensorClusterModel,
    cfg: GoalConfig,
    goal_names: tuple[str, ...],
    opts: OptimizeOptions,
    progress_cb=None,
) -> OptimizerResult:
    from ccx_torch.common.faults import FAULTS

    # chaos seam: the cold pipeline's entry stands in for a failed build
    # or launch — the RPC fails structured, nothing is banked
    if FAULTS.armed:
        FAULTS.hit("compile")
    t0 = time.monotonic()
    run = _Run(m.device, progress_cb)
    phase, tally = run.phase, run.tally

    inter = allows_inter_broker(goal_names)
    backend = opts.repair_backend
    overlap = (
        opts.overlap_repair and inter and opts.anneal.chunk_steps > 0
        and opts.anneal.n_steps > opts.anneal.chunk_steps
    )
    with phase("stack-before"):
        stack_before = evaluate_stack(m, cfg, goal_names)
    if overlap:
        # the repair phase starts the thread; the first anneal chunk runs
        # beside it and the anneal phase joins it
        with phase("repair", backend=backend, overlap=True):
            bg = _BackgroundRepair(m, cfg, goal_names, backend)
        try:
            with phase("anneal"):
                sa, n_polish = _anneal_overlapped(m, cfg, goal_names, opts.anneal, run, bg)
        finally:
            # never leave the thread running past a failed or cancelled anneal
            bg.join()
    else:
        with phase("repair", backend=backend, overlap=False):
            model, n_polish = hard_repair(m, cfg, goal_names, backend=backend)
        with phase("hot-list"):
            evac = hot_partition_list(model, goal_names, cfg) if inter else None
        with phase("anneal"):
            sa = anneal(model, cfg, goal_names, opts.anneal, evac=evac)
    tally(sa, "anneal")
    model, stack_after = sa.model, sa.stack_after
    with phase("polish"):
        if opts.run_polish:
            polish = greedy_optimize(model, cfg, goal_names, opts.polish)
            tally(polish, "polish")
            model, stack_after = polish.model, polish.stack_after
            n_polish += polish.n_moves
        # the repair retries run with the polish off too
        for _ in range(max(opts.max_repair_rounds - 1, 0)):
            if float(stack_after.hard_violations) <= 0:
                break
            model, n_r = hard_repair(model, cfg, goal_names, backend=backend)
            n_polish += n_r
            if not opts.run_polish:
                if n_r == 0:
                    break
                stack_after = evaluate_stack(model, cfg, goal_names)
                continue
            polish = greedy_optimize(model, cfg, goal_names, opts.polish)
            tally(polish, "polish")
            if polish.n_moves == 0 and n_r == 0:
                break
            model, stack_after = polish.model, polish.stack_after
            n_polish += polish.n_moves
    if opts.run_cold_greedy:
        with phase("portfolio"):
            cold = greedy_optimize(m, cfg, goal_names, opts.polish)
            tally(cold, "portfolio")
            if _movement_lex_better(cold.stack_after, cold.model, stack_after, model, m, opts):
                model, stack_after = cold.model, cold.stack_after
                # the result is the cold run's, started from the input
                n_polish = cold.n_moves
    if opts.topic_rebalance_rounds > 0 and "TopicReplicaDistributionGoal" in goal_names and inter:
        with phase("topic-rebalance"):
            repolish = opts.polish
            if opts.topic_rebalance_polish_iters is not None:
                repolish = dataclasses.replace(opts.polish, max_iters=opts.topic_rebalance_polish_iters)
            for _ in range(opts.topic_rebalance_rounds):
                swept, n_swept = topic_rebalance(
                    model, cfg,
                    max_sweeps=opts.topic_rebalance_max_sweeps,
                    move_leaders=opts.topic_rebalance_move_leaders,
                )
                if not n_swept:
                    break
                # the guarded re-polish recovers the usage tiers without
                # trading the shed's topic cells back; unguarded if the
                # guarded move space is not adopted
                cand = greedy_optimize(
                    swept, cfg, goal_names, repolish, trd_guard=opts.topic_rebalance_guarded
                )
                tally(cand, "topic-rebalance")
                if opts.topic_rebalance_guarded and not _lex_better(cand.stack_after, stack_after):
                    cand = greedy_optimize(swept, cfg, goal_names, repolish)
                    tally(cand, "topic-rebalance")
                if not _lex_better(cand.stack_after, stack_after):
                    break
                model, stack_after = cand.model, cand.stack_after
                n_polish += n_swept + cand.n_moves

    def run_swap_polish(model_in, iters: int, name: str):
        with phase(name):
            ksw = max(opts.swap_polish_candidates // 2, 1)
            sp = swap_polish(model_in, cfg, goal_names, SwapPolishOptions(
                n_swap_candidates=ksw,
                n_lead_candidates=max(opts.swap_polish_candidates - ksw, 0),
                max_iters=iters,
                trd_guard=opts.swap_polish_guarded,
                chunk_iters=opts.swap_polish_chunk_iters,
            ))
            tally(sp, name)
        return sp

    if opts.swap_polish_iters > 0 and inter:
        sp = run_swap_polish(model, opts.swap_polish_iters, "swap-polish")
        model, stack_after = sp.model, sp.stack_after
        n_polish += sp.n_moves
    if opts.run_leader_pass and LEADERSHIP_GOALS & set(goal_names) and inter:
        with phase("leader-pass"):
            iters = opts.polish.max_iters
            if opts.leader_pass_max_iters is not None:
                iters = min(opts.leader_pass_max_iters, iters)
            lead = greedy_optimize(
                model, cfg, goal_names,
                dataclasses.replace(opts.polish, leadership_only=True, max_iters=iters),
            )
            tally(lead, "leader-pass")
            model, stack_after = lead.model, lead.stack_after
            n_polish += lead.n_moves
    if opts.swap_polish_post_iters > 0 and inter:
        sp = run_swap_polish(model, opts.swap_polish_post_iters, "swap-polish-post")
        model, stack_after = sp.model, sp.stack_after
        n_polish += sp.n_moves
    with phase("preferred-leader"):
        model, stack_after, _ = finalize_preferred_leaders(model, cfg, goal_names, stack_after)
    with phase("diff"):
        dcols = columnar_diff(m, model)
    plan = None
    if opts.plan_enabled:
        with phase("plan"):
            plan = _compute_plan(m, dcols, opts)
    with phase("verify"):
        verification = verify_optimization(
            m, model, cfg, goal_names,
            proposals=dcols,
            # a stack that moves replicas within brokers only cannot
            # evacuate a dead broker
            check_evacuation=opts.check_evacuation and inter,
            stack_before=stack_before,
            stack_after=stack_after,
            require_hard_zero=opts.require_hard_zero,
        )
    if costmodel.capture_enabled() and costmodel.pending_count():
        # read the first calls this cold run measured (cold path only: a
        # warm run measures nothing)
        with phase("cost-capture", pending=costmodel.pending_count()):
            costmodel.capture_pending()
    return OptimizerResult(
        diff=dcols,
        stack_before=stack_before,
        stack_after=stack_after,
        verification=verification,
        model=model,
        wall_seconds=time.monotonic() - t0,
        n_sa_accepted=sa.n_accepted,
        n_polish_moves=n_polish,
        phase_seconds=run.phases,
        move_counters=run.move_counters(),
        sa_engine=sa.engine,
        convergence=run.convergence(goal_names),
        plan=plan,
        input_model=m,
    )


def _optimize_warm(
    m: TensorClusterModel,
    cfg: GoalConfig,
    goal_names: tuple[str, ...],
    opts: OptimizeOptions,
    warm: WarmStart,
    progress_cb=None,
) -> OptimizerResult:
    """The warm pipeline: ``incremental.reoptimize``'s search, preferred-
    leader finalize, one fused evaluation of the final placement (with the
    next window's pressure bank), the revert guards, the minimal diff, the
    verification and the plan. Raises ``ColdStartRequired`` when the warm
    base cannot be applied."""
    from ccx_torch.search import incremental as inc

    t0 = time.monotonic()
    run = _Run(m.device, progress_cb)
    phase = run.phase
    inter = allows_inter_broker(goal_names)
    (model, stack_before, stack_after, search, info, base_model, bank_press,
     n_engine_moves) = inc.reoptimize(
        m, warm, cfg, goal_names, opts.incremental, opts, phase=phase, tally=run.tally,
    )
    with phase("preferred-leader"):
        model, stack_after, _ = finalize_preferred_leaders(
            model, cfg, goal_names, stack_after, reevaluate=False
        )
    if stack_after is None:
        with phase("warm-finish"):
            stack_after, bank_press = inc.warm_finish(model, cfg, goal_names)
    # never ship a warm result significantly lex-behind its own (repaired)
    # base: the base is then the better proposal
    if inc._significantly_lex_worse(stack_after, stack_before):
        model = base_model
        stack_after = stack_before
        bank_press = None  # scanned off the unshipped model
        n_engine_moves = 0
        info["reverted"] = "lex"
    with phase("diff"):
        dcols = columnar_diff(m, model)
    with phase("verify"):
        verification = verify_optimization(
            m, model, cfg, goal_names,
            proposals=dcols,
            check_evacuation=opts.check_evacuation and inter,
            stack_before=stack_before,
            stack_after=stack_after,
            require_hard_zero=opts.require_hard_zero,
        )
        if not verification.ok:
            # a lex-legitimate trade the per-goal verifier rejects: ship the
            # (repaired) base, whose diff is the no-op or repair-only plan,
            # when it verifies
            base_diff = columnar_diff(m, base_model)
            base_verification = verify_optimization(
                m, base_model, cfg, goal_names,
                proposals=base_diff,
                check_evacuation=opts.check_evacuation and inter,
                stack_before=stack_before,
                stack_after=stack_before,
                require_hard_zero=opts.require_hard_zero,
            )
            if base_verification.ok:
                model = base_model
                stack_after = stack_before
                dcols = base_diff
                verification = base_verification
                bank_press = None
                n_engine_moves = 0
                info["reverted"] = "verification"
    plan = None
    if opts.plan_enabled:
        # every warm window plans its own diff, after any revert
        with phase("plan"):
            plan = _compute_plan(m, dcols, opts)
    info["diffSize"] = dcols.n
    return OptimizerResult(
        diff=dcols,
        stack_before=stack_before,
        stack_after=stack_after,
        verification=verification,
        model=model,
        wall_seconds=time.monotonic() - t0,
        n_sa_accepted=getattr(search, "n_accepted", 0),
        n_polish_moves=n_engine_moves,
        phase_seconds=run.phases,
        move_counters=run.move_counters(),
        sa_engine=getattr(search, "engine", ""),
        incremental=info,
        convergence=run.convergence(goal_names),
        warm_pressure=bank_press,
        plan=plan,
        input_model=m,
    )
