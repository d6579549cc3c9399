"""The optimizer entry point — the reference's GoalOptimizer.optimizations.

``optimize`` turns a cluster model into verified replica and leadership
proposals, in these stages:

    stack_before -> hard_repair -> hot list -> anneal -> polish (+ repair
    rounds while hard violations remain) -> leadership pass ->
    finalize_preferred_leaders -> columnar_diff -> verify_optimization

It runs on the model's device (build the model on CUDA, the default, or pass
``device="cpu"`` to the model builder). ``OptimizeOptions`` holds the effort
of the searches; the topic-rebalance stage, the cold-greedy portfolio, the
swap polish, the warm pipeline, the movement plan and the device mesh of the
JAX package are not part of this pipeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, StackResult, evaluate_stack
from ccx_torch.model.tensor_model import TensorClusterModel
from ccx_torch.proposals import ColumnarDiff, columnar_diff
from ccx_torch.search.annealer import AnnealOptions, allows_inter_broker, anneal, hot_partition_list
from ccx_torch.search.greedy import GreedyOptions, greedy_optimize
from ccx_torch.search.repair import finalize_preferred_leaders, hard_repair
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


#: polish rounds in all while hard violations remain, each after a fresh
#: hard_repair of the current placement
MAX_REPAIR_ROUNDS = 3


@dataclasses.dataclass(frozen=True)
class OptimizeOptions:
    anneal: AnnealOptions = AnnealOptions()
    polish: GreedyOptions = GreedyOptions(n_candidates=256, max_iters=400)
    #: iteration cap of the final leadership pass (None: polish.max_iters)
    leader_pass_max_iters: int | None = None


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

    @property
    def num_replica_movements(self) -> int:
        return self.diff.num_replica_movements

    @property
    def num_leadership_movements(self) -> int:
        return self.diff.num_leadership_movements


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def optimize(
    m: TensorClusterModel,
    cfg: GoalConfig = GoalConfig(),
    goal_names: tuple[str, ...] = DEFAULT_GOAL_ORDER,
    opts: OptimizeOptions = OptimizeOptions(),
) -> OptimizerResult:
    """Full-stack proposal computation: hard-goal repair sweeps establish
    feasibility, batched SA balances the soft goals without breaking hard
    ones, greedy polish and leadership passes clean up residuals, and the
    result is diffed and verified."""
    t0 = time.monotonic()
    phases: dict[str, float] = {}
    kind_prop = [0, 0, 0]
    kind_acc = [0, 0, 0]

    def tally(r) -> None:
        for i in range(3):
            kind_prop[i] += int(r.n_prop_kind[i])
            kind_acc[i] += int(r.n_acc_kind[i])

    @contextlib.contextmanager
    def phase(name: str):
        start = time.monotonic()
        yield
        _sync(m.device)
        phases[name] = time.monotonic() - start

    inter = allows_inter_broker(goal_names)
    with phase("stack-before"):
        stack_before = evaluate_stack(m, cfg, goal_names)
    with phase("repair"):
        model, n_polish = hard_repair(m, cfg, goal_names)
    with phase("hot-list"):
        evac = hot_partition_list(model, goal_names, cfg) if inter else None
    with phase("anneal"):
        sa = anneal(model, cfg, goal_names, opts.anneal, evac=evac)
    tally(sa)
    model, stack_after = sa.model, sa.stack_after
    with phase("polish"):
        polish = greedy_optimize(model, cfg, goal_names, opts.polish)
        tally(polish)
        model, stack_after = polish.model, polish.stack_after
        n_polish += polish.n_moves
        for _ in range(MAX_REPAIR_ROUNDS - 1):
            if float(stack_after.hard_violations) <= 0:
                break
            model, n_r = hard_repair(model, cfg, goal_names)
            n_polish += n_r
            polish = greedy_optimize(model, cfg, goal_names, opts.polish)
            tally(polish)
            if polish.n_moves == 0 and n_r == 0:
                break
            model, stack_after = polish.model, polish.stack_after
            n_polish += polish.n_moves
    if LEADERSHIP_GOALS & set(goal_names) and inter:
        with phase("leader-pass"):
            iters = opts.polish.max_iters
            if opts.leader_pass_max_iters is not None:
                iters = min(opts.leader_pass_max_iters, iters)
            lead = greedy_optimize(
                model, cfg, goal_names,
                dataclasses.replace(opts.polish, leadership_only=True, max_iters=iters),
            )
            tally(lead)
            model, stack_after = lead.model, lead.stack_after
            n_polish += lead.n_moves
    with phase("preferred-leader"):
        model, stack_after, _ = finalize_preferred_leaders(model, cfg, goal_names, stack_after)
    with phase("diff"):
        dcols = columnar_diff(m, model)
    with phase("verify"):
        verification = verify_optimization(
            m, model, cfg, goal_names,
            proposals=dcols,
            # a stack that moves replicas within brokers only cannot
            # evacuate a dead broker
            check_evacuation=inter,
            stack_before=stack_before,
            stack_after=stack_after,
        )
    return OptimizerResult(
        diff=dcols,
        stack_before=stack_before,
        stack_after=stack_after,
        verification=verification,
        model=model,
        wall_seconds=time.monotonic() - t0,
        n_sa_accepted=sa.n_accepted,
        n_polish_moves=n_polish,
        phase_seconds=phases,
        move_counters={
            name: {"proposed": kind_prop[i], "accepted": kind_acc[i]}
            for i, name in enumerate(MOVE_KIND_NAMES)
        },
    )
