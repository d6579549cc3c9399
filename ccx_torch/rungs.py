"""The effort ladder of the JAX package's bench (``bench.py``'s ``RUNGS`` and
``build_opts``), as the port's options: one construction site for every
caller that runs a rung.

A rung fixes the SA effort (chains, steps, moves per step), the polish
budget and the pipeline stages:

* ``target``: the least effort that verifies with every goal improving: no
  topic-rebalance stage, no portfolio, leader pass capped at 100;
* ``lean``: the pre-shed polish skipped (where the stack scores
  TopicReplicaDistribution), one converged leader-moving shed with a
  700-iteration TRD-guarded re-polish, swap polish 150 before and 300 after
  the leadership pass, leader pass capped at 150;
* ``full``: the JAX defaults for the stages (two shed rounds, the
  portfolio) at the largest effort; ``custom`` equals ``lean``'s stages
  with ``full``'s effort and the portfolio on.

``steady_options`` is the bench's steady-state warm budget,
``drift_metrics`` its drift rule for one metrics window, and
``wire_options`` a rung's options as a sidecar Propose's ``options`` map.

The bench's environment overrides (chains, steps, moves, polish iterations,
the portfolio switch) and its device mesh are not part of this copy.
"""

from __future__ import annotations

import numpy as np

from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.optimizer import OptimizeOptions
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions
from ccx_torch.search.incremental import IncrementalOptions

#: rung name -> (chains, steps, moves_per_step, polish_iters)
RUNGS = {
    "smoke": (8, 100, 1, 10),
    "target": (16, 250, 8, 150),
    "lean": (16, 500, 8, 400),
    "full": (32, 3000, 16, 1600),
    "custom": (32, 3000, 16, 1600),
}


def build_opts(name: str, rung: str) -> tuple[tuple[str, ...], OptimizeOptions, dict]:
    """(goal_names, OptimizeOptions, effort) of config ``name`` (B1..B6) at
    ``rung``."""
    goal_names = (
        ("StructuralFeasibility", "ReplicaDistributionGoal") if name == "B1" else DEFAULT_GOAL_ORDER
    )
    n_chains, n_steps, moves, polish_iters = RUNGS[rung]
    if rung == "target":
        stages = {"topic_rebalance_rounds": 0, "leader_pass_max_iters": 100}
    elif rung in ("lean", "custom"):
        stages = {
            "topic_rebalance_rounds": 1,
            "topic_rebalance_max_sweeps": 1024,
            "topic_rebalance_move_leaders": True,
            "topic_rebalance_polish_iters": 700,
            "swap_polish_iters": 150,
            "swap_polish_post_iters": 300,
            "leader_pass_max_iters": 150,
            # the shed's guarded re-polish does the polish's work
            "run_polish": "TopicReplicaDistributionGoal" not in goal_names,
        }
    else:
        stages = {}
    opts = OptimizeOptions(
        # chunks of 250 steps (one tap row each) except at the smoke rung;
        # a flat chunked run equals the one-loop run
        anneal=AnnealOptions(
            n_chains=n_chains, n_steps=n_steps, moves_per_step=moves, seed=42,
            chunk_steps=0 if rung == "smoke" else 250,
        ),
        polish=GreedyOptions(
            n_candidates=256, max_iters=polish_iters, patience=8 if rung == "target" else 16
        ),
        run_cold_greedy=rung in ("full", "custom"),
        **stages,
    )
    effort = {
        "chains": n_chains, "steps": n_steps, "moves": moves, "polish_iters": polish_iters,
        "portfolio": opts.run_cold_greedy,
        "trd_rounds": opts.topic_rebalance_rounds,
        "swap_polish": [opts.swap_polish_iters, opts.swap_polish_post_iters],
        "swap_coupling": opts.anneal.swap_coupling,
        "p_swap": opts.anneal.p_swap,
    }
    return goal_names, opts, effort


def steady_options(enabled: bool = True) -> IncrementalOptions:
    """The steady rung's warm budget (the bench's ``_steady_options``): 8
    swap-polish iterations with patience 3 over 32 candidates; on
    structural damage 100 warm SA steps in chunks of 25 on 2 chains with 8
    moves, stopped by a plateau window of 1 chunk."""
    return IncrementalOptions(
        enabled=enabled,
        warm_swap_iters=8, warm_swap_patience=3, warm_swap_candidates=32,
        warm_steps=100, warm_chunk_steps=25, warm_chains=2,
        warm_moves_per_step=8, plateau_window=1,
    )


def drift_metrics(arrays: dict, rng, p_real: int, n_drift: int) -> dict:
    """One metrics window (the bench's drift rule): ``n_drift`` of the first
    ``p_real`` partitions' leader loads, then their follower loads, scaled
    by factors drawn uniform in [0.5, 1.5) (one per partition and role)."""
    new = dict(arrays)
    idx = rng.choice(p_real, n_drift, replace=False)
    for field in ("leader_load", "follower_load"):
        a = np.asarray(arrays[field], np.float32).copy()
        a[:, idx] *= rng.uniform(0.5, 1.5, size=(1, n_drift)).astype(np.float32)
        new[field] = a
    return new


def wire_options(opts: OptimizeOptions) -> dict:
    """``opts`` as a sidecar Propose's ``options`` map (the keys of
    ``ccx_torch.sidecar.wire.PROPOSE_OPTION_KEYS``, read off the built
    dataclass), so a wire Propose runs the rung and not the server's
    defaults. The incremental block rides along; the server arms it only
    on a ``warm_start`` request."""
    a, g, w = opts.anneal, opts.polish, opts.incremental
    return {
        "chains": a.n_chains, "steps": a.n_steps, "moves_per_step": a.moves_per_step,
        "seed": a.seed, "chunk_steps": a.chunk_steps, "p_swap": a.p_swap,
        "p_swap_end": a.p_swap_end, "swap_coupling": a.swap_coupling, "n_temps": a.n_temps,
        "exchange_interval": a.exchange_interval, "bf16_scoring": a.bf16_scoring,
        "polish_candidates": g.n_candidates, "polish_max_iters": g.max_iters,
        "polish_patience": g.patience, "polish_batch_moves": g.batch_moves,
        "polish_chunk_iters": g.chunk_iters,
        "check_evacuation": opts.check_evacuation, "max_repair_rounds": opts.max_repair_rounds,
        "require_hard_zero": opts.require_hard_zero, "run_polish": opts.run_polish,
        "run_leader_pass": opts.run_leader_pass, "run_cold_greedy": opts.run_cold_greedy,
        "topic_rebalance_rounds": opts.topic_rebalance_rounds,
        "topic_rebalance_max_sweeps": opts.topic_rebalance_max_sweeps,
        "topic_rebalance_move_leaders": opts.topic_rebalance_move_leaders,
        "topic_rebalance_guarded": opts.topic_rebalance_guarded,
        "topic_rebalance_polish_iters": opts.topic_rebalance_polish_iters,
        "leader_pass_max_iters": opts.leader_pass_max_iters,
        "swap_polish_iters": opts.swap_polish_iters,
        "swap_polish_post_iters": opts.swap_polish_post_iters,
        "swap_polish_candidates": opts.swap_polish_candidates,
        "swap_polish_guarded": opts.swap_polish_guarded,
        "swap_polish_chunk_iters": opts.swap_polish_chunk_iters,
        "warm_swap_iters": w.warm_swap_iters, "warm_swap_patience": w.warm_swap_patience,
        "warm_swap_candidates": w.warm_swap_candidates, "warm_steps": w.warm_steps,
        "warm_chunk_steps": w.warm_chunk_steps, "warm_chains": w.warm_chains,
        "warm_moves": w.warm_moves_per_step, "plateau_window": w.plateau_window,
        "warm_t0": w.warm_t0, "warm_leader_iters": w.warm_leader_iters,
        "plan_enabled": opts.plan_enabled, "plan_cost_tier": opts.plan_cost_tier,
        "plan_max_waves": opts.plan_max_waves, "plan_broker_cap": opts.plan_broker_cap,
        "plan_wave_bytes_mb": opts.plan_wave_bytes_mb,
        "plan_throttle_mbps": opts.plan_throttle_mb_per_sec,
    }
