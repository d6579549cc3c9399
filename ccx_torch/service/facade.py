"""CruiseControl — the service façade: one method per operation verb.

Parity: ``KafkaCruiseControl.java`` + ``KafkaCruiseControlApp`` lifecycle
(SURVEY.md C22, call stacks 3.1/3.2/3.3): construction wires LoadMonitor,
the analyzer (the port's optimizer), Executor and AnomalyDetectorManager;
startUp order is monitor → detector → (REST server started by the caller).
Each verb builds a model from the monitor on the façade's device, runs the
goal stack there, and either returns the dry-run result or hands proposals
to the executor.

The port's counterpart of the JAX package's ``service/facade.py``: the same
verbs, answering with the same JSON. ``device`` (None: the CUDA device, or
raise; ``"cpu"`` on request) is where the monitor builds every model and
the optimizer runs. The analyzer side honors ``goal.optimizer.backend``:
'tpu' (the value operators' files carry) = the device search, batched SA
and polish on ``device``; 'greedy' = the greedy descent only. Multi-GPU
sharding is not ported yet: with ``optimizer.mesh.enabled`` and two or more
visible CUDA devices every optimizer verb raises ``ConfigException``.
"""

from __future__ import annotations

import threading
import time as _time

import logging

from ccx_torch.common.exceptions import (
    OptimizationFailureException,
    UserRequestException,
)
from ccx_torch.common import profiling
from ccx_torch.common.metrics import REGISTRY
from ccx_torch.common.tracing import TRACER
from ccx_torch.config.definition import ConfigException

#: the reference's separate operations log (SURVEY.md §5.1: log4j
#: `operationLogger` recording every request/decision)
oplog = logging.getLogger("ccx_torch.operationLogger")
from ccx_torch.detector.manager import AnomalyDetectorManager
from ccx_torch.device import resolve_device
from ccx_torch.detector.provisioner import BasicProvisioner
from ccx_torch.executor.admin import SimulatedAdminClient
from ccx_torch.executor.executor import Executor
from ccx_torch.goals.base import GOAL_REGISTRY, GoalConfig
from ccx_torch.goals.stack import INTRA_BROKER_GOAL_ORDER
from ccx_torch.monitor.aggregator import ModelCompletenessRequirements
from ccx_torch.monitor.load_monitor import LoadMonitor, ModelBuildOptions
from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF
from ccx_torch.optimizer import OptimizeOptions, OptimizerResult, optimize
from ccx_torch.search.annealer import AnnealOptions
from ccx_torch.search.greedy import GreedyOptions, greedy_optimize
from ccx_torch.proposals import columnar_diff


#: why an optimizer verb refuses a mesh over two or more CUDA devices
MESH_REFUSAL = (
    "optimizer.mesh.enabled needs multi-GPU sharding, which the port does "
    "not have yet (the sharding slice, ROADMAP queue 1 item 5); set it "
    "false, or expose one CUDA device"
)


class CruiseControl:
    """The L4 façade (ref C22). ``device`` (None: the CUDA device, or
    raise) is where models are built and optimized."""

    def __init__(self, config, admin=None, clock=None, executor_waiter=None,
                 device=None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.clock = clock or (lambda: int(_time.time() * 1000))
        self.admin = admin or config.configured_instance("admin.client.class")
        self.load_monitor = LoadMonitor(config, self.admin, clock=self.clock,
                                        device=self.device)
        self.executor = Executor(
            config, self.admin, clock=self.clock, waiter=executor_waiter,
            broker_metrics_fn=self._broker_health_metrics,
        )
        self.anomaly_detector = AnomalyDetectorManager(
            config, self.load_monitor, facade=self, clock=self.clock
        )
        self.provisioner = config.configured_instance("provisioner.class")
        if self.provisioner is None:
            self.provisioner = BasicProvisioner(config)
        self.goal_config = GoalConfig.from_config(config)
        self._proposal_cache: OptimizerResult | None = None
        self._proposal_cache_ms = -1
        self._proposal_lock = threading.Lock()
        # fleet serving (ccx_torch.search.scheduler): per-CLUSTER proposal
        # mutual exclusion replaces the old coarse convoy — two proposals
        # for the same cluster still serialize (duplicate work, and the
        # executor must never see two racing plans for one cluster), but
        # concurrent Propose calls for different clusters interleave
        # chunks on the device instead of queueing behind one lock
        self._cluster_locks: dict[str, threading.Lock] = {}
        self._cluster_locks_guard = threading.Lock()
        from ccx_torch.search import scheduler as _fleet

        _fleet.configure(
            max_concurrent=config["optimizer.fleet.max.concurrent"],
            dispatch_width=config["optimizer.fleet.dispatch.width"],
        )
        self._precompute_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._start_ms = self.clock()
        # observability wiring (ccx_torch.common.tracing): arm the flight
        # recorder / stall watchdog / device-honest span timing from the
        # observability.* keys (env CCX_FLIGHT_RECORDER et al. still apply
        # when the keys are unset); live compile counters become /metrics
        # gauges so a wedged run is observable from outside
        from ccx_torch.common import compilestats

        # tri-state precedence: a key ABSENT from the operator's properties
        # passes None (the env arming — CCX_FLIGHT_RECORDER et al. —
        # survives facade construction); a key explicitly set wins over
        # env, including explicit falsy values (watchdog.seconds=0 /
        # trace.sync=false are documented off-switches)
        def _explicit(key):
            return (
                config[key]
                if key in getattr(config, "originals", {})
                else None
            )

        TRACER.configure(
            sync=_explicit("observability.trace.sync"),
            watchdog_seconds=_explicit("observability.watchdog.seconds"),
            path=config["observability.flight.recorder.path"] or None,
        )
        compilestats.export_gauges(REGISTRY)
        # device cost observatory (ccx_torch.common.costmodel): same tri-state
        # precedence as the tracer knobs — an absent capture key leaves
        # the env (CCX_COST_CAPTURE) in charge; roofline-ceiling overrides
        # default to the built-in device-spec table at 0
        from ccx_torch.common import costmodel

        cap = _explicit("observability.cost.capture")
        if cap is not None:
            costmodel.set_capture(bool(cap))
        costmodel.set_device_override(
            config["observability.cost.peak.tflops"],
            config["observability.cost.hbm.gbps"],
        )
        # fleet snapshot-registry budget (0 = auto from device capacity
        # minus the captured watermark) — consumed by any in-process
        # sidecar registry; the standalone sidecar takes the env/flag twin
        costmodel.set_fleet_hbm_budget(
            config["optimizer.fleet.snapshot.hbm.mb"]
        )
        costmodel.export_gauges(REGISTRY)
        # unified device-memory ledger (ccx_torch.common.devmem): one budget
        # pricing snapshot models + warm placement bases + the compiled
        # working set together, priority-aware eviction. 0 = fall through
        # to the fleet snapshot derivation above.
        from ccx_torch.common import devmem as _devmem

        _devmem.configure(budget_mb=config["optimizer.devmem.budget.mb"])
        # convergence telemetry taps (ccx_torch.search.telemetry): same
        # tri-state precedence — an absent key leaves the env
        # (CCX_CONVERGENCE) in charge of the default-on taps; the
        # ring-buffer depth is program shape, set once at construction
        from ccx_torch.search import telemetry

        telemetry.configure(
            enabled=_explicit("observability.convergence"),
            max_chunks=config["observability.convergence.max.chunks"],
        )
        # incremental re-optimization (ccx_torch.search.incremental):
        # size the process-wide warm-placement store; per-cluster
        # generations are facade-local monotonic counters
        from ccx_torch.search import incremental as _incremental

        _incremental.configure(
            max_sessions=config["optimizer.incremental.max.sessions"]
        )
        self._incremental_gen: dict[str, int] = {}
        # fault injection (ccx_torch.common.faults): armed ONLY by an
        # explicit spec — config here, CCX_FAULTS for bench/standalone
        # entry points; an empty spec leaves the registry disarmed (the
        # zero-overhead default)
        from ccx_torch.common import faults as _faults

        fault_spec = config["observability.faults.spec"]
        if fault_spec:
            _faults.FAULTS.arm(
                fault_spec, seed=config["observability.faults.seed"]
            )

    # ----- lifecycle (ref startUp order: monitor -> detector -> servlet) ----

    def start_up(self, run_background_threads: bool = True) -> None:
        self.load_monitor.start_up(run_sampling_loop=run_background_threads)
        if run_background_threads:
            self.anomaly_detector.start_detection()
            if self.config["num.proposal.precompute.threads"] > 0:
                self._precompute_thread = threading.Thread(
                    target=self._precompute_loop,
                    name="ProposalCandidateComputer", daemon=True,
                )
                self._precompute_thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self.anomaly_detector.shutdown()
        self.load_monitor.shutdown()

    # ----- goal plumbing ----------------------------------------------------

    def _resolve_goals(self, goals=None, self_healing: bool = False) -> tuple[str, ...]:
        """Request goal list -> registry stack with the structural term first
        (ref: goalsByPriority resolution in GoalOptimizer)."""
        if goals:
            unknown = [g for g in goals if g not in GOAL_REGISTRY]
            if unknown:
                raise UserRequestException(f"Unknown goals: {unknown}")
            names = tuple(goals)
        elif self_healing:
            names = tuple(self.config["self.healing.goals"]) or tuple(
                self.config["hard.goals"]
            )
        else:
            names = tuple(self.config["default.goals"]) or tuple(
                self.config["goals"]
            )
        names = tuple(g for g in names if g in GOAL_REGISTRY)
        return ("StructuralFeasibility",) + tuple(
            g for g in names if g != "StructuralFeasibility"
        )

    def _optimize_options(self, leadership_only: bool = False,
                          disk_only: bool = False) -> OptimizeOptions:
        if self.config["optimizer.mesh.enabled"] and self._mesh_devices() >= 2:
            raise ConfigException(MESH_REFUSAL)
        anneal = AnnealOptions(
            n_chains=self.config["optimizer.num.chains"],
            n_steps=self.config["optimizer.num.steps"],
            moves_per_step=self.config["optimizer.moves.per.step"],
            seed=self.config["optimizer.seed"],
            chunk_steps=self.config["optimizer.chunk.steps"],
            p_swap=self.config["optimizer.swap.p.swap"],
            p_swap_end=self.config["optimizer.swap.p.swap.end"],
            swap_coupling=self.config["optimizer.swap.coupling"],
            n_temps=self.config["optimizer.exchange.n.temps"],
            exchange_interval=self.config["optimizer.exchange.interval"],
            bf16_scoring=self.config["optimizer.bf16.scoring"],
        )
        polish = GreedyOptions(
            n_candidates=self.config["optimizer.polish.candidates"],
            max_iters=self.config["optimizer.polish.max.iters"],
            batch_moves=self.config["optimizer.polish.batch.moves"],
            chunk_iters=self.config["optimizer.polish.chunk.iters"],
        )
        import dataclasses as _dc

        if leadership_only:
            # The annealer's swap branch mixes replica swaps in by draw, so
            # a leadership-only search (demote) disables swaps there; the
            # polish runs in leadership_only mode, where every proposal —
            # including swaps, which become count-preserving leadership
            # rotations — is guaranteed to keep replicas in place.
            anneal = _dc.replace(
                anneal, p_leadership=1.0, p_biased_dest=0.0, p_swap=0.0
            )
            polish = _dc.replace(polish, leadership_only=True)
        if disk_only:
            anneal = _dc.replace(
                anneal, p_disk=1.0, p_leadership=0.0, p_biased_dest=0.0,
                p_swap=0.0,
            )
            polish = _dc.replace(
                polish, p_disk=1.0, p_leadership=0.0, swap_fraction=0.0
            )
        return OptimizeOptions(
            anneal=anneal, polish=polish,
            check_evacuation=not disk_only,
            # the targeted TRD stage only applies to full placement stacks —
            # leadership-/disk-only paths never move topic replica counts
            topic_rebalance_rounds=(
                0 if (leadership_only or disk_only)
                else self.config["optimizer.topic.rebalance.rounds"]
            ),
            topic_rebalance_max_sweeps=self.config[
                "optimizer.topic.rebalance.max.sweeps"
            ],
            topic_rebalance_move_leaders=self.config[
                "optimizer.topic.rebalance.move.leaders"
            ],
            topic_rebalance_guarded=self.config[
                "optimizer.topic.rebalance.guarded"
            ],
            topic_rebalance_polish_iters=(
                None
                if self.config["optimizer.topic.rebalance.polish.iters"] < 0
                else self.config["optimizer.topic.rebalance.polish.iters"]
            ),
            leader_pass_max_iters=(
                None
                if self.config["optimizer.leader.pass.max.iters"] < 0
                else self.config["optimizer.leader.pass.max.iters"]
            ),
            # the portfolio candidate roughly doubles polish-phase cost;
            # never pay it on the leadership-/disk-only fast paths
            run_cold_greedy=(
                self.config["optimizer.portfolio.cold.greedy"]
                and not (leadership_only or disk_only)
            ),
            repair_backend=self.config["optimizer.repair.backend"],
            overlap_repair=self.config["optimizer.repair.overlap"],
            # swap-polish moves replicas between brokers: never on the
            # leadership-only (demote) or intra-broker (disk) fast paths
            swap_polish_iters=(
                0 if (leadership_only or disk_only)
                else self.config["optimizer.swap.polish.iters"]
            ),
            swap_polish_post_iters=(
                0 if (leadership_only or disk_only)
                else self.config["optimizer.swap.polish.post.iters"]
            ),
            swap_polish_candidates=self.config[
                "optimizer.swap.polish.candidates"
            ],
            swap_polish_guarded=self.config["optimizer.swap.polish.guarded"],
            swap_polish_chunk_iters=self.config[
                "optimizer.swap.polish.chunk.iters"
            ],
            # incremental re-optimization: the
            # full warm pipeline serves the placement verbs; a
            # leadership-only verb (demote) warm-starts too, but with
            # the swap engine ZEROED — its stack is not intra-only, so
            # an armed swap polish would move replicas and break the
            # leadership-only contract — and the leadership pass as the
            # warm engine instead. Disk-only keeps from-scratch
            # semantics (intra-broker moves have no warm engine).
            incremental=self._incremental_options(
                disabled=disk_only, leadership_only=leadership_only
            ),
            # movement planning: wave-schedule inter-broker
            # movement; meaningless on the leadership-/disk-only fast
            # paths (no inter-broker moves to schedule)
            plan_enabled=(
                self.config["optimizer.plan.enabled"]
                and not (leadership_only or disk_only)
            ),
            plan_cost_tier=self.config["optimizer.plan.cost.tier"],
            plan_max_waves=self.config["optimizer.plan.max.waves"],
            plan_broker_cap=self.config["optimizer.plan.broker.cap"],
            plan_wave_bytes_mb=self.config["optimizer.plan.wave.bytes.mb"],
            # wave pricing prefers the executor's MEASURED per-wave MB/s:
            # once a movement wave has completed, re-plans price the
            # remaining waves with the observed rate instead of the static
            # config — the closed feedback loop
            plan_throttle_mb_per_sec=self._plan_throttle_mbps(),
        )

    def _plan_throttle_mbps(self) -> float:
        static = self.config["optimizer.plan.throttle.mbps"]
        if not self.config["optimizer.plan.throttle.measured"]:
            return static
        try:
            measured = self.executor.measured_wave_mb_per_sec()
        except Exception:  # noqa: BLE001 — pricing must never fail a verb
            measured = 0.0
        return measured if measured > 0.0 else static

    def _incremental_options(self, disabled: bool = False,
                             leadership_only: bool = False):
        from ccx_torch.search.incremental import IncrementalOptions

        return IncrementalOptions(
            enabled=(
                not disabled
                and self.config["optimizer.incremental.enabled"]
            ),
            warm_swap_iters=(
                0 if leadership_only
                else self.config["optimizer.incremental.warm.swap.iters"]
            ),
            warm_swap_patience=self.config[
                "optimizer.incremental.warm.swap.patience"
            ],
            warm_swap_candidates=self.config[
                "optimizer.incremental.warm.swap.candidates"
            ],
            warm_steps=self.config["optimizer.incremental.warm.steps"],
            warm_chunk_steps=self.config[
                "optimizer.incremental.warm.chunk.steps"
            ],
            warm_chains=self.config["optimizer.incremental.warm.chains"],
            warm_moves_per_step=self.config["optimizer.incremental.warm.moves"],
            plateau_window=self.config["optimizer.incremental.plateau.window"],
            warm_t0=self.config["optimizer.incremental.warm.t0"],
            # the leadership-only warm engine: a demote's drift is pure
            # leadership, so the greedy leader pass (never a replica
            # move by construction) does the work the zeroed swap
            # engine would otherwise
            warm_leader_iters=(
                max(
                    self.config["optimizer.incremental.warm.leader.iters"],
                    8,
                )
                if leadership_only
                else self.config["optimizer.incremental.warm.leader.iters"]
            ),
            max_sessions=self.config["optimizer.incremental.max.sessions"],
            leadership_only=leadership_only,
        )

    def _cluster_lock(self, cluster_id: str | None = None) -> threading.Lock:
        """The per-cluster proposal mutex (fleet serving): proposals for
        ONE cluster serialize; different clusters never convoy."""
        cid = cluster_id or self.config["optimizer.fleet.cluster.id"]
        with self._cluster_locks_guard:
            return self._cluster_locks.setdefault(cid, threading.Lock())

    def _run_optimizer(self, model, goal_names, opts: OptimizeOptions,
                       progress=None, verb: str = "proposal",
                       urgent: bool = False,
                       cluster_id: str | None = None) -> OptimizerResult:
        backend = self.config["goal.optimizer.backend"]
        if progress:
            progress.step(f"Optimizing ({backend} backend, {len(goal_names)} goals)")
        cid = cluster_id or self.config["optimizer.fleet.cluster.id"]
        priority = (
            self.config["optimizer.fleet.priority.urgent"] if urgent else 0
        )
        from ccx_torch.search.scheduler import FLEET

        # per-cluster mutual exclusion + fleet job registration: the verb
        # runs as one job on the multi-job chunk scheduler, and all its
        # spans/heartbeats carry job=<cluster-id>. Preemption semantics:
        # an urgent self-healing verb preempts OTHER clusters' in-flight
        # jobs at their next chunk boundary (and jumps the cross-cluster
        # run queue); verbs for the SAME cluster serialize on the cluster
        # lock BY DESIGN — the executor must never see two racing plans
        # for one cluster, so intra-cluster urgency means "next in line",
        # not mid-run cancellation.
        # verb span: the facade layer of the span pipeline (verb →
        # optimizer phases → chunk heartbeats → sidecar RPCs) — per-verb
        # Prometheus histogram + the flight-recorder breadcrumb naming
        # which operation a dead process was serving
        with self._cluster_lock(cid), \
                FLEET.job(cid, priority), \
                REGISTRY.timer("proposal-computation").time(), \
                TRACER.span(verb, kind="verb", backend=backend,
                            goals=len(goal_names)), \
                profiling.trace(self.config["optimizer.profile.dir"]):
            # incremental re-optimization: resolve this
            # cluster's last converged placement as the warm base (the
            # steady-state loop); a verified result banks the NEXT base.
            # Cold-start fallback is optimize()'s own (shape mismatch →
            # normal pipeline with the reason on the result).
            from ccx_torch.search import incremental as _inc

            warm = None
            if getattr(opts, "incremental", None) is not None \
                    and opts.incremental.armed and backend != "greedy":
                warm = _inc.STORE.get(cid, priority=priority)
            res = self._run_optimizer_timed(
                model, goal_names, opts, progress, backend, warm_start=warm
            )
            if (
                getattr(opts, "incremental", None) is not None
                and opts.incremental.armed
                and backend != "greedy"
                and warm is None
                and res.incremental is None
            ):
                # documented cold start (the sidecar Propose contract,
                # now mirrored by every verb): warm was armed but no
                # base fit — say so on the result instead of silently
                # looking like a from-scratch run
                import dataclasses as _dc

                res = _dc.replace(
                    res,
                    incremental={
                        "warmStart": False, "coldStart": True,
                        "reason": (
                            f"no warm placement banked for cluster {cid!r}"
                        ),
                    },
                )
            if (
                getattr(opts, "incremental", None) is not None
                and opts.incremental.armed
                and backend != "greedy"
                and res.verification.ok
            ):
                gen = self._incremental_gen.get(cid, 0) + 1
                self._incremental_gen[cid] = gen
                # the verb's fleet priority prices the banked base on the
                # unified device-memory ledger (urgent self-healing bases
                # are protected from dryrun packing)
                _inc.remember(cid, gen, res.model, self.goal_config,
                              pressure=res.warm_pressure, priority=priority)
            return res

    def _run_optimizer_timed(self, model, goal_names, opts, progress,
                             backend, warm_start=None) -> OptimizerResult:
        if backend == "greedy":
            import time as _t

            t0 = _t.monotonic()
            g = greedy_optimize(model, self.goal_config, goal_names, opts.polish)
            from ccx_torch.goals.stack import evaluate_stack
            from ccx_torch.search.repair import finalize_preferred_leaders
            from ccx_torch.verify import verify_optimization

            out_model, stack_after, _ = finalize_preferred_leaders(
                g.model, self.goal_config, goal_names, g.stack_after
            )
            dcols = columnar_diff(model, out_model)
            stack_before = evaluate_stack(model, self.goal_config, goal_names)
            verification = verify_optimization(
                model, out_model, self.goal_config, goal_names,
                proposals=dcols,
                require_hard_zero=opts.require_hard_zero,
                check_evacuation=opts.check_evacuation,
                stack_before=stack_before,
                stack_after=stack_after,
            )
            return OptimizerResult(
                diff=dcols,
                stack_before=stack_before,
                stack_after=stack_after,
                verification=verification,
                model=out_model,
                wall_seconds=_t.monotonic() - t0,
                n_sa_accepted=0,
                n_polish_moves=g.n_moves,
            )
        return optimize(model, self.goal_config, goal_names, opts,
                        warm_start=warm_start)

    def _model(self, options: ModelBuildOptions | None = None,
               requirements: ModelCompletenessRequirements | None = None,
               progress=None):
        if progress:
            progress.step("Acquiring cluster model")
        req = requirements or ModelCompletenessRequirements(1, 0.5)
        with self.load_monitor.acquire_for_model_generation():
            return self.load_monitor.cluster_model(req, options)

    def _finish(self, res: OptimizerResult, metadata, dryrun: bool,
                reason: str, uuid: str | None, progress=None,
                replication_throttle=None) -> dict:
        oplog.info(
            "operation uuid=%s dryrun=%s reason=%r proposals=%d verified=%s "
            "wall=%.3fs",
            uuid, dryrun, reason, len(res.proposals), res.verification.ok,
            res.wall_seconds,
        )
        REGISTRY.counter("operations" if dryrun else "executions").inc()
        out = res.to_json()
        out["dryRun"] = dryrun
        out["reason"] = reason
        out["provisionStatus"] = self.provisioner.rightsize(
            _host_model(res.model)
        ).to_json()
        if not dryrun and res.proposals:
            # Never hand unverified proposals to the executor (ref: the
            # GoalOptimizer raises OptimizationFailureException instead of
            # executing). This is the only gate between the self-healing
            # auto-fix path (dryrun=False, no human in the loop) and the
            # cluster, so a broken optimization must fail loudly here.
            if not res.verification.ok:
                oplog.error(
                    "refusing to execute unverified proposals uuid=%s: %s",
                    uuid, "; ".join(res.verification.failures),
                )
                raise OptimizationFailureException(
                    "optimization result failed verification: "
                    + "; ".join(res.verification.failures)
                )
            if res.verification.infeasible:
                oplog.error(
                    "refusing to execute infeasible optimization uuid=%s: %s",
                    uuid, res.verification.infeasible,
                )
                raise OptimizationFailureException(
                    "hard goals unsatisfiable for this cluster: "
                    + "; ".join(
                        f"{g}: {why}"
                        for g, why in res.verification.infeasible.items()
                    )
                )
            if progress:
                progress.step(f"Executing {len(res.proposals)} proposals")
            self.executor.execute_proposals(
                res.proposals, metadata, uuid=uuid,
                replication_throttle=replication_throttle, background=True,
                plan=res.plan,
            )
            out["executionStarted"] = True
        return out

    # ----- verbs (one per REST operation, ref C22) --------------------------

    #: ref kafkaassigner-mode goal stack (SURVEY.md C19): the compatibility
    #: mode mimicking the older kafka-assigner tool
    KAFKA_ASSIGNER_GOALS = (
        "KafkaAssignerEvenRackAwareGoal",
        "KafkaAssignerDiskUsageDistributionGoal",
    )

    def rebalance(self, goals=None, dryrun: bool = True, reason: str = "",
                  self_healing: bool = False, excluded_topics: str = "",
                  uuid: str | None = None, progress=None,
                  rebalance_disk: bool = False,
                  destination_brokers=(),
                  kafka_assigner: bool = False,
                  data_from: str = "VALID_WINDOWS",
                  replication_throttle=None) -> dict:
        if rebalance_disk:
            return self.rebalance_disk(
                dryrun=dryrun, reason=reason, uuid=uuid, progress=progress
            )
        if kafka_assigner and not goals:
            goals = self.KAFKA_ASSIGNER_GOALS
        model, metadata, gen = self._model(
            ModelBuildOptions(excluded_topics_pattern=excluded_topics),
            requirements=_requirements_for(data_from),
            progress=progress,
        )
        model = _restrict_destinations(model, metadata, destination_brokers)
        res = self._run_optimizer(
            model, self._resolve_goals(goals, self_healing),
            self._optimize_options(), progress, verb="rebalance",
            urgent=self_healing,
        )
        return self._finish(res, metadata, dryrun, reason, uuid, progress,
                            replication_throttle)

    def add_brokers(self, broker_ids, goals=None, dryrun: bool = True,
                    reason: str = "", self_healing: bool = False,
                    uuid: str | None = None, progress=None,
                    replication_throttle=None) -> dict:
        """Move load onto the added brokers (ref addBrokers: existing brokers
        may not receive replicas during the operation)."""
        model, metadata, gen = self._model(
            ModelBuildOptions(brokers_to_add=tuple(broker_ids)),
            progress=progress,
        )
        excl = model.broker_valid & ~model.broker_new
        model = model.replace(
            broker_excl_replicas=model.broker_excl_replicas | excl
        )
        res = self._run_optimizer(
            model, self._resolve_goals(goals, self_healing),
            self._optimize_options(), progress, verb="add-brokers",
            urgent=self_healing,
        )
        return self._finish(res, metadata, dryrun, reason, uuid, progress,
                            replication_throttle)

    def remove_brokers(self, broker_ids, goals=None, dryrun: bool = True,
                       reason: str = "", self_healing: bool = False,
                       uuid: str | None = None, progress=None,
                       destination_brokers=(),
                       replication_throttle=None) -> dict:
        """Evacuate the given brokers (ref removeBrokers; also the
        broker-failure self-healing fix, call stack 3.5)."""
        model, metadata, gen = self._model(
            ModelBuildOptions(brokers_to_remove=tuple(broker_ids)),
            progress=progress,
        )
        model = _restrict_destinations(model, metadata, destination_brokers)
        res = self._run_optimizer(
            model, self._resolve_goals(goals, self_healing),
            self._optimize_options(), progress, verb="remove-brokers",
            urgent=self_healing,
        )
        return self._finish(res, metadata, dryrun, reason, uuid, progress,
                            replication_throttle)

    def demote_brokers(self, broker_ids, dryrun: bool = True, reason: str = "",
                       self_healing: bool = False, uuid: str | None = None,
                       progress=None) -> dict:
        """Shed leadership from the given brokers (ref demoteBrokers →
        PreferredLeaderElectionGoal, leadership moves only)."""
        model, metadata, gen = self._model(
            ModelBuildOptions(brokers_to_demote=tuple(broker_ids)),
            progress=progress,
        )
        # urgent=self_healing: a detector-triggered demote
        # (slow-broker self-healing) must preempt queued dryruns like the
        # other anomaly verbs — it previously dropped the flag and ran at
        # normal priority
        res = self._run_optimizer(
            model,
            ("StructuralFeasibility", "PreferredLeaderElectionGoal"),
            self._optimize_options(leadership_only=True),
            progress, verb="demote-brokers",
            urgent=self_healing,
        )
        return self._finish(res, metadata, dryrun, reason, uuid, progress)

    def fix_offline_replicas(self, goals=None, dryrun: bool = True,
                             reason: str = "", self_healing: bool = False,
                             uuid: str | None = None, progress=None) -> dict:
        """Move replicas off dead brokers/disks (ref fixOfflineReplicas;
        the disk-failure self-healing fix)."""
        model, metadata, gen = self._model(progress=progress)
        # the flagship urgent verb: replicas are offline NOW — it jumps
        # every queued dryrun at the next chunk boundary
        res = self._run_optimizer(
            model, self._resolve_goals(goals, self_healing=True),
            self._optimize_options(), progress, verb="fix-offline-replicas",
            urgent=True,
        )
        return self._finish(res, metadata, dryrun, reason, uuid, progress)

    def rebalance_disk(self, dryrun: bool = True, reason: str = "",
                       uuid: str | None = None, progress=None) -> dict:
        """Intra-broker JBOD rebalance (ref rebalance?rebalance_disk, C18)."""
        model, metadata, gen = self._model(
            ModelBuildOptions(populate_disks=True), progress=progress
        )
        res = self._run_optimizer(
            model, INTRA_BROKER_GOAL_ORDER,
            self._optimize_options(disk_only=True), progress,
            verb="rebalance-disk",
        )
        return self._finish(res, metadata, dryrun, reason, uuid, progress)

    def update_topic_configuration(self, topic_rf: dict[str, int],
                                   dryrun: bool = True, reason: str = "",
                                   self_healing: bool = False,
                                   uuid: str | None = None,
                                   progress=None) -> dict:
        """Change topic replication factors (ref TOPIC_CONFIGURATION
        endpoint): grow RF rack-aware onto least-loaded brokers, shrink by
        dropping the most-loaded non-leader replica; placement is then
        verified/executed through the normal proposal path."""
        if progress:
            progress.step("Computing replication-factor changes")
        metadata = self.admin.describe_cluster()
        from ccx_torch.proposals import ExecutionProposal

        alive = metadata.alive_broker_ids()
        rack_of = {b.broker_id: b.rack for b in metadata.brokers}
        load = {b.broker_id: 0 for b in metadata.brokers}
        for p in metadata.partitions:
            for b in p.replicas:
                load[b] = load.get(b, 0) + 1
        proposals = []
        pidx = metadata.partition_index()
        for topic, target in topic_rf.items():
            for part in metadata.partitions_of(topic):
                current = list(part.replicas)
                new = list(current)
                while len(new) < target:
                    used_racks = {rack_of[b] for b in new}
                    candidates = sorted(
                        (b for b in alive if b not in new),
                        key=lambda b: (rack_of[b] in used_racks, load[b]),
                    )
                    if not candidates:
                        break
                    new.append(candidates[0])
                    load[candidates[0]] += 1
                while len(new) > target and len(new) > 1:
                    drop = max(
                        (b for b in new if b != part.leader),
                        key=lambda b: load[b],
                        default=None,
                    )
                    if drop is None:
                        break
                    new.remove(drop)
                    load[drop] -= 1
                if new != current:
                    proposals.append(
                        ExecutionProposal(
                            partition=pidx[part.tp], topic=0,
                            old_replicas=tuple(current),
                            new_replicas=tuple(new),
                            old_leader=part.leader, new_leader=part.leader,
                        )
                    )
        out = {
            "proposals": [p.to_json() for p in proposals],
            "numReplicaMovements": len(proposals),
            "dryRun": dryrun,
            "reason": reason,
        }
        if not dryrun and proposals:
            # proposals here already use real broker ids: execute with a
            # metadata whose broker order maps identity
            if progress:
                progress.step(f"Executing {len(proposals)} RF changes")
            self.executor.execute_proposals(
                proposals, _identity_metadata(metadata), uuid=uuid,
                background=True,
            )
            out["executionStarted"] = True
        return out

    def rightsize(self, progress=None) -> dict:
        """Ref RIGHTSIZE endpoint → Provisioner SPI (C21)."""
        model, metadata, gen = self._model(progress=progress)
        return self.provisioner.rightsize(_host_model(model)).to_json()

    def observability(self, include_threads: bool = False) -> dict:
        """The flight-deck endpoint (GET /observability): tracer + flight-
        recorder + watchdog state, live span stacks with chunk progress,
        live compile counters, the unified device-memory ledger, and —
        with ``threads=true`` — an all-thread stack dump. Works DURING a
        wedged proposal: the optimizer holds no lock this path needs, and
        a stuck device call releases the GIL."""
        out = TRACER.observability_json(threads=include_threads)
        out["deviceMemory"] = self._devmem_state()
        out["executor"] = self.executor.observability_json()
        # the closed-loop control plane: live SLO burn rates +
        # the healing-event timeline (detected -> fired -> recovered arcs
        # with cause attribution) — USER-gated like the rest of this view
        try:
            out["healing"] = self.anomaly_detector.stream.observability_json()
        except Exception:  # noqa: BLE001 — the view must stay readable
            pass
        return out

    # ----- cached proposals (ref GoalOptimizer precompute, C14) -------------

    def proposals(self, progress=None, ignore_cache: bool = False) -> dict:
        with self._proposal_lock:
            fresh = (
                self._proposal_cache is not None
                and self.clock() - self._proposal_cache_ms
                < self.config["proposal.expiration.ms"]
            )
            if fresh and not ignore_cache:
                out = self._proposal_cache.to_json()
                out["fromCache"] = True
                return out
        model, metadata, gen = self._model(progress=progress)
        res = self._run_optimizer(
            model, self._resolve_goals(), self._optimize_options(), progress,
            verb="proposals",
        )
        with self._proposal_lock:
            self._proposal_cache = res
            self._proposal_cache_ms = self.clock()
        out = res.to_json()
        out["fromCache"] = False
        return out

    def _precompute_loop(self) -> None:
        interval = max(self.config["proposal.expiration.ms"] / 2, 1000) / 1000.0
        while not self._stop.wait(interval):
            try:
                self.proposals(ignore_cache=True)
            except Exception:
                import logging

                logging.getLogger(__name__).exception("proposal precompute failed")

    # ----- read endpoints ---------------------------------------------------

    def state(self, substates: tuple[str, ...] = ()) -> dict:
        want = set(s.lower() for s in substates) or {
            "monitor", "executor", "analyzer", "anomaly_detector"
        }
        out: dict = {"version": 1}
        if "monitor" in want:
            out["MonitorState"] = self.load_monitor.state()
        if "executor" in want:
            out["ExecutorState"] = self.executor.state_json()
        if "analyzer" in want:
            from ccx_torch.sidecar.wire import WIRE_VERSION

            with self._proposal_lock:
                out["AnalyzerState"] = {
                    "isProposalReady": self._proposal_cache is not None,
                    "readyGoals": list(self._resolve_goals()),
                    "backend": self.config["goal.optimizer.backend"],
                    # the sidecar envelope version this build speaks — lets
                    # an operator (or the JVM bridge) confirm wire compat
                    # from the REST state endpoint before routing proposals
                    "sidecarWireVersion": WIRE_VERSION,
                    # swap-engine state: which move-class escalation this
                    # analyzer runs (diagnosable from REST, like the wire
                    # version) — per-request overridable via the same keys
                    "swapEngine": {
                        "coupling": self.config["optimizer.swap.coupling"],
                        "pSwap": self.config["optimizer.swap.p.swap"],
                        "pSwapEnd": self.config["optimizer.swap.p.swap.end"],
                        "polishIters": self.config[
                            "optimizer.swap.polish.iters"
                        ],
                        "polishPostIters": self.config[
                            "optimizer.swap.polish.post.iters"
                        ],
                        "polishCandidates": self.config[
                            "optimizer.swap.polish.candidates"
                        ],
                        "polishGuarded": self.config[
                            "optimizer.swap.polish.guarded"
                        ],
                    },
                    # chunked-descent engine state: the chunk sizes
                    # are the only shape-bearing polish budgets — an
                    # operator can confirm from REST that a budget retune
                    # cannot trigger a recompile (chunkIters unchanged);
                    # 0 flags that engine deliberately monolithic
                    "polishEngine": {
                        "chunkIters": self.config[
                            "optimizer.polish.chunk.iters"
                        ],
                        "swapPolishChunkIters": self.config[
                            "optimizer.swap.polish.chunk.iters"
                        ],
                    },
                    # incremental re-optimization state:
                    # armed + warm knobs + live store occupancy, so an
                    # operator confirms from REST whether steady-state
                    # proposals warm-start and how many sessions are
                    # device-resident
                    "incremental": self._incremental_state(),
                    # fleet serving state (ccx_torch.search.scheduler): the
                    # multi-job chunk scheduler's live run queue + window
                    # stats — an operator confirms from REST that
                    # concurrent proposals interleave (meanDepth > 1)
                    # instead of convoying, and which cluster ids are
                    # active at what priority
                    "fleet": self._fleet_state(),
                    # flight-recorder / watchdog / span state (ccx_torch.common.
                    # tracing), VIEWER-safe summary: STATE is viewer-
                    # readable, so this must not leak what security.py
                    # gates at USER on /observability (recorder file path,
                    # live span/thread stacks)
                    "observability": {
                        **TRACER.observability_summary(),
                        # mesh-sharded optimizer state: the configured
                        # mesh shape and the live sharded-program cache
                        # occupancy — an operator confirms from REST that
                        # a mesh run is armed and that budget retunes are
                        # not minting new compiled programs
                        "mesh": self._mesh_state(),
                        # convergence-telemetry state: taps
                        # armed + ring depth; the per-job energy summary
                        # rides observability_summary() above (VIEWER-
                        # safe — the full timeline is USER-gated on
                        # /observability)
                        "convergenceTaps": self._convergence_state(),
                        # unified device-memory ledger (ccx_torch.common.
                        # devmem): resident bytes per class (snapshots /
                        # warm bases / programs), eviction counts by
                        # reason and priority, and the budget — sizes and
                        # counters only, VIEWER-safe
                        "deviceMemory": self._devmem_state(),
                        # windowed SLO engine + stream detector:
                        # objectives, burn rates, episode counts and
                        # time-to-heal percentiles — numbers and family
                        # names only; the full healing timeline (causes,
                        # verbs, per-episode arcs) is USER-gated on
                        # /observability
                        "slo": self._slo_state(),
                    },
                }
        if "anomaly_detector" in want:
            out["AnomalyDetectorState"] = self.anomaly_detector.state()
        return out

    def kafka_cluster_state(self) -> dict:
        """Ref KAFKA_CLUSTER_STATE endpoint."""
        md = self.admin.describe_cluster()
        return {
            "KafkaBrokerState": {
                "ReplicaCountByBrokerId": _count_by_broker(md, leaders=False),
                "LeaderCountByBrokerId": _count_by_broker(md, leaders=True),
                "OnlineLogDirsByBrokerId": {
                    str(b): [d for d, ok in dirs.items() if ok]
                    for b, dirs in self.admin.describe_log_dirs().items()
                },
                "IsController": {},
                "HostByBrokerId": {
                    str(b.broker_id): b.host_key() for b in md.brokers
                },
                "Summary": {
                    "Brokers": len(md.brokers),
                    "Hosts": len(md.hosts()),
                    "AliveBrokers": len(md.alive_broker_ids()),
                    "Topics": len(md.topics()),
                    "Partitions": len(md.partitions),
                    "Replicas": md.replica_count(),
                    "UnderReplicatedPartitions": len(md.under_replicated()),
                },
            }
        }

    def load(self) -> dict:
        """Ref LOAD endpoint: per-broker resource utilization + the
        ClusterModelStats block (SURVEY.md C4)."""
        model, metadata, gen = self._model()
        from ccx_torch.model.aggregates import broker_aggregates
        from ccx_torch.model.stats import cluster_model_stats

        agg = broker_aggregates(model)
        loads = agg.broker_load.cpu().numpy()        # [RES, B]
        caps = model.broker_capacity.cpu().numpy()
        replicas = agg.replica_count.cpu().numpy()
        leaders = agg.leader_count.cpu().numpy()
        out = []
        for i, b in enumerate(metadata.brokers):
            out.append(
                {
                    "Broker": b.broker_id,
                    "Rack": b.rack,
                    "Host": b.host_key(),
                    "BrokerState": "ALIVE" if b.alive else "DEAD",
                    "Replicas": int(replicas[i]),
                    "Leaders": int(leaders[i]),
                    "CpuPct": float(loads[0, i]),
                    "NwInRate": float(loads[1, i]),
                    "NwOutRate": float(loads[2, i]),
                    "DiskMB": float(loads[3, i]),
                    "DiskPct": float(
                        100.0 * loads[3, i] / max(caps[3, i], 1e-9)
                    ),
                }
            )
        return {
            "brokers": out,
            "modelGeneration": str(gen),
            **cluster_model_stats(model, agg).to_json(),
        }

    def partition_load(self, max_entries: int = 100, resource: str = "CPU",
                       topic: str = "") -> dict:
        """Ref PARTITION_LOAD endpoint: partitions sorted by the requested
        resource's utilization, optionally filtered by topic regex."""
        import re as _re

        from ccx_torch.common.resources import Resource

        try:
            res = Resource[resource.upper()]
        except KeyError:
            raise UserRequestException(
                f"Unknown resource {resource!r}; one of "
                f"{[r.name for r in Resource]}"
            ) from None
        model, metadata, gen = self._model()
        import numpy as np

        lead = model.leader_load.cpu().numpy()  # [RES, P]
        valid = model.partition_valid.cpu().numpy().copy()
        if topic:
            rx = _re.compile(topic)
            for i, info in enumerate(metadata.partitions):
                if not rx.fullmatch(info.tp.topic):
                    valid[i] = False
        # Filter to valid partitions first, then sort + slice — slicing
        # before the validity filter would return fewer than max_entries
        # when zero-load valid partitions tie with masked-out ones.
        valid_idx = np.nonzero(valid)[0]
        order = valid_idx[np.argsort(-lead[res][valid_idx])][:max_entries]
        records = []
        for p in order:
            info = metadata.partitions[int(p)]
            records.append(
                {
                    "topic": info.tp.topic,
                    "partition": info.tp.partition,
                    "leader": info.leader,
                    "followers": [b for b in info.replicas if b != info.leader],
                    "cpu": float(lead[0, p]),
                    "networkInbound": float(lead[1, p]),
                    "networkOutbound": float(lead[2, p]),
                    "disk": float(lead[3, p]),
                }
            )
        return {"records": records}

    # ----- admin verbs ------------------------------------------------------

    def pause_sampling(self, reason: str = "") -> dict:
        self.load_monitor.pause_sampling(reason or "paused by user")
        return {"message": "Sampling paused"}

    def resume_sampling(self, reason: str = "") -> dict:
        self.load_monitor.resume_sampling()
        return {"message": "Sampling resumed"}

    def stop_proposal_execution(self) -> dict:
        self.executor.stop_execution()
        return {"message": "Execution stop requested"}

    def bootstrap(self, start_ms: int | None, end_ms: int | None,
                  clear_metrics: bool = True) -> dict:
        """Ref BOOTSTRAP endpoint (SURVEY.md C9): replay a historical metric
        range into the aggregators to warm windows without waiting."""
        if start_ms is None or end_ms is None:
            raise UserRequestException(
                "bootstrap requires start and end timestamps (ms)"
            )
        if end_ms <= start_ms:
            raise UserRequestException("bootstrap end must be after start")
        return self.load_monitor.bootstrap(start_ms, end_ms, clear_metrics)

    def train(self, start_ms: int | None, end_ms: int | None) -> dict:
        """Ref TRAIN endpoint (SURVEY.md C6): fit the linear-regression CPU
        estimation model from broker samples over a historical range."""
        if start_ms is None or end_ms is None:
            raise UserRequestException(
                "train requires start and end timestamps (ms)"
            )
        if end_ms <= start_ms:
            raise UserRequestException("train end must be after start")
        return self.load_monitor.train(start_ms, end_ms)

    # ----- internals --------------------------------------------------------

    def _fleet_state(self) -> dict:
        """AnalyzerState.fleet: scheduler config + live run-queue stats
        (never raises — STATE must stay readable under any backend)."""
        try:
            from ccx_torch.search.scheduler import FLEET

            return {
                "clusterId": self.config["optimizer.fleet.cluster.id"],
                "urgentPriority": self.config[
                    "optimizer.fleet.priority.urgent"
                ],
                "scheduler": FLEET.stats(),
            }
        except Exception:  # noqa: BLE001 — state must stay readable
            return {"clusterId": self.config["optimizer.fleet.cluster.id"]}

    def _mesh_devices(self) -> int:
        """CUDA devices a mesh would span: the visible ones (none when the
        façade runs on the CPU), clamped to ``optimizer.mesh.devices``."""
        import torch

        n = torch.cuda.device_count() if self.device.type == "cuda" else 0
        if self.config["optimizer.mesh.devices"] > 0:
            n = min(n, self.config["optimizer.mesh.devices"])
        return n

    def _mesh_state(self) -> dict:
        """AnalyzerState.observability.mesh: the configured mesh, keyed as
        the JAX package's (never raises — state must stay readable). The
        port has no sharded programs, so their counts are zero; with fewer
        than two devices a run is single-device (``meshShape`` null); with
        two or more the shape is the one a sharded run would build, and
        ``refused`` says why the verbs refuse to run it."""
        out: dict = {
            "enabled": bool(self.config["optimizer.mesh.enabled"]),
            "parts": self.config["optimizer.mesh.parts"],
            "shardedPrograms": {"run": 0, "eval": 0, "max": 0},
        }
        if out["enabled"]:
            try:
                n = self._mesh_devices()
                if n < 2:
                    out["meshShape"] = None  # runs single-device
                else:
                    parts = max(self.config["optimizer.mesh.parts"], 1)
                    if n % parts:
                        parts = 1
                    out["meshShape"] = {"chains": n // parts, "parts": parts}
                    out["refused"] = MESH_REFUSAL
            except Exception:  # noqa: BLE001 — state must stay readable
                out["meshShape"] = None
        return out

    def _incremental_state(self) -> dict:
        """AnalyzerState.incremental: the warm-start drift loop's config
        + live placement-store stats (ccx_torch.search.incremental)."""
        from ccx_torch.search import incremental as _inc

        iopts = self._incremental_options()
        return {
            "enabled": bool(iopts.enabled),
            "armed": bool(iopts.armed),
            "warmSwapIters": iopts.warm_swap_iters,
            "warmSteps": iopts.warm_steps,
            "warmChunkSteps": iopts.warm_chunk_steps,
            "warmChains": iopts.warm_chains,
            "plateauWindow": iopts.plateau_window,
            "warmT0": iopts.warm_t0,
            "store": _inc.STORE.stats(),
        }

    def _devmem_state(self) -> dict:
        """AnalyzerState.observability.deviceMemory / the /observability
        ledger block (never raises — state must stay readable)."""
        try:
            from ccx_torch.common.devmem import DEVMEM

            return DEVMEM.stats()
        except Exception:  # noqa: BLE001 — state must stay readable
            return {}

    def _slo_state(self) -> dict:
        """AnalyzerState.observability.slo: the stream detector's
        VIEWER-safe SLO summary (never raises — state must stay
        readable)."""
        try:
            return self.anomaly_detector.stream.state()
        except Exception:  # noqa: BLE001 — state must stay readable
            return {}

    def _convergence_state(self) -> dict:
        """AnalyzerState.observability.convergenceTaps: taps armed + ring
        depth (never raises — state must stay readable)."""
        try:
            from ccx_torch.search import telemetry

            return {
                "enabled": telemetry.enabled(),
                "maxChunks": telemetry.max_chunks(),
            }
        except Exception:  # noqa: BLE001 — state must stay readable
            return {"enabled": None}

    def _broker_health_metrics(self) -> dict[int, dict[str, float]]:
        """Latest broker-window metrics for the concurrency adjuster (C26)."""
        md = self.admin.describe_cluster()
        agg = self.load_monitor.broker_aggregator.aggregate(len(md.brokers))
        if agg.num_windows == 0:
            return {}
        urp_id = BROKER_METRIC_DEF.metric_info("UNDER_REPLICATED_PARTITIONS").id
        out = {}
        for i, b in enumerate(md.brokers):
            out[b.broker_id] = {
                "UNDER_REPLICATED_PARTITIONS": float(agg.values[i, -1, urp_id])
            }
        return out


def _requirements_for(data_from: str):
    """Ref ``data_from`` parameter: VALID_WINDOWS (default — enough complete
    windows) vs VALID_PARTITIONS (one window, nearly all partitions).
    Invalid values are rejected like the reference's enum parse."""
    from ccx_torch.monitor.aggregator import ModelCompletenessRequirements

    v = data_from.upper()
    if v == "VALID_PARTITIONS":
        return ModelCompletenessRequirements(1, 0.95)
    if v == "VALID_WINDOWS":
        return ModelCompletenessRequirements(1, 0.5)
    raise UserRequestException(
        f"Invalid data_from {data_from!r}; one of VALID_WINDOWS, "
        "VALID_PARTITIONS"
    )


def _restrict_destinations(model, metadata, destination_broker_ids):
    """Ref destination_broker_ids parameter: only the listed brokers may
    receive replicas during this operation."""
    if not destination_broker_ids:
        return model
    import torch

    bidx = metadata.broker_index()
    allowed = torch.zeros(model.B, dtype=torch.bool, device=model.device)
    for b in destination_broker_ids:
        if b in bidx:
            allowed[bidx[b]] = True
    excl = model.broker_valid & ~allowed
    return model.replace(
        broker_excl_replicas=model.broker_excl_replicas | excl
    )


def _host_model(model):
    """The model with every tensor on the CPU: the provisioner SPI reads
    models through numpy, which cannot view a CUDA tensor."""
    import dataclasses as _dc

    import torch

    if model.device.type == "cpu":
        return model
    return model.replace(**{
        f.name: getattr(model, f.name).cpu()
        for f in _dc.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)
    })


def _count_by_broker(md, leaders: bool) -> dict[str, int]:
    counts: dict[str, int] = {str(b.broker_id): 0 for b in md.brokers}
    for p in md.partitions:
        if leaders:
            if p.leader >= 0:
                counts[str(p.leader)] = counts.get(str(p.leader), 0) + 1
        else:
            for b in p.replicas:
                counts[str(b)] = counts.get(str(b), 0) + 1
    return counts


def _identity_metadata(md):
    """Metadata whose dense broker index == broker id is unnecessary for
    proposals already carrying real ids; tasks_from_proposals resolves via
    metadata.brokers order, so build a shim mapping dense idx -> same id."""
    import dataclasses as _dc

    from ccx_torch.common.metadata import BrokerInfo, ClusterMetadata

    max_id = max((b.broker_id for b in md.brokers), default=0)
    brokers = []
    real = {b.broker_id: b for b in md.brokers}
    for i in range(max_id + 1):
        brokers.append(real.get(i, BrokerInfo(i, "", alive=False)))
    return ClusterMetadata(md.generation, tuple(brokers), md.partitions)
