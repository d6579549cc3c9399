"""CruiseControlConfig — the merged per-subsystem key table.

Parity: ``config/{KafkaCruiseControlConfig,MonitorConfig,AnalyzerConfig,
ExecutorConfig,AnomalyDetectorConfig,WebServerConfig,UserTaskManagerConfig}
.java`` (SURVEY.md C35). Key names keep the reference's dotted spelling so an
operator's ``cruisecontrol.properties`` carries over; ccx-specific keys (the
TPU optimizer backend knobs, north star ``goal.optimizer.backend=tpu``,
BASELINE.json:5) live under the ``optimizer.*`` prefix.
"""

from __future__ import annotations

from typing import Any

from ccx_torch.config.definition import (
    NO_DEFAULT,
    ConfigDef,
    ConfigException,
    Importance,
    Type,
    at_least,
    between,
    load_properties,
    non_empty,
    one_of,
)

# Default goal list — AnalyzerConfig `goals` default order (SURVEY.md §2.3).
DEFAULT_GOALS = (
    "RackAwareGoal",
    "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
    "PreferredLeaderElectionGoal",
)

DEFAULT_HARD_GOALS = (
    "RackAwareGoal",
    "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
)


def monitor_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("partition.metrics.window.ms", Type.LONG, 3_600_000, Importance.HIGH,
             "Span of one partition-metrics aggregation window.", at_least(1))
    d.define("num.partition.metrics.windows", Type.INT, 5, Importance.HIGH,
             "Number of partition-metrics windows kept in memory.", at_least(1))
    d.define("broker.metrics.window.ms", Type.LONG, 300_000, Importance.HIGH,
             "Span of one broker-metrics aggregation window.", at_least(1))
    d.define("num.broker.metrics.windows", Type.INT, 20, Importance.HIGH,
             "Number of broker-metrics windows kept in memory.", at_least(1))
    d.define("min.samples.per.partition.metrics.window", Type.INT, 1, Importance.MEDIUM,
             "Minimum samples for a partition window to be valid without "
             "extrapolation.", at_least(1))
    d.define("min.samples.per.broker.metrics.window", Type.INT, 1, Importance.MEDIUM,
             "Minimum samples for a broker window to be valid.", at_least(1))
    d.define("max.allowed.extrapolations.per.partition", Type.INT, 5, Importance.LOW,
             "Extrapolated windows allowed before a partition is invalid.", at_least(0))
    d.define("max.allowed.extrapolations.per.broker", Type.INT, 5, Importance.LOW,
             "Extrapolated windows allowed before a broker is invalid.", at_least(0))
    d.define("metric.sampling.interval.ms", Type.LONG, 120_000, Importance.HIGH,
             "Period of the metric sampling loop.", at_least(1))
    d.define("num.metric.fetchers", Type.INT, 1, Importance.MEDIUM,
             "Parallel sampling fetcher threads (partitions sharded across "
             "them).", at_least(1))
    d.define("metric.sampler.class", Type.CLASS,
             "ccx_torch.monitor.sampling.reporter_sampler.ReporterMetricSampler",
             Importance.HIGH, "MetricSampler SPI implementation (ref C10).")
    d.define("sample.store.class", Type.CLASS,
             "ccx_torch.monitor.sampling.sample_store.FileSampleStore",
             Importance.HIGH,
             "SampleStore SPI implementation; persists samples and replays "
             "them on startup for a warm model (ref C11, checkpoint/resume).")
    d.define("sample.store.dir", Type.STRING, "/tmp/ccx-samples", Importance.MEDIUM,
             "Directory for the default file-backed sample store.")
    d.define("broker.capacity.config.resolver.class", Type.CLASS,
             "ccx_torch.monitor.capacity.FileCapacityResolver",
             Importance.HIGH, "BrokerCapacityConfigResolver SPI (ref C5).")
    d.define("capacity.config.file", Type.STRING, "config/capacity.json",
             Importance.HIGH, "Capacity file for the default resolver.")
    d.define("monitor.state.update.interval.ms", Type.LONG, 30_000, Importance.LOW,
             "Refresh period of cached monitor state.", at_least(1))
    d.define("prometheus.server.endpoint", Type.STRING, "http://127.0.0.1:9090",
             Importance.LOW, "Prometheus base URL for the "
             "PrometheusMetricSampler (ref C10 alternative sampler).")
    d.define("leader.network.inbound.weight.for.cpu.util", Type.DOUBLE, 0.6,
             Importance.LOW, "ModelUtils leader NW_IN coefficient for CPU "
             "estimation (ref C6).", between(0, 10))
    d.define("leader.network.outbound.weight.for.cpu.util", Type.DOUBLE, 0.1,
             Importance.LOW, "ModelUtils leader NW_OUT coefficient.", between(0, 10))
    d.define("follower.network.inbound.weight.for.cpu.util", Type.DOUBLE, 0.3,
             Importance.LOW, "ModelUtils follower NW_IN coefficient.", between(0, 10))
    return d


def analyzer_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("goals", Type.LIST, DEFAULT_GOALS, Importance.HIGH,
             "Goal class names in priority order (lexicographic semantics).",
             non_empty)
    d.define("hard.goals", Type.LIST, DEFAULT_HARD_GOALS, Importance.HIGH,
             "Subset of goals that must be satisfied.", non_empty)
    d.define("default.goals", Type.LIST, (), Importance.MEDIUM,
             "Goals used when a request names none (empty = `goals`).")
    d.define("self.healing.goals", Type.LIST, (), Importance.MEDIUM,
             "Goals used by self-healing (empty = hard goals).")
    d.define("anomaly.detection.goals", Type.LIST, DEFAULT_HARD_GOALS,
             Importance.MEDIUM, "Goals scored by the goal-violation detector.")
    d.define("cpu.balance.threshold", Type.DOUBLE, 1.1, Importance.MEDIUM,
             "Max broker CPU utilization ratio vs cluster average.", at_least(1))
    d.define("disk.balance.threshold", Type.DOUBLE, 1.1, Importance.MEDIUM,
             "Max broker DISK utilization ratio vs average.", at_least(1))
    d.define("network.inbound.balance.threshold", Type.DOUBLE, 1.1, Importance.MEDIUM,
             "Max broker NW_IN utilization ratio vs average.", at_least(1))
    d.define("network.outbound.balance.threshold", Type.DOUBLE, 1.1, Importance.MEDIUM,
             "Max broker NW_OUT utilization ratio vs average.", at_least(1))
    d.define("cpu.capacity.threshold", Type.DOUBLE, 0.7, Importance.MEDIUM,
             "Usable fraction of broker CPU capacity.", between(0, 1))
    d.define("disk.capacity.threshold", Type.DOUBLE, 0.8, Importance.MEDIUM,
             "Usable fraction of broker DISK capacity.", between(0, 1))
    d.define("network.inbound.capacity.threshold", Type.DOUBLE, 0.8,
             Importance.MEDIUM, "Usable fraction of NW_IN capacity.", between(0, 1))
    d.define("network.outbound.capacity.threshold", Type.DOUBLE, 0.8,
             Importance.MEDIUM, "Usable fraction of NW_OUT capacity.", between(0, 1))
    d.define("max.replicas.per.broker", Type.LONG, 10_000, Importance.MEDIUM,
             "ReplicaCapacityGoal limit.", at_least(1))
    d.define("cpu.low.utilization.threshold", Type.DOUBLE, 0.0, Importance.LOW,
             "Below this CPU utilization a broker is ignored by the CPU "
             "distribution goal.", between(0, 1))
    d.define("disk.low.utilization.threshold", Type.DOUBLE, 0.0, Importance.LOW,
             "DISK low-utilization gate.", between(0, 1))
    d.define("network.inbound.low.utilization.threshold", Type.DOUBLE, 0.0,
             Importance.LOW, "NW_IN low-utilization gate.", between(0, 1))
    d.define("network.outbound.low.utilization.threshold", Type.DOUBLE, 0.0,
             Importance.LOW, "NW_OUT low-utilization gate.", between(0, 1))
    d.define("leader.bytes.in.balance.threshold", Type.DOUBLE, 1.1,
             Importance.LOW, "LeaderBytesInDistributionGoal band width.",
             at_least(1))
    d.define("min.topic.leaders.per.broker", Type.INT, 1, Importance.LOW,
             "MinTopicLeadersPerBrokerGoal requirement.", at_least(0))
    d.define("topics.with.min.leaders.per.broker", Type.STRING, "", Importance.LOW,
             "Regex of topics subject to MinTopicLeadersPerBrokerGoal.")
    d.define("topic.replica.count.balance.threshold", Type.DOUBLE, 3.0,
             Importance.LOW, "TopicReplicaDistributionGoal band width.", at_least(1))
    d.define("leader.replica.count.balance.threshold", Type.DOUBLE, 1.1,
             Importance.LOW, "LeaderReplicaDistributionGoal band width.", at_least(1))
    d.define("replica.count.balance.threshold", Type.DOUBLE, 1.1, Importance.MEDIUM,
             "ReplicaDistributionGoal band width.", at_least(1))
    d.define("num.proposal.precompute.threads", Type.INT, 1, Importance.MEDIUM,
             "Background proposal precompute workers (ref C14).", at_least(0))
    d.define("proposal.expiration.ms", Type.LONG, 900_000, Importance.MEDIUM,
             "Cached proposal freshness horizon.", at_least(0))
    d.define("allow.capacity.estimation.on.proposal.precompute", Type.BOOLEAN, True,
             Importance.LOW, "Permit estimated capacities during precompute.")
    # --- ccx TPU backend (north star: goal.optimizer.backend=tpu) ----------
    d.define("goal.optimizer.backend", Type.STRING, "tpu", Importance.HIGH,
             "Proposal search backend: 'tpu' = batched SA + greedy polish on "
             "device (BASELINE.json north star); 'greedy' = host-side greedy "
             "oracle only.", one_of("tpu", "greedy"))
    d.define("optimizer.num.chains", Type.INT, 32, Importance.MEDIUM,
             "SA chains vmapped on device.", at_least(1))
    d.define("optimizer.num.steps", Type.INT, 3000, Importance.MEDIUM,
             "SA steps per chain.", at_least(1))
    d.define("optimizer.moves.per.step", Type.INT, 8, Importance.MEDIUM,
             "SA proposals per chain per scan step, applied as a disjoint "
             "batch on large clusters (AnnealOptions.batched) — total churn "
             "budget is chains * steps * this.", at_least(1))
    d.define("optimizer.seed", Type.INT, 42, Importance.LOW, "SA PRNG seed.")
    d.define("optimizer.chunk.steps", Type.INT, 500, Importance.LOW,
             "Run the SA scan in fixed chunks of this many steps so one "
             "compiled program serves every optimizer.num.steps budget "
             "(the step count never keys a new program); "
             "0 = single scan keyed on the full step count. Results are "
             "bit-exact either way. Covers EVERY drive path — "
             "single-device, chains-mesh data parallelism and the "
             "partition-axis-sharded engine (optimizer.mesh.*) all run "
             "the same chunk contract with per-chunk heartbeats.",
             at_least(0))
    d.define("optimizer.mesh.enabled", Type.BOOLEAN, False, Importance.MEDIUM,
             "Run the SA search sharded over several CUDA devices. The "
             "port has no multi-GPU sharding yet: with fewer than two "
             "visible CUDA devices the search runs on one device and "
             "AnalyzerState reports meshShape null; with two or more the "
             "facade refuses the run (ConfigException) until the "
             "sharding slice lands.")
    d.define("optimizer.mesh.devices", Type.INT, 0, Importance.LOW,
             "Devices for the optimizer mesh; 0 = all visible devices.",
             at_least(0))
    d.define("optimizer.mesh.parts", Type.INT, 1, Importance.LOW,
             "Partition-axis factor of the optimizer mesh (chains = "
             "devices / parts). 1 = chains-only data parallelism; raise "
             "for clusters whose per-device model shard (100k+ "
             "partitions) matters more than extra chains. A factor that "
             "does not divide the device count (or the padded partition "
             "axis) falls back to chains-only with a log note.",
             at_least(1))
    d.define("optimizer.polish.candidates", Type.INT, 256, Importance.LOW,
             "Greedy polish candidate moves per iteration.", at_least(1))
    d.define("optimizer.polish.max.iters", Type.INT, 400, Importance.LOW,
             "Greedy polish iteration cap.", at_least(1))
    d.define("optimizer.polish.chunk.iters", Type.INT, 50, Importance.LOW,
             "Iterations per jitted chunk program of the host-driven "
             "greedy-polish descent (the leadership pass and the "
             "topic-rebalance re-polish share the engine). The ONLY "
             "shape-bearing polish budget: max-iters/patience stay traced "
             "data, so every budget shares one compiled chunk per shape "
             "and the worst-case XLA compile is one small chunk program, "
             "not the whole iteration loop. 0 = monolithic "
             "while_loop (bit-exact with the chunked engine; the parity "
             "reference).", at_least(0))
    d.define("optimizer.swap.polish.chunk.iters", Type.INT, 50,
             Importance.LOW,
             "Iterations per jitted chunk program of the usage-coupled "
             "swap-polish descent — the optimizer.polish.chunk.iters twin "
             "(0 = monolithic while_loop; budgets stay traced either "
             "way).", at_least(0))
    d.define("optimizer.topic.rebalance.rounds", Type.INT, 2, Importance.LOW,
             "Sweep+polish rounds of the targeted TopicReplicaDistribution "
             "stage (each enumerates over-band (topic, broker) cells, "
             "re-polishes, and is adopted only on full-vector lex "
             "improvement). 0 disables.", at_least(0))
    d.define("optimizer.topic.rebalance.move.leaders", Type.BOOLEAN, True,
             Importance.LOW,
             "Let the topic-rebalance stage shed leader-held over cells by "
             "transferring leadership to a co-replica first (hard-safe; "
             "the final leadership pass rebalances afterwards). Disable "
             "for latency-bounded sweeps where follower moves are "
             "cheaper.")
    d.define("optimizer.topic.rebalance.max.sweeps", Type.INT, 1024,
             Importance.LOW,
             "Per-round sweep cap for the topic-rebalance stage. The sweep "
             "loop stops on its own when no move lands, so this is a "
             "latency bound, not a convergence knob; the default lets a "
             "round run to convergence. Latency-critical callers lower it.",
             at_least(1))
    d.define("optimizer.topic.rebalance.guarded", Type.BOOLEAN, True,
             Importance.LOW,
             "Run the topic-rebalance stage's re-polish with the "
             "TopicReplicaDistribution guard first (vetoes moves that "
             "worsen the TRD tier, so the usage re-polish cannot trade the "
             "shed's topic cells back), falling back to an unguarded "
             "polish when the guarded one fails lex adoption.")
    d.define("optimizer.topic.rebalance.polish.iters", Type.INT, -1,
             Importance.LOW,
             "Iteration budget for the topic-rebalance stage's re-polish; "
             "-1 inherits optimizer.polish.max.iters. A converged shed "
             "relocates ~55k replicas at B5 scale — the post-shed cleanup "
             "often needs more budget than the pre-shed polish.",
             at_least(-1))
    d.define("optimizer.leader.pass.max.iters", Type.INT, -1, Importance.LOW,
             "Iteration cap for the final leadership-only pass; -1 = "
             "uncapped (inherit optimizer.polish.max.iters).", at_least(-1))
    d.define("optimizer.polish.batch.moves", Type.INT, 16, Importance.LOW,
             "Non-conflicting improving moves applied per polish iteration "
             "(disjoint partitions/topics/broker sets; 1 = classic "
             "best-move hill climbing).", at_least(1))
    d.define("optimizer.portfolio.cold.greedy", Type.BOOLEAN, True,
             Importance.LOW,
             "Also run the greedy oracle from the input placement and return "
             "the lexicographic winner (the GoalOptimizer precompute-cache "
             "portfolio pattern). Costs roughly one extra polish-budget run "
             "per optimize() call; disable for latency-sensitive endpoints. "
             "Leadership-only and disk-only fast paths skip it regardless.")
    d.define("optimizer.swap.coupling", Type.DOUBLE, 0.5, Importance.LOW,
             "Share of SA swap proposals drawn usage-coupled (both "
             "endpoints Gumbel-selected from a candidate pool ranked by "
             "live broker band pressure x per-replica usage) instead of "
             "uniformly. 0 restores the uniform draw; coupling is what "
             "lets a lean budget hit the specific different-topic pairs "
             "that fix residual NetworkOutUsage/LeaderReplica cells.",
             between(0, 1))
    d.define("optimizer.swap.p.swap", Type.DOUBLE, 0.15, Importance.LOW,
             "REPLICA_SWAP share of SA proposals (AnnealOptions.p_swap; "
             "intra-broker stacks force 0).", between(0, 1))
    d.define("optimizer.swap.p.swap.end", Type.DOUBLE, -1.0, Importance.LOW,
             "End value of the linear p_swap schedule: the swap share "
             "anneals from optimizer.swap.p.swap to this value over the "
             "run (swaps matter most once count tiers settle). -1 = "
             "constant share. The schedule enters compiled programs as "
             "data — retunes never recompile the SA chunk.",
             between(-1, 1))
    d.define("optimizer.exchange.n.temps", Type.INT, 1, Importance.LOW,
             "Temperature rungs of the SA replica-exchange ladder "
             "(AnnealOptions.n_temps). >1 partitions the chain batch "
             "into K rungs on a geometric temperature ladder between t1 "
             "and t0 and swaps chain STATES between neighboring rungs at "
             "chunk boundaries (Metropolis on the soft-cost scalar, lex "
             "tie-break; the lex-best chain never leaves the coldest "
             "rung). A pure permutation of the batch axis: no new "
             "compiled-program shapes. 1 = flat chains (bit-exact legacy "
             "path). Requires optimizer.chunk.steps > 0.", at_least(1))
    d.define("optimizer.exchange.interval", Type.INT, 1, Importance.LOW,
             "Chunk boundaries between replica-exchange sweeps (1 = "
             "every chunk). Enters compiled programs as data — retunes "
             "never recompile the SA chunk.", at_least(1))
    d.define("optimizer.bf16.scoring", Type.BOOLEAN, False, Importance.LOW,
             "Opt-in bf16 scoring tier: rank-order-only intermediates "
             "(band-pressure x usage pool scores feeding the coupled-swap "
             "Gumbel picks) accumulate in bfloat16; every lex cost "
             "vector and accept/exchange decision stays f32. A "
             "throughput knob for the TPU MXU — leave False on CPU "
             "correctness paths.")
    d.define("optimizer.swap.polish.iters", Type.INT, 150, Importance.LOW,
             "Iteration budget for the usage-coupled swap-polish phase "
             "(count-preserving replica swaps + pressure-coupled "
             "leadership transfers, pure lexicographic descent, run after "
             "the topic-rebalance stage). 0 disables. The budget is "
             "while_loop data — every setting shares one compiled "
             "program. Leadership-/disk-only fast paths skip the phase.",
             at_least(0))
    d.define("optimizer.swap.polish.post.iters", Type.INT, 150,
             Importance.LOW,
             "Iteration budget for the SECOND swap-polish invocation, run "
             "after the leadership pass (the uniform leader pass stalls "
             "on LeaderReplica/LeaderBytesIn cells only the coupled draw "
             "finds). 0 disables; shares the pre-leader stage's compiled "
             "program.", at_least(0))
    d.define("optimizer.swap.polish.candidates", Type.INT, 128,
             Importance.LOW,
             "Coupled candidates scored per swap-polish iteration, split "
             "evenly between replica-swap pairs and leadership transfers "
             "(static program shape, shared by the pre- and post-leader "
             "invocations).", at_least(1))
    d.define("optimizer.swap.polish.guarded", Type.BOOLEAN, True,
             Importance.LOW,
             "Veto swap-polish candidates that significantly worsen the "
             "TopicReplicaDistribution tier (different-topic swaps move "
             "topic cells; the guard keeps a converged shed's TRD=0 from "
             "being traded back for usage cells — same rationale as "
             "optimizer.topic.rebalance.guarded).")
    d.define("optimizer.fleet.max.concurrent", Type.INT, 0, Importance.LOW,
             "Device-residency cap of the multi-job chunk scheduler "
             "(ccx.search.scheduler): at most this many concurrent "
             "optimization jobs interleave chunks on the device while the "
             "rest queue in (priority, arrival) order. 0 = unlimited. "
             "Bound it when N concurrent jobs' donated carries would "
             "pressure HBM past the snapshot registry's budget.",
             at_least(0))
    d.define("optimizer.fleet.dispatch.width", Type.INT, 0, Importance.LOW,
             "Simultaneous chunk-dispatch grants of the fleet scheduler. "
             "0 = auto (host core count, floor 2). Width 1 is strict "
             "round-robin alternation; the wider default matters on the "
             "CPU backend, where a dispatch largely IS the execution — "
             "on an accelerator the grant covers only the async enqueue. "
             "Grant ORDER stays priority-first/round-robin at any width.",
             at_least(0))
    d.define("optimizer.fleet.cluster.id", Type.STRING, "default",
             Importance.LOW,
             "This facade's cluster id on the fleet scheduler: the job "
             "label its verbs register under (spans, heartbeats and "
             "Prometheus histograms carry job=<cluster-id>), and the "
             "per-cluster mutual-exclusion key of the proposal path (two "
             "proposals for the same cluster serialize; different "
             "clusters never convoy).")
    d.define("optimizer.fleet.priority.urgent", Type.INT, 10,
             Importance.LOW,
             "Scheduler priority of urgent (self-healing) verbs — "
             "fix-offline-replicas, self-healing rebalances. Higher "
             "preempts queued lower-priority jobs at the next chunk "
             "boundary; normal dryrun verbs run at priority 0.",
             at_least(0))
    d.define("optimizer.fleet.snapshot.hbm.mb", Type.INT, 0, Importance.LOW,
             "HBM budget (MB) for the sidecar's device-resident snapshot "
             "registry (N cluster models kept live, LRU-evicted). 0 = "
             "auto: half of (device HBM capacity - the cost observatory's "
             "captured working-set watermark), floor 64 MB "
             "(ccx.common.costmodel.fleet_snapshot_budget_bytes). Also "
             "the fallback budget of the unified device-memory ledger "
             "when optimizer.devmem.budget.mb is 0.",
             at_least(0))
    d.define("optimizer.devmem.budget.mb", Type.INT, 0, Importance.LOW,
             "Budget (MB) of the UNIFIED device-memory ledger "
             "(ccx.common.devmem): one byte-priced pool for snapshot "
             "device models, warm placement bases and the compiled-"
             "program working set together, with priority-aware "
             "eviction (an urgent self-healing job's residents are "
             "never displaced by a dryrun admission; lowest-priority / "
             "least-recently-used go first; eviction degrades to a "
             "rebuild or a documented ColdStartRequired cold start, "
             "never a failed RPC). 0 = fall through to "
             "optimizer.fleet.snapshot.hbm.mb, else the auto "
             "derivation. Env twin: CCX_DEVMEM_BUDGET_MB.",
             at_least(0))
    d.define("optimizer.incremental.enabled", Type.BOOLEAN, False,
             Importance.MEDIUM,
             "Arm incremental re-optimization (ccx.search.incremental): "
             "the facade's proposal verbs and the sidecar's warm-start "
             "Propose path keep each cluster session's last converged "
             "placement device-resident, re-score only drift-touched "
             "bands on a new metrics window, warm-start the search from "
             "the previous solution with a short plateau-terminated "
             "budget, and emit the minimal diff. Off (default) restores "
             "from-scratch proposals everywhere; env CCX_INCREMENTAL=0 "
             "force-disables regardless of this key.")
    d.define("optimizer.incremental.warm.swap.iters", Type.INT, 8,
             Importance.LOW,
             "Usage-coupled swap-polish iterations of a warm re-proposal "
             "— the primary warm engine (pure lex descent over "
             "pressure-ranked swaps + leadership transfers; re-scores "
             "the band-pressure tables from carried aggregates each "
             "iteration). 8 is the <500 ms B5 operating point on the "
             "banked host (~18 ms/iteration there). 0 disables.",
             at_least(0))
    d.define("optimizer.incremental.warm.swap.patience", Type.INT, 3,
             Importance.LOW,
             "Consecutive no-improvement iterations before the warm "
             "swap polish stops (traced — its plateau rule).",
             at_least(1))
    d.define("optimizer.incremental.warm.swap.candidates", Type.INT, 32,
             Importance.LOW,
             "Candidate pool of the warm swap polish (split evenly "
             "between replica-swap pairs and leadership transfers). The "
             "applied disjoint batch saturates near 16 moves/iteration, "
             "so pools past ~32 buy wall, not quality, on a warm "
             "budget.", at_least(2))
    d.define("optimizer.incremental.warm.steps", Type.INT, 100,
             Importance.LOW,
             "SA step budget (upper bound) of the STRUCTURAL-damage warm "
             "path (repair + targeted SA before the swap polish); the "
             "plateau exit usually stops earlier.", at_least(1))
    d.define("optimizer.incremental.warm.chunk.steps", Type.INT, 25,
             Importance.LOW,
             "Steps per warm SA chunk — the plateau-decision granularity "
             "(its own small compiled chunk program, paid once).",
             at_least(1))
    d.define("optimizer.incremental.warm.chains", Type.INT, 2,
             Importance.LOW,
             "SA chains of the warm run: warm starts are exploitation, "
             "not exploration.", at_least(1))
    d.define("optimizer.incremental.warm.moves", Type.INT, 8,
             Importance.LOW,
             "Proposals per chain step of the warm run.", at_least(1))
    d.define("optimizer.incremental.plateau.window", Type.INT, 1,
             Importance.LOW,
             "Chunks without lexicographic improvement before the warm "
             "drive stops (the plateau-terminated budget, read from the "
             "convergence taps at the existing chunk boundary). Host "
             "data: retuning it never recompiles any program.",
             at_least(1))
    d.define("optimizer.incremental.warm.t0", Type.DOUBLE, 1e-8,
             Importance.LOW,
             "Warm-run initial temperature (soft-cost units): effectively "
             "pure descent — a converged placement is refined, never "
             "re-randomized, and a tiny budget must not net-accept "
             "Metropolis noise it has no budget to recover from.",
             at_least(0.0))
    d.define("optimizer.incremental.warm.leader.iters", Type.INT, 0,
             Importance.LOW,
             "Leadership-only greedy iterations after the warm SA "
             "(0 = skip): leader-bytes drift sometimes needs transfers "
             "the low-temperature SA misses.", at_least(0))
    d.define("optimizer.incremental.max.sessions", Type.INT, 32,
             Importance.LOW,
             "COUNT backstop on the process-wide warm-placement store "
             "(~12 MB of device arrays per B5-scale session). Warm "
             "bases are primarily BYTE-priced on the unified device-"
             "memory ledger (optimizer.devmem.budget.mb) next to the "
             "snapshot models, with priority-aware eviction; this cap "
             "only bounds the session count on top. An evicted session "
             "simply cold-starts on its next proposal.",
             at_least(1))
    d.define("optimizer.scenario.seed", Type.INT, 7, Importance.LOW,
             "Seed of the adversarial scenario generator "
             "(ccx.bench.scenarios): the whole family x window corpus — "
             "cascading broker failures, full-disk evacuation, hot-topic "
             "skew, broker add/demote/remove waves, partition-count "
             "changes — is a pure function of (base snapshot, seed, "
             "windows). Env twin for the bench rung: CCX_SCENARIO_SEED.",
             at_least(0))
    d.define("optimizer.scenario.windows", Type.INT, 4, Importance.LOW,
             "Windows per scenario family (cumulative damage steps). "
             "Every window of every family keeps the base snapshot's "
             "padded program-shape buckets by construction, so the "
             "whole matrix runs zero-compile after one prewarm pass. "
             "Env twin: CCX_SCENARIO_WINDOWS.", at_least(1))
    d.define("optimizer.scenario.families", Type.LIST, (), Importance.LOW,
             "Scenario families to emit (empty = all five: "
             "broker-failures, disk-evacuation, hot-skew, broker-wave, "
             "partition-change). Env twin: CCX_SCENARIO_FAMILIES "
             "(comma-separated).")
    d.define("optimizer.plan.enabled", Type.BOOLEAN, False, Importance.LOW,
             "Movement planning (ccx.search.movement): wave-"
             "schedule every proposal's columnar diff into throttle-"
             "respecting execution waves (per-broker concurrent-move caps "
             "+ per-wave byte budgets) and surface the schedule as the "
             "additive OptimizerResult.plan block the executor consumes "
             "(wave = batch). Off (default) is bit-exact with the "
             "pre-plan pipeline and compiles nothing new; warm windows "
             "re-plan the remaining waves as completions arrive as delta "
             "snapshots.")
    d.define("optimizer.plan.cost.tier", Type.BOOLEAN, False,
             Importance.LOW,
             "Append the movement-cost tier to the lexicographic "
             "portfolio adoption: a quality TIE between candidate "
             "placements resolves toward the one moving fewer bytes / "
             "pressing brokers less (bytes moved, then peak per-broker "
             "inbound bytes, computed on device from the same assignment "
             "tensors the columnar diff masks). Off (default) keeps the "
             "plain lex rule bit-exact and never compiles the cost "
             "program.")
    d.define("optimizer.plan.max.waves", Type.INT, 64, Importance.LOW,
             "Wave-axis size of the compiled scheduler state (static "
             "program shape — changing it recompiles the planner; caps "
             "and budgets below are traced data and retune for free). A "
             "diff that fits no feasible wave overflows into the last "
             "one and is reported (plan.overflowRows).", at_least(2))
    d.define("optimizer.plan.broker.cap", Type.INT, 5, Importance.LOW,
             "Per-broker concurrent-move cap per wave (source or "
             "destination), the planning image of "
             "num.concurrent.partition.movements.per.broker / the "
             "concurrency adjuster's live cap. Traced data.", at_least(1))
    d.define("optimizer.plan.wave.bytes.mb", Type.DOUBLE, 0.0,
             Importance.LOW,
             "Per-broker per-wave byte budget in model load units (MB) — "
             "the ReplicationThrottleHelper image: at throttle rate R "
             "and target wave duration T set ~R*T. <=0 = uncapped "
             "(count caps only). Traced data.")
    d.define("optimizer.plan.throttle.mbps", Type.DOUBLE, 0.0,
             Importance.LOW,
             "Per-broker replication rate (MB/s) pricing the projected "
             "wave durations (plan.waveSeconds / makespanSeconds). <=0 "
             "reports relative byte units. Traced data.")
    d.define("optimizer.plan.throttle.measured", Type.BOOLEAN, True,
             Importance.LOW,
             "Close the wave-pricing feedback loop: when the executor "
             "has MEASURED per-wave completion rates (the EWMA MB/s in "
             "its observability plan block), re-plans price the "
             "remaining waves with the measured rate instead of the "
             "static optimizer.plan.throttle.mbps. False pins the "
             "static rate (bit-exact pre-feedback pricing).")
    d.define("optimizer.repair.backend", Type.STRING, "device",
             Importance.LOW,
             "hard_repair loop driver: 'device' runs the whole sweep loop "
             "as one compiled program (traced sweep budget, no per-sweep "
             "host syncs — repair leaves the host-blocking critical path); "
             "'host' restores the python loop (one jitted sweep + one sync "
             "per iteration), the fallback and parity reference.",
             one_of("device", "host"))
    d.define("optimizer.repair.overlap", Type.BOOLEAN, False, Importance.LOW,
             "Overlap hard repair with the first SA chunk: repair runs in "
             "a background thread while the first chunk anneals the "
             "still-infeasible input, then the candidates lex-merge. Only "
             "buys wall-clock where repair executes outside the device "
             "stream the SA chunk occupies (host-backend repair on a "
             "multi-core host); the default pipelined device repair "
             "already keeps repair off the critical path.")
    d.define("optimizer.profile.dir", Type.STRING, "", Importance.LOW,
             "When non-empty, capture a torch.profiler trace (Chrome "
             "trace JSON, the card's kernels included) of each proposal "
             "computation into this directory (SURVEY.md 5.1: the device-"
             "side analogue of the reference's JMX "
             "proposal-computation-timer).")
    return d


def observability_config_def() -> ConfigDef:
    """Flight-recorder tracing keys (ccx.common.tracing; SURVEY.md §5.1
    rebuild note — the host-side OperationProgress/Dropwizard analogue,
    extended so a SIGKILLed TPU window still leaves a diagnosis)."""
    d = ConfigDef()
    d.define("observability.flight.recorder.path", Type.STRING, "",
             Importance.MEDIUM,
             "When non-empty, stream every span start/end, chunk heartbeat "
             "and watchdog dump to this JSONL file (append + atomic "
             "per-record write, so a killed or timed-out proposal run "
             "leaves a file whose last line names the active phase, chunk "
             "index and compile attribution at death — read it with "
             "`python -m ccx.common.tracing <file>`). Empty = recorder "
             "disarmed unless the CCX_FLIGHT_RECORDER env var is set.")
    d.define("observability.watchdog.seconds", Type.DOUBLE, 0.0,
             Importance.MEDIUM,
             "Stall watchdog: when > 0 and no span event or chunk "
             "heartbeat arrives for this long while spans are active, dump "
             "all-thread stacks + the active span stacks + live "
             "compilestats into the flight recorder (and stderr) — one "
             "dump per stall episode, re-armed by the next heartbeat. 0 "
             "disables (env override: CCX_WATCHDOG_SECONDS).", at_least(0))
    d.define("observability.trace.sync", Type.BOOLEAN, False,
             Importance.LOW,
             "Device-honest span timing: drain the device stream "
             "(block_until_ready on a freshly dispatched scalar) at every "
             "span close, so per-phase walls measure device completion "
             "rather than dispatch. Default off — syncing forfeits the "
             "measured repair/anneal dispatch overlap; enable for TPU "
             "timing studies only (env override: CCX_TRACE_SYNC=1).")
    d.define("observability.cost.capture", Type.BOOLEAN, False,
             Importance.MEDIUM,
             "Device cost observatory (ccx.common.costmodel): capture "
             "compiled.cost_analysis()/memory_analysis() for every NEW "
             "program shape the optimizer runs — per-program XLA FLOPs, "
             "bytes accessed and argument/output/temp HBM, rolled up as "
             "the costModel block on every proposal result, the "
             "/observability ledger, and roofline-projected per phase. "
             "The capture flush is one extra AOT compile per program "
             "shape (served by the persistent compile cache when armed), "
             "paid on the cold path only — warm runs never capture. "
             "Default off for embedded use; bench.py and the standalone "
             "sidecar arm it (env override: CCX_COST_CAPTURE=1/0).")
    d.define("observability.cost.peak.tflops", Type.DOUBLE, 0.0,
             Importance.LOW,
             "Roofline ceiling override for the CURRENT device: peak "
             "TFLOP/s used by the cost model's projections. 0 = use the "
             "built-in device-spec table (ccx_torch.common.costmodel."
             "DEVICE_SPECS: NVIDIA H100 SXM and PCIe published peaks; no "
             "roofline on the CPU).", at_least(0))
    d.define("observability.cost.hbm.gbps", Type.DOUBLE, 0.0,
             Importance.LOW,
             "Roofline ceiling override for the CURRENT device: HBM "
             "bandwidth in GB/s used by the cost model's projections. "
             "0 = use the built-in device-spec table.", at_least(0))
    d.define("observability.convergence", Type.BOOLEAN, True,
             Importance.MEDIUM,
             "Convergence telemetry taps (ccx.search.telemetry): thread a "
             "device-resident ring buffer through every chunk-driven "
             "search engine, recording per chunk the full per-goal lex "
             "cost vector, per-move-kind proposal/acceptance counters and "
             "the SA temperature — surfaced as the convergence block on "
             "every proposal result, tier-0 energy on flight-recorder "
             "heartbeats, per-job /observability timelines and the "
             "convergence-energy/plateau-step Prometheus gauges; "
             "tools/convergence_report.py turns it into per-phase plateau "
             "and budget proposals. Zero added host syncs and shape-"
             "stable (budget retunes never recompile). False restores "
             "today's compiled programs bit-exactly (env override: "
             "CCX_CONVERGENCE=0).")
    d.define("observability.faults.spec", Type.STRING, "",
             Importance.LOW,
             "Deterministic fault injection (ccx.common.faults, the chaos "
             "layer): a ;-separated schedule of "
             "seam:action@N rules armed at startup — seams "
             "snapshot.transfer / registry.graft / placement.bank / "
             "device.diff / rpc.frame / scheduler.grant / compile, "
             "actions raise / exhaust / sever / delay / corrupt, fired "
             "on the Nth hit (N+ from the Nth on, N/M every Mth, * "
             "always). Empty (the default) leaves the registry DISARMED: "
             "every seam is a single no-op attribute read and the "
             "serving path is bit-exact vs a tree without the chaos "
             "layer. Env twin for bench/standalone entry points: "
             "CCX_FAULTS.")
    d.define("observability.faults.seed", Type.INT, 0,
             Importance.LOW,
             "Seed of the fault registry's corrupt-action RNG (keyed "
             "(seed, seam, hit) — same spec + seed replays the same "
             "faults byte-identically). Env twin: CCX_FAULTS_SEED.",
             at_least(0))
    d.define("observability.slo.window.seconds", Type.DOUBLE, 10.0,
             Importance.MEDIUM,
             "Span of one SLO accounting window (ccx.common.slo): the "
             "windowed SLO engine buckets serving windows at this "
             "cadence, and the soak rung advances its simulated fleet "
             "clock by this much per tick. Time-to-detect/heal are "
             "measured on the same clock.", at_least(0.001))
    d.define("observability.slo.short.windows", Type.INT, 12,
             Importance.LOW,
             "Short (paging) burn-rate window, in serving-window counts "
             "— the fast half of the classic multi-window SLO alert.",
             at_least(1))
    d.define("observability.slo.long.windows", Type.INT, 60,
             Importance.LOW,
             "Long (ticket) burn-rate window, in serving-window counts.",
             at_least(1))
    d.define("observability.slo.warm.target", Type.DOUBLE, 0.95,
             Importance.MEDIUM,
             "Warm-served SLO target: fraction of serving windows that "
             "must be answered by the warm incremental path AND verify. "
             "The error budget is 1 - target; the "
             "ccx_slo_burn_rate{objective=\"warm_served\"} gauge reports "
             "budget burn against it.", between(0, 1))
    d.define("observability.slo.latency.budget.seconds", Type.DOUBLE, 5.0,
             Importance.MEDIUM,
             "Per-window end-to-end latency budget: windows at or under "
             "this wall count toward the latency SLO; the stream "
             "detector classifies windows over it as latency_burst.",
             at_least(0.001))
    d.define("observability.slo.latency.target", Type.DOUBLE, 0.99,
             Importance.LOW,
             "Latency SLO target fraction (the p99-style budget: 0.99 "
             "means 1% of windows may exceed the latency budget).",
             between(0, 1))
    d.define("observability.slo.dwell.target", Type.DOUBLE, 0.95,
             Importance.LOW,
             "Goal-violation dwell SLO target: fraction of windows that "
             "must carry NO classified anomaly signal — bounds how much "
             "of the timeline the fleet may spend in violation.",
             between(0, 1))
    d.define("observability.convergence.max.chunks", Type.INT, 256,
             Importance.LOW,
             "Ring-buffer depth of the convergence taps, in chunk rows. "
             "Program SHAPE like the chunk sizes (changing it mints new "
             "compiled chunk programs — a deployment choice, not a "
             "per-run retune); runs longer than this keep the opening "
             "rows plus the latest chunk and are flagged truncated. "
             "Default 256 covers every banked rung with an order of "
             "magnitude to spare at ~20 KB of HBM.", at_least(1))
    return d


def executor_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("num.concurrent.partition.movements.per.broker", Type.INT, 5,
             Importance.HIGH, "Per-broker inter-broker movement cap.", at_least(1))
    d.define("num.concurrent.intra.broker.partition.movements", Type.INT, 2,
             Importance.MEDIUM, "Per-broker intra-broker (disk) movement cap.",
             at_least(1))
    d.define("num.concurrent.leader.movements", Type.INT, 1000, Importance.HIGH,
             "Cluster-wide leadership movement batch cap.", at_least(1))
    d.define("max.num.cluster.movements", Type.INT, 1250, Importance.MEDIUM,
             "Cluster-wide cap on in-flight movements.", at_least(1))
    d.define("execution.progress.check.interval.ms", Type.LONG, 10_000,
             Importance.HIGH, "Progress polling period during execution.",
             at_least(1))
    d.define("default.replication.throttle", Type.LONG, -1, Importance.MEDIUM,
             "Replication throttle (bytes/s) applied during execution; -1 = "
             "no throttle.")
    d.define("replica.movement.strategies", Type.LIST,
             ("ccx_torch.executor.strategy.PrioritizeMinIsrWithOfflineReplicasStrategy",
              "ccx_torch.executor.strategy.PostponeUrpReplicaMovementStrategy",
              "ccx_torch.executor.strategy.PrioritizeLargeReplicaMovementStrategy"),
             Importance.MEDIUM,
             "Chained ReplicaMovementStrategy classes (ref C25).")
    d.define("default.replica.movement.strategy.class", Type.CLASS,
             "ccx_torch.executor.strategy.BaseReplicaMovementStrategy",
             Importance.LOW, "Tie-breaking tail of the strategy chain.")
    d.define("executor.concurrency.adjuster.enabled", Type.BOOLEAN, True,
             Importance.MEDIUM, "Auto-tune movement concurrency from live "
             "broker health (ref C26).")
    d.define("executor.concurrency.adjuster.interval.ms", Type.LONG, 30_000,
             Importance.LOW, "Concurrency adjuster period.", at_least(1))
    d.define("executor.concurrency.adjuster.max.partition.movements.per.broker",
             Type.INT, 12, Importance.LOW, "Adjuster upper bound.", at_least(1))
    d.define("executor.concurrency.adjuster.min.partition.movements.per.broker",
             Type.INT, 1, Importance.LOW, "Adjuster lower bound.", at_least(1))
    d.define("leader.movement.timeout.ms", Type.LONG, 180_000, Importance.LOW,
             "Leadership movement completion timeout.", at_least(1))
    d.define("task.execution.alerting.threshold.ms", Type.LONG, 90_000,
             Importance.LOW, "Warn when a task runs longer than this.", at_least(1))
    d.define("admin.client.class", Type.CLASS,
             "ccx_torch.executor.admin.SimulatedAdminClient", Importance.HIGH,
             "AdminApi SPI implementation — the only component that writes "
             "to the managed cluster (ref C28). Set to "
             "ccx_torch.executor.kafka_admin.KafkaAdminApi (requires kafka-python "
             "+ bootstrap.servers) to drive a real cluster.")
    d.define("admin.request.timeout.ms", Type.LONG, 30_000, Importance.LOW,
             "Request timeout for the real-cluster admin client.", at_least(1))
    return d


def anomaly_detector_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("anomaly.detection.interval.ms", Type.LONG, 300_000, Importance.HIGH,
             "Default detector period (per-type overrides below).", at_least(1))
    d.define("goal.violation.detection.interval.ms", Type.LONG, -1, Importance.LOW,
             "Goal-violation detector period; -1 = default interval.")
    d.define("metric.anomaly.detection.interval.ms", Type.LONG, -1, Importance.LOW,
             "Metric-anomaly detector period; -1 = default interval.")
    d.define("disk.failure.detection.interval.ms", Type.LONG, -1, Importance.LOW,
             "Disk-failure detector period; -1 = default interval.")
    d.define("topic.anomaly.detection.interval.ms", Type.LONG, -1, Importance.LOW,
             "Topic-anomaly detector period; -1 = default interval.")
    d.define("broker.failure.detection.backoff.ms", Type.LONG, 300_000,
             Importance.LOW, "Broker-failure re-check backoff.", at_least(1))
    d.define("failed.brokers.file.path", Type.STRING, "", Importance.LOW,
             "File persisting broker-failure first-seen times across "
             "restarts (ref failed.brokers.zk.path/file); empty = "
             "<sample.store.dir>/failed_brokers.json.")
    d.define("anomaly.notifier.class", Type.CLASS,
             "ccx_torch.detector.notifier.SelfHealingNotifier", Importance.HIGH,
             "AnomalyNotifier SPI (ref C30).")
    d.define("self.healing.enabled", Type.BOOLEAN, False, Importance.HIGH,
             "Master switch for automatic anomaly fixing.")
    d.define("self.healing.exclude.recently.demoted.brokers", Type.BOOLEAN, True,
             Importance.LOW, "Exclude recently demoted brokers from fixes.")
    d.define("self.healing.exclude.recently.removed.brokers", Type.BOOLEAN, True,
             Importance.LOW, "Exclude recently removed brokers from fixes.")
    d.define("broker.failure.alert.threshold.ms", Type.LONG, 900_000,
             Importance.HIGH, "Grace before alerting on a dead broker.", at_least(0))
    d.define("broker.failure.self.healing.threshold.ms", Type.LONG, 1_800_000,
             Importance.HIGH, "Grace before auto-fixing a dead broker.", at_least(0))
    d.define("metric.anomaly.finder.class", Type.CLASS,
             "ccx_torch.detector.slow_broker.SlowBrokerFinder", Importance.MEDIUM,
             "MetricAnomalyFinder SPI (ref C29).")
    d.define("slow.broker.bytes.in.rate.detection.threshold", Type.DOUBLE, 1024.0,
             Importance.LOW, "Min bytes-in rate (KB/s) for slow-broker "
             "eligibility.", at_least(0))
    d.define("slow.broker.log.flush.time.threshold.ms", Type.DOUBLE, 1000.0,
             Importance.LOW, "Log-flush-time threshold for slowness.", at_least(0))
    d.define("slow.broker.metric.history.percentile.threshold", Type.DOUBLE, 90.0,
             Importance.LOW, "History percentile a slow broker must exceed.",
             between(0, 100))
    d.define("topic.anomaly.finder.class", Type.CLASS,
             "ccx_torch.detector.detectors.TopicReplicationFactorAnomalyFinder",
             Importance.LOW, "TopicAnomalyFinder SPI.")
    d.define("target.topic.replication.factor", Type.INT, 0, Importance.LOW,
             "Desired RF for topic-anomaly detection; 0 disables the finder "
             "(ref: the RF finder is opt-in — an uninvited RF 'fix' can make "
             "rack-awareness infeasible).", at_least(0))
    d.define("maintenance.event.reader.class", Type.CLASS,
             "ccx_torch.detector.detectors.NoopMaintenanceEventReader",
             Importance.LOW, "MaintenanceEventReader SPI.")
    d.define("provisioner.class", Type.CLASS,
             "ccx_torch.detector.provisioner.BasicProvisioner", Importance.LOW,
             "Provisioner SPI behind the rightsize endpoint (ref C21).")
    d.define("anomaly.detection.allow.unready.cluster", Type.BOOLEAN, False,
             Importance.LOW, "Run detectors before monitor windows are ready.")
    d.define("detector.stream.enabled", Type.BOOLEAN, True, Importance.MEDIUM,
             "Enable the live-stream anomaly detector (ccx.detector.stream): "
             "classifies every serving window's flowing signals — heartbeat "
             "energy, warm-pressure bands, goal-violation and devmem gauges "
             "— and fires the SAME facade anomaly verbs as the queue path, "
             "at urgent priority, one verb per healing episode.")
    d.define("detector.stream.seed", Type.INT, 1729, Importance.LOW,
             "Seed for the stream detector's classification tie-breaks and "
             "forecast jitter; a fixed seed makes episode timelines "
             "bit-reproducible across identical runs.", at_least(0))
    d.define("detector.stream.clean.windows", Type.INT, 3, Importance.MEDIUM,
             "Consecutive violation-free windows required to declare an "
             "episode recovered. time-to-heal is stamped at the FIRST "
             "window of the clean streak, so raising this delays the "
             "verdict without inflating the healing metric.", at_least(1))
    d.define("detector.stream.pressure.threshold", Type.DOUBLE, 0.85,
             Importance.MEDIUM,
             "warm_pressure band above which a window is classified as "
             "pressure_surge (anomalous) even if it still verified.",
             between(0, 1))
    d.define("detector.stream.forecast.windows", Type.INT, 8, Importance.LOW,
             "History length (windows) for the drift-history forecaster's "
             "least-squares pressure slope.", at_least(2))
    d.define("detector.stream.forecast.horizon.windows", Type.INT, 6,
             Importance.LOW,
             "Look-ahead horizon: if the fitted pressure slope crosses the "
             "surge threshold within this many windows, the detector "
             "pre-warms placement bases via the PlacementStore ledger "
             "(priority touch) BEFORE the surge lands.", at_least(1))
    return d


def webserver_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("webserver.http.address", Type.STRING, "127.0.0.1", Importance.HIGH,
             "REST server bind address.")
    d.define("webserver.http.port", Type.INT, 9090, Importance.HIGH,
             "REST server port.", between(0, 65535))
    d.define("webserver.openapi.port", Type.INT, 0, Importance.LOW,
             "Port for the second, OpenAPI-contract-routed asyncio API "
             "surface (ref C36, the optional Vert.x module). 0 disables it "
             "(the upstream module is optional too); both surfaces share "
             "one dispatch/auth/review path so behavior cannot drift.",
             between(0, 65535))
    d.define("webserver.openapi.address", Type.STRING, "127.0.0.1",
             Importance.LOW, "Bind address for the OpenAPI surface.")
    d.define("webserver.api.urlprefix", Type.STRING, "/kafkacruisecontrol/*",
             Importance.LOW, "Endpoint URL prefix.")
    d.define("webserver.session.maxExpiryPeriodMs", Type.LONG, 60_000,
             Importance.LOW, "Session expiry for async request tracking.",
             at_least(1))
    d.define("webserver.request.maxBlockTimeMs", Type.LONG, 10_000,
             Importance.LOW, "Max time a request blocks before going async.",
             at_least(0))
    d.define("two.step.verification.enabled", Type.BOOLEAN, False, Importance.MEDIUM,
             "Park POSTs in purgatory until reviewed (ref C33).")
    d.define("two.step.purgatory.retention.time.ms", Type.LONG, 1_209_600_000,
             Importance.LOW, "Purgatory request retention.", at_least(1))
    d.define("two.step.purgatory.max.requests", Type.INT, 25, Importance.LOW,
             "Purgatory capacity.", at_least(1))
    d.define("webserver.security.enable", Type.BOOLEAN, False, Importance.MEDIUM,
             "Enable authentication/authorization (ref C34).")
    d.define("webserver.security.provider", Type.CLASS,
             "ccx_torch.servlet.security.BasicSecurityProvider", Importance.MEDIUM,
             "SecurityProvider SPI.")
    d.define("webserver.auth.credentials.file", Type.STRING, "", Importance.MEDIUM,
             "Credentials file for the basic provider "
             "(user: password,ROLE per line); for the JWT provider it holds "
             "the HMAC signing secret.")
    d.define("webserver.trusted.proxy.ips", Type.LIST, ("127.0.0.1",),
             Importance.LOW, "Peer addresses allowed to assert principals "
             "via the trusted-proxy provider.")
    d.define("webserver.trusted.proxy.admin.principals", Type.LIST, (),
             Importance.LOW, "Principals granted ADMIN by the trusted-proxy "
             "provider (others get USER).")
    d.define("webserver.spnego.admin.principals", Type.LIST, (),
             Importance.LOW, "Kerberos principals granted ADMIN by the "
             "SPNEGO provider (others get USER).")
    d.define("webserver.spnego.service.name", Type.STRING, "HTTP",
             Importance.LOW, "GSSAPI hostbased service name the SPNEGO "
             "provider accepts tickets for.")
    d.define("vertx.api.enabled", Type.BOOLEAN, False, Importance.LOW,
             "Alternative API server flavor flag (ref C36; same endpoints).")
    return d


def user_task_manager_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("max.active.user.tasks", Type.INT, 25, Importance.MEDIUM,
             "Concurrent async user tasks.", at_least(1))
    d.define("max.cached.completed.user.tasks", Type.INT, 100, Importance.LOW,
             "Completed tasks kept for replay via user_tasks.", at_least(1))
    d.define("completed.user.task.retention.time.ms", Type.LONG, 86_400_000,
             Importance.LOW, "Completed task retention.", at_least(1))
    return d


def reporter_config_def() -> ConfigDef:
    """Broker-side metrics reporter keys (ref C37/M3)."""
    d = ConfigDef()
    d.define("metric.reporting.interval.ms", Type.LONG, 60_000, Importance.HIGH,
             "Reporter publish period inside each broker.", at_least(1))
    d.define("cruise.control.metrics.topic", Type.STRING,
             "__CruiseControlMetrics", Importance.MEDIUM,
             "Transport channel name for raw metric records.")
    return d


def cruise_control_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define("bootstrap.servers", Type.STRING, "localhost:9092", Importance.HIGH,
             "Managed cluster contact point (simulated transport address for "
             "the in-process cluster).")
    d.define("cluster.configs.file", Type.STRING, "config/clusterConfigs.json",
             Importance.LOW, "Cluster-level config overrides file.")
    for sub in (
        monitor_config_def(),
        analyzer_config_def(),
        observability_config_def(),
        executor_config_def(),
        anomaly_detector_config_def(),
        webserver_config_def(),
        user_task_manager_config_def(),
        reporter_config_def(),
    ):
        d.merge(sub)
    return d


class CruiseControlConfig:
    """Parsed, validated configuration (ref KafkaCruiseControlConfig).

    ``cfg[key]`` returns the typed value; ``configured_instance(key)``
    instantiates a class-valued key, passing this config to the constructor
    (or calling a no-arg constructor, then ``configure(cfg)`` if defined) —
    the reference's reflective SPI pattern.
    """

    def __init__(self, props: dict[str, Any] | None = None,
                 definition: ConfigDef | None = None) -> None:
        self.definition = definition or cruise_control_config_def()
        self.originals = dict(props or {})
        self._values = self.definition.parse(self.originals)

    #: file-valued keys resolved relative to the properties file's directory
    PATH_KEYS = (
        "capacity.config.file",
        "cluster.configs.file",
        "webserver.auth.credentials.file",
        "failed.brokers.file.path",
    )

    @classmethod
    def from_properties_file(cls, path: str) -> "CruiseControlConfig":
        import os

        props = load_properties(path)
        base = os.path.dirname(os.path.abspath(path))
        for key in cls.PATH_KEYS:
            v = props.get(key)
            if v and not os.path.isabs(v):
                # Relative paths in a properties file mean "relative to the
                # file", not to whatever cwd the service was launched from.
                candidate = os.path.normpath(os.path.join(base, v))
                parent = os.path.normpath(os.path.join(base, "..", v))
                props[key] = candidate if os.path.exists(candidate) else (
                    parent if os.path.exists(parent) else candidate
                )
        return cls(props)

    def __getitem__(self, key: str) -> Any:
        try:
            return self._values[key]
        except KeyError:
            raise ConfigException(f"Unknown configuration {key!r}") from None

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def with_overrides(self, **overrides: Any) -> "CruiseControlConfig":
        """Per-request parameter overrides (ref C32 parameters/)."""
        props = dict(self.originals)
        props.update({k.replace("_", "."): v for k, v in overrides.items()})
        return CruiseControlConfig(props, self.definition)

    def configured_instance(self, key: str, *args: Any, **kwargs: Any) -> Any:
        from ccx_torch.config.definition import resolve_class

        cls = self[key]
        if cls is None:
            return None
        if isinstance(cls, str):
            cls = resolve_class(cls)
        try:
            obj = cls(*args, config=self, **kwargs)
        except TypeError:
            obj = cls(*args, **kwargs)
        if hasattr(obj, "configure"):
            obj.configure(self)
        return obj

    def configured_instances(self, key: str, *args: Any) -> list[Any]:
        out = []
        for path in self[key]:
            from ccx_torch.config.definition import resolve_class

            cls = resolve_class(path) if isinstance(path, str) else path
            try:
                obj = cls(*args, config=self)
            except TypeError:
                obj = cls(*args)
            if hasattr(obj, "configure"):
                obj.configure(self)
            out.append(obj)
        return out

    def values(self) -> dict[str, Any]:
        return dict(self._values)
