"""LoadMonitor — builds tensor ClusterModels from metadata + samples.

Parity: ``monitor/LoadMonitor.java`` + ``monitor/task/LoadMonitorTaskRunner``
+ ``monitor/sampling/MetricFetcherManager`` (SURVEY.md C7/C9): a scheduled
sampling loop shards partitions across fetcher threads, feeds windowed
aggregators and the sample store; ``cluster_model(requirements)`` snapshots
metadata + aggregates into the model the analyzer optimizes, stamped with a
``ModelGeneration``; sampling can be paused/resumed; on startup the sample
store is replayed for a warm model (§5.4 checkpoint/resume).

The port's counterpart of the JAX package's ``monitor/load_monitor.py``:
the "model" produced is the frozen ``TensorClusterModel`` of torch tensors
on the monitor's device (the CUDA device unless the caller passes
``device="cpu"``), not a mutable object tree — aggregation windows are
averaged into per-partition leader/follower load vectors on the host
(numpy, the same arrays as the JAX package's) and moved to the device once
per generation.
"""

from __future__ import annotations

import dataclasses
import enum
import re
import threading
import time as _time

import numpy as np

from ccx_torch.common.exceptions import NotEnoughValidWindowsException
from ccx_torch.common.metadata import ClusterMetadata
from ccx_torch.common.resources import NUM_RESOURCES
from ccx_torch.model.tensor_model import TensorClusterModel, build_model
from ccx_torch.monitor.aggregator import (
    AggregationResult,
    MetricSampleAggregator,
    ModelCompletenessRequirements,
)
from ccx_torch.monitor.capacity import capacity_matrix, disk_capacity_matrix
from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF, PARTITION_METRIC_DEF
from ccx_torch.monitor.model_utils import (
    CpuEstimationParams,
    LinearRegressionModelParameters,
    split_roles,
)
from ccx_torch.monitor.sampling.holders import samples_to_arrays
from ccx_torch.monitor.sampling.sampler import Samples


class LoadMonitorState(enum.Enum):
    """Ref C9 LoadMonitorTaskRunner state machine (incl. the legacy
    BOOTSTRAPPING/TRAINING modes driven by the bootstrap/train endpoints)."""

    NOT_STARTED = "NOT_STARTED"
    LOADING = "LOADING"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"


@dataclasses.dataclass(frozen=True)
class ModelGeneration:
    """Ref monitor/ModelGeneration: (metadata generation, sample generation)
    — pins a snapshot so analyzer results are traceable to inputs."""

    metadata_generation: int
    sample_generation: int

    def __str__(self) -> str:
        return f"[{self.metadata_generation},{self.sample_generation}]"


@dataclasses.dataclass
class ModelBuildOptions:
    """Per-request model shaping (ref OptimizationOptions inputs, C20)."""

    excluded_topics_pattern: str = ""
    brokers_to_add: tuple[int, ...] = ()
    brokers_to_remove: tuple[int, ...] = ()
    brokers_to_demote: tuple[int, ...] = ()
    populate_disks: bool = False


class MetricFetcherManager:
    """Shards the partition space across fetcher threads (ref C9)."""

    def __init__(self, sampler, num_fetchers: int = 1) -> None:
        self.sampler = sampler
        self.num_fetchers = max(int(num_fetchers), 1)

    def fetch(self, metadata: ClusterMetadata, start_ms: int, end_ms: int) -> Samples:
        n = len(metadata.partitions)
        shards = [list(range(i, n, self.num_fetchers))
                  for i in range(self.num_fetchers)]
        results: list[Samples | None] = [None] * len(shards)
        errors: list[BaseException] = []

        def run(i: int) -> None:
            try:
                results[i] = self.sampler.get_samples(
                    metadata, shards[i], start_ms, end_ms
                )
            except BaseException as e:  # propagate to the caller's thread
                errors.append(e)

        if self.num_fetchers == 1:
            run(0)
        else:
            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(len(shards))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            # A failed fetch round must fail loudly so sample_once does not
            # advance the sampled horizon past an un-fetched interval.
            raise errors[0]
        merged = Samples([], [])
        seen_broker: set[tuple[int, int]] = set()
        for r in results:
            if r is not None:
                merged.partition_samples.extend(r.partition_samples)
                # Broker samples are not sharded by the fetcher split — a
                # sampler may emit them on every shard; dedupe by
                # (broker, timestamp) so counts are not inflated N-fetchers x.
                for s in r.broker_samples:
                    key = (s.broker_id, s.time_ms)
                    if key not in seen_broker:
                        seen_broker.add(key)
                        merged.broker_samples.append(s)
        return merged


class LoadMonitor:
    """The L2 entry point (ref C7). ``admin`` supplies metadata snapshots
    (``ccx_torch.executor.admin.AdminApi``); ``clock`` returns epoch ms
    (injectable for tests, like the reference's Time mock); ``device`` is
    where models are built (None: the CUDA device, or raise)."""

    def __init__(self, config, admin, clock=None, device=None) -> None:
        self.config = config
        self.device = device
        self.admin = admin
        self.clock = clock or (lambda: int(_time.time() * 1000))
        self.partition_aggregator = MetricSampleAggregator(
            PARTITION_METRIC_DEF,
            num_windows=config["num.partition.metrics.windows"],
            window_ms=config["partition.metrics.window.ms"],
            min_samples_per_window=config["min.samples.per.partition.metrics.window"],
            max_allowed_extrapolations=config["max.allowed.extrapolations.per.partition"],
        )
        self.broker_aggregator = MetricSampleAggregator(
            BROKER_METRIC_DEF,
            num_windows=config["num.broker.metrics.windows"],
            window_ms=config["broker.metrics.window.ms"],
            min_samples_per_window=config["min.samples.per.broker.metrics.window"],
            max_allowed_extrapolations=config["max.allowed.extrapolations.per.broker"],
        )
        self.sampler = config.configured_instance("metric.sampler.class")
        self.sample_store = config.configured_instance("sample.store.class")
        self.capacity_resolver = config.configured_instance(
            "broker.capacity.config.resolver.class"
        )
        self.cpu_params = CpuEstimationParams.from_config(config)
        self.fetcher_manager = MetricFetcherManager(
            self.sampler, config["num.metric.fetchers"]
        )
        self._state = LoadMonitorState.NOT_STARTED
        self._pause_reason: str | None = None
        self._lock = threading.RLock()
        self._model_semaphore = threading.Semaphore(1)
        self._last_sample_ms: int | None = None
        self._runner: threading.Thread | None = None
        self._stop = threading.Event()
        self._num_samples = 0
        #: legacy linear-regression CPU-model training (ref C6; train verb)
        self.lr_params = LinearRegressionModelParameters()
        self._trained = False

    # ----- lifecycle (ref LoadMonitor.startUp / shutdown) -------------------

    def start_up(self, run_sampling_loop: bool = True) -> None:
        with self._lock:
            self._state = LoadMonitorState.LOADING
        if not self._warm_start_native():
            warm = self.sample_store.load_samples()
            self._ingest(warm)
        with self._lock:
            self._state = LoadMonitorState.RUNNING
        if run_sampling_loop:
            self._stop.clear()
            self._runner = threading.Thread(
                target=self._sampling_loop, name="LoadMonitorTaskRunner",
                daemon=True,
            )
            self._runner.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._runner is not None:
            self._runner.join(timeout=5)
        self.sampler.close()
        self.sample_store.close()

    def _warm_start_native(self) -> bool:
        """Columnar warm start: decode the partition log natively straight
        into the aggregator (the object path costs ~3us/record; at millions
        of persisted samples boot time matters). Broker samples still replay
        through the object path (small volume). Returns False to fall back."""
        from ccx_torch import native

        raw = getattr(self.sample_store, "raw_partition_log", None)
        if raw is None or not native.available():
            return False
        buf = raw()
        M = self.partition_aggregator.metric_def.num_metrics
        # capacity: a record is >= 34 bytes on the wire
        decoded = native.decode_partition_samples(buf, len(buf) // 34 + 1, M)
        if decoded is None:
            return False
        ids, times, metrics = decoded
        if len(ids):
            self.partition_aggregator.add_samples(ids, times, metrics)
        self._ingest(Samples([], self.sample_store.load_broker_samples()))
        self._num_samples += len(ids)
        return True

    # ----- sampling ---------------------------------------------------------

    def _sampling_loop(self) -> None:
        interval = self.config["metric.sampling.interval.ms"]
        while not self._stop.wait(interval / 1000.0):
            # skip while paused AND while a bootstrap/train replay owns the
            # aggregators — concurrent ingestion would double-count windows
            if self._state is not LoadMonitorState.RUNNING:
                continue
            try:
                self.sample_once()
            except Exception:  # sampling must never kill the loop (ref C9)
                import logging

                logging.getLogger(__name__).exception("sampling round failed")

    def sample_once(self, end_ms: int | None = None) -> int:
        """One fetch round over [last_sample, end); returns samples ingested."""
        with self._lock:
            if self._state not in (
                LoadMonitorState.RUNNING, LoadMonitorState.LOADING
            ):
                return 0
            prev_state = self._state
            self._state = LoadMonitorState.SAMPLING
        try:
            end_ms = end_ms if end_ms is not None else self.clock()
            start_ms = (
                self._last_sample_ms
                if self._last_sample_ms is not None
                else end_ms - self.config["metric.sampling.interval.ms"]
            )
            metadata = self.admin.describe_cluster()
            samples = self.fetcher_manager.fetch(metadata, start_ms, end_ms)
            self._ingest(samples, metadata, now_ms=end_ms)
            self.sample_store.store_samples(samples)
            # Retention: drop persisted samples older than each scope's
            # monitored span so warm start replays only what the aggregators
            # can hold.
            p_horizon = (
                self.config["num.partition.metrics.windows"] + 1
            ) * self.config["partition.metrics.window.ms"]
            b_horizon = (
                self.config["num.broker.metrics.windows"] + 1
            ) * self.config["broker.metrics.window.ms"]
            self.sample_store.evict_before(
                end_ms - p_horizon, end_ms - b_horizon
            )
            self._last_sample_ms = end_ms
            return len(samples.partition_samples) + len(samples.broker_samples)
        finally:
            with self._lock:
                if self._state is LoadMonitorState.SAMPLING:
                    self._state = prev_state

    def _ingest(self, samples: Samples, metadata: ClusterMetadata | None = None,
                now_ms: int | None = None) -> None:
        if samples.partition_samples:
            ids, times, metrics = samples_to_arrays(samples.partition_samples)
            self.partition_aggregator.add_samples(ids, times, metrics, now_ms=now_ms)
        if samples.broker_samples:
            # Broker ids are operator-chosen and possibly sparse/large; map to
            # the dense broker axis via the metadata snapshot (same contract
            # as the partition axis).
            if metadata is None:
                metadata = self.admin.describe_cluster()
            bidx = metadata.broker_index()
            kept = [s for s in samples.broker_samples if s.broker_id in bidx]
            if kept:
                ids = np.array([bidx[s.broker_id] for s in kept], np.int64)
                times = np.array([s.time_ms for s in kept], np.int64)
                metrics = np.array([s.metrics for s in kept])
                self.broker_aggregator.add_samples(ids, times, metrics, now_ms=now_ms)
        self._num_samples += len(samples.partition_samples) + len(samples.broker_samples)

    def bootstrap(self, start_ms: int, end_ms: int,
                  clear_metrics: bool = True) -> dict:
        """Ref BOOTSTRAP endpoint / BOOTSTRAPPING state (SURVEY.md C9):
        fetch a historical range window-by-window to (re)fill the
        aggregators without waiting real time."""
        window_ms = int(self.config["partition.metrics.window.ms"])
        with self._lock:
            if self._state is not LoadMonitorState.RUNNING:
                raise RuntimeError(
                    f"cannot bootstrap while monitor is {self._state.value}"
                )
            self._state = LoadMonitorState.BOOTSTRAPPING
        try:
            if clear_metrics:
                self.partition_aggregator.clear()
                self.broker_aggregator.clear()
                self._num_samples = 0
            metadata = self.admin.describe_cluster()
            n = 0
            t = int(start_ms)
            while t < end_ms:
                hi = min(t + window_ms, int(end_ms))
                samples = self.fetcher_manager.fetch(metadata, t, hi)
                self._ingest(samples, metadata, now_ms=hi)
                self.sample_store.store_samples(samples)
                n += len(samples.partition_samples) + len(samples.broker_samples)
                t = hi
            with self._lock:
                self._last_sample_ms = max(self._last_sample_ms or 0, int(end_ms))
            r = self.partition_aggregator.aggregate()
            return {
                "numSamples": n,
                "numValidWindows": int(r.num_windows),
                "validPartitionsRatio": r.valid_entity_ratio,
            }
        finally:
            with self._lock:
                # guarded restore (same pattern as sample_once): a concurrent
                # pause must not be clobbered back to RUNNING
                if self._state is LoadMonitorState.BOOTSTRAPPING:
                    self._state = LoadMonitorState.RUNNING

    def train(self, start_ms: int, end_ms: int) -> dict:
        """Ref TRAIN endpoint / TRAINING state (SURVEY.md C6/C9): fit the
        linear-regression CPU model from broker samples over a historical
        range; once enough observations accumulate, the fitted coefficients
        replace the static ``*.weight.for.cpu.util`` config estimates."""
        with self._lock:
            if self._state is not LoadMonitorState.RUNNING:
                raise RuntimeError(
                    f"cannot train while monitor is {self._state.value}"
                )
            self._state = LoadMonitorState.TRAINING
        try:
            metadata = self.admin.describe_cluster()
            samples = self.fetcher_manager.fetch(
                metadata, int(start_ms), int(end_ms)
            )
            cpu_id = BROKER_METRIC_DEF.metric_info("BROKER_CPU_UTIL").id
            in_id = BROKER_METRIC_DEF.metric_info("ALL_TOPIC_BYTES_IN").id
            out_id = BROKER_METRIC_DEF.metric_info("ALL_TOPIC_BYTES_OUT").id
            if samples.broker_samples:
                rows = np.array([s.metrics for s in samples.broker_samples])
                self.lr_params.add_broker_samples(
                    rows[:, None, :], cpu_id, in_id, out_id
                )
            out = {
                "numTrainingSamples": self.lr_params.num_observations,
                "trained": False,
            }
            if self.lr_params.trainable:
                self.cpu_params = self.lr_params.to_params()
                self._trained = True
                out["trained"] = True
                out["coefficients"] = {
                    "leaderNetworkInboundWeightForCpuUtil":
                        self.cpu_params.leader_nw_in_weight,
                    "leaderNetworkOutboundWeightForCpuUtil":
                        self.cpu_params.leader_nw_out_weight,
                    "followerNetworkInboundWeightForCpuUtil":
                        self.cpu_params.follower_nw_in_weight,
                }
            return out
        finally:
            with self._lock:
                if self._state is LoadMonitorState.TRAINING:
                    self._state = LoadMonitorState.RUNNING

    def pause_sampling(self, reason: str = "user request") -> None:
        with self._lock:
            self._state = LoadMonitorState.PAUSED
            self._pause_reason = reason

    def resume_sampling(self) -> None:
        with self._lock:
            self._state = LoadMonitorState.RUNNING
            self._pause_reason = None

    # ----- model generation -------------------------------------------------

    def model_generation(self, metadata: ClusterMetadata | None = None) -> ModelGeneration:
        md = metadata or self.admin.describe_cluster()
        return ModelGeneration(md.generation, self.partition_aggregator.generation)

    def acquire_for_model_generation(self):
        """Ref LoadMonitor's model-generation semaphore: serialize expensive
        model builds; context-manager style."""
        class _Guard:
            def __init__(self, sem):
                self._sem = sem

            def __enter__(self):
                self._sem.acquire()
                return self

            def __exit__(self, *exc):
                self._sem.release()
                return False

        return _Guard(self._model_semaphore)

    def partition_completeness(self):
        metadata = self.admin.describe_cluster()
        r = self.partition_aggregator.aggregate(len(metadata.partitions))
        return r, metadata

    def cluster_model(
        self,
        requirements: ModelCompletenessRequirements | None = None,
        options: ModelBuildOptions | None = None,
    ) -> tuple[TensorClusterModel, ClusterMetadata, ModelGeneration]:
        """Ref LoadMonitor.clusterModel(now, requirements, progress) — the
        L2 half of call stack 3.2. Raises NotEnoughValidWindowsException when
        completeness is below ``requirements``."""
        req = requirements or ModelCompletenessRequirements()
        options = options or ModelBuildOptions()
        agg, metadata = self.partition_completeness()
        if not agg.meets(req):
            raise NotEnoughValidWindowsException(
                f"monitor completeness {agg.valid_entity_ratio:.2%} over "
                f"{agg.num_windows} windows does not meet {req}"
            )
        model = build_tensor_model(
            metadata, agg, self.capacity_resolver, self.cpu_params, options,
            device=self.device,
        )
        return model, metadata, self.model_generation(metadata)

    # ----- state ------------------------------------------------------------

    def state(self) -> dict:
        r = self.partition_aggregator.aggregate()
        return {
            "state": self._state.value,
            "reasonOfLatestPauseOrResume": self._pause_reason,
            "numValidWindows": int(r.num_windows),
            "validPartitionsRatio": r.valid_entity_ratio,
            "numTotalSamples": self._num_samples,
            "modelGeneration": str(self.model_generation()),
            "trained": self._trained,
            "numTrainingSamples": self.lr_params.num_observations,
        }


def build_tensor_model(
    metadata: ClusterMetadata,
    agg: AggregationResult,
    capacity_resolver,
    cpu_params: CpuEstimationParams,
    options: ModelBuildOptions | None = None,
    device=None,
) -> TensorClusterModel:
    """Metadata + windowed loads -> TensorClusterModel on ``device`` (the
    populate-model half of call stack 3.2: createReplica/setReplicaLoad per
    replica in the reference becomes a handful of vectorized gathers here)."""
    options = options or ModelBuildOptions()
    P = len(metadata.partitions)
    R = max((len(p.replicas) for p in metadata.partitions), default=1)
    bidx = metadata.broker_index()
    tidx = metadata.topic_index()
    # effective rack keys: rack || host || broker id — a rack-less broker
    # falls back to HOST distinctness (upstream ClusterModel.createBroker
    # semantics, ref model/{Rack,Host}.java), not to one shared "" rack
    racks = {r: i for i, r in enumerate(metadata.rack_keys())}
    hosts = {h: i for i, h in enumerate(metadata.hosts())}

    assignment = np.full((P, R), -1, np.int32)
    replica_disk = np.full((P, R), -1, np.int32)
    leader_slot = np.zeros(P, np.int32)
    partition_topic = np.zeros(P, np.int32)
    for i, p in enumerate(metadata.partitions):
        for s, b in enumerate(p.replicas):
            assignment[i, s] = bidx[b]
            if p.replica_dirs:
                replica_disk[i, s] = p.replica_dirs[s]
            else:
                replica_disk[i, s] = 0
        if p.leader >= 0 and p.leader in bidx:
            try:
                leader_slot[i] = p.replicas.index(p.leader)
            except ValueError:
                leader_slot[i] = 0
        partition_topic[i] = tidx[p.tp.topic]

    # windowed loads -> per-partition vector (average over valid windows;
    # entities with no valid data contribute zeros, matching the reference's
    # completeness gate having already passed)
    valid_w = agg.extrapolations < 3  # not NO_VALID
    with np.errstate(invalid="ignore", divide="ignore"):
        wsum = (agg.values * valid_w[..., None]).sum(axis=1)
        wcnt = np.maximum(valid_w.sum(axis=1), 1)[..., None]
        loads = wsum / wcnt  # [P, M]
    leader_load, follower_load = split_roles(cpu_params, loads)

    broker_ids = metadata.broker_ids()
    broker_capacity = capacity_matrix(capacity_resolver, broker_ids)
    broker_rack = np.array(
        [racks[b.rack_key()] for b in metadata.brokers], np.int32
    )
    broker_host = np.array(
        [hosts[b.host_key()] for b in metadata.brokers], np.int32
    )
    broker_alive = np.array(
        [b.alive and b.broker_id not in options.brokers_to_remove
         for b in metadata.brokers], bool
    )
    broker_new = np.array(
        [b.broker_id in options.brokers_to_add for b in metadata.brokers], bool
    )
    demoted = np.array(
        [b.broker_id in options.brokers_to_demote for b in metadata.brokers], bool
    )

    excluded = np.zeros(P, bool)
    if options.excluded_topics_pattern:
        rx = re.compile(options.excluded_topics_pattern)
        topic_names = metadata.topics()
        excluded_topics = {tidx[t] for t in topic_names if rx.fullmatch(t)}
        excluded = np.array(
            [partition_topic[i] in excluded_topics for i in range(P)], bool
        )

    disk_capacity = disk_capacity_matrix(capacity_resolver, broker_ids)
    disk_alive = np.ones_like(disk_capacity, bool)
    for i, b in enumerate(metadata.brokers):
        for d in b.offline_disks:
            if d < disk_alive.shape[1]:
                disk_alive[i, d] = False

    return build_model(
        assignment=assignment,
        leader_load=leader_load,
        follower_load=follower_load,
        broker_capacity=broker_capacity,
        broker_rack=broker_rack,
        broker_host=broker_host,
        partition_topic=partition_topic,
        leader_slot=leader_slot,
        replica_disk=replica_disk,
        broker_alive=broker_alive,
        broker_new=broker_new,
        broker_excl_leadership=demoted,
        partition_immovable=excluded,
        disk_capacity=disk_capacity,
        disk_alive=disk_alive,
        num_racks=len(racks),
        device=device,
    )
