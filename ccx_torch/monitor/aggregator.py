"""Windowed metric-sample aggregation with extrapolation + completeness.

Parity: ``cruise-control-core``'s ``MetricSampleAggregator`` family
(SURVEY.md M1/C8): raw samples land in fixed-span time windows per entity
(partition or broker); aggregation rolls each window up with the metric's
``AggregationFunction``; windows with too few samples are *extrapolated*
(``FORCED_INSUFFICIENT`` = use what's there, ``AVG_ADJACENT`` = average the
neighbor windows) up to a per-entity budget; a ``MetricSampleCompleteness``
summary gates model generation via ``ModelCompletenessRequirements``.

Design departure from the JVM: instead of per-entity hash maps of per-window
sample lists, the store is **columnar numpy** — ``sum/count/max/latest``
arrays of shape [E, W, M] with a rolling window base — so ingest is
``np.add.at`` scatter, aggregation is one vectorized pass, and the output
feeds the tensor ClusterModel build (and the TPU) without per-object walks.
This is the host-side half of the "hot loop #2" (O(P·W)) in SURVEY.md call
stack 3.2.
"""

from __future__ import annotations

import dataclasses
import enum
import threading

import numpy as np

from ccx_torch.monitor.metricdef import AggregationFunction, MetricDef


class Extrapolation(enum.IntEnum):
    """Per entity-window provenance (ref core's Extrapolation enum)."""

    NONE = 0                 # enough samples
    FORCED_INSUFFICIENT = 1  # some samples, below the minimum
    AVG_ADJACENT = 2         # zero samples, neighbors averaged
    NO_VALID = 3             # zero samples, no usable neighbors


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    """Parity: monitor ``ModelCompletenessRequirements`` (SURVEY.md C8)."""

    min_required_num_windows: int = 1
    min_valid_entity_ratio: float = 0.95   # min.monitored.partition.percentage
    include_all_entities: bool = False

    def merged(self, other: "ModelCompletenessRequirements") -> "ModelCompletenessRequirements":
        """The stricter union of two requirements (ref: requirements of all
        goals in a request are combined)."""
        return ModelCompletenessRequirements(
            max(self.min_required_num_windows, other.min_required_num_windows),
            max(self.min_valid_entity_ratio, other.min_valid_entity_ratio),
            self.include_all_entities or other.include_all_entities,
        )


@dataclasses.dataclass
class AggregationResult:
    """Parity: ``MetricSampleAggregationResult`` + ``ValuesAndExtrapolations``.

    ``values``: float64[E, W, M] — newest window last; ``extrapolations``:
    int8[E, W]; ``entity_valid``: bool[E] (within the extrapolation budget and
    no NO_VALID window); ``window_starts_ms``: int64[W].
    """

    values: np.ndarray
    extrapolations: np.ndarray
    entity_valid: np.ndarray
    window_starts_ms: np.ndarray
    valid_entity_ratio: float
    generation: int

    @property
    def num_windows(self) -> int:
        return self.values.shape[1]

    def meets(self, req: ModelCompletenessRequirements) -> bool:
        if self.num_windows < req.min_required_num_windows:
            return False
        if self.valid_entity_ratio < req.min_valid_entity_ratio:
            return False
        if req.include_all_entities and not bool(self.entity_valid.all()):
            return False
        return True


class MetricSampleAggregator:
    """Rolling columnar window store for one entity class.

    Subclassed/instantiated per scope like the reference's
    ``KafkaPartitionMetricSampleAggregator`` / ``KafkaBrokerMetricSampleAggregator``
    (SURVEY.md C8): ``num_entities`` is resizable upward (new partitions /
    brokers appear); entity ids are dense indices supplied by the caller's
    metadata snapshot.
    """

    def __init__(
        self,
        metric_def: MetricDef,
        num_windows: int,
        window_ms: int,
        min_samples_per_window: int = 1,
        max_allowed_extrapolations: int = 5,
        num_entities: int = 0,
    ) -> None:
        self.metric_def = metric_def
        self.num_windows = int(num_windows)
        self.window_ms = int(window_ms)
        self.min_samples_per_window = int(min_samples_per_window)
        self.max_allowed_extrapolations = int(max_allowed_extrapolations)
        # W+1 slots: the newest ("current") window is still filling and is
        # excluded from aggregation, as in the reference.
        self._slots = self.num_windows + 1
        self._base_window = None  # absolute index of slot 0
        self._first_window = None  # absolute index of the earliest real sample
        self._generation = 0      # bumps on every window roll (ModelGeneration)
        self._lock = threading.RLock()
        E, W, M = num_entities, self._slots, metric_def.num_metrics
        self._sum = np.zeros((E, W, M))
        self._max = np.full((E, W, M), -np.inf)
        self._latest = np.zeros((E, W, M))
        self._latest_t = np.full((E, W), -1, np.int64)
        self._count = np.zeros((E, W), np.int64)
        # per-metric aggregation selector
        agg = [m.aggregation for m in metric_def.all_metrics()]
        self._is_avg = np.array([a is AggregationFunction.AVG for a in agg])
        self._is_max = np.array([a is AggregationFunction.MAX for a in agg])
        self._is_latest = np.array([a is AggregationFunction.LATEST for a in agg])

    # ----- sizing ----------------------------------------------------------

    @property
    def num_entities(self) -> int:
        return self._sum.shape[0]

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def clear(self) -> None:
        """Drop all windows and samples (ref bootstrap `clearmetrics`);
        entity capacity is kept, the generation bumps."""
        with self._lock:
            self._sum[:] = 0.0
            self._max[:] = -np.inf
            self._latest[:] = 0.0
            self._latest_t[:] = -1
            self._count[:] = 0
            self._base_window = None
            self._first_window = None
            self._generation += 1

    def ensure_entities(self, n: int) -> None:
        with self._lock:
            E = self.num_entities
            if n <= E:
                return
            grow = n - E
            W, M = self._slots, self.metric_def.num_metrics
            self._sum = np.concatenate([self._sum, np.zeros((grow, W, M))])
            self._max = np.concatenate([self._max, np.full((grow, W, M), -np.inf)])
            self._latest = np.concatenate([self._latest, np.zeros((grow, W, M))])
            self._latest_t = np.concatenate(
                [self._latest_t, np.full((grow, W), -1, np.int64)]
            )
            self._count = np.concatenate([self._count, np.zeros((grow, W), np.int64)])
            self._generation += 1

    # ----- ingest ----------------------------------------------------------

    def _roll_to(self, newest_window: int) -> None:
        """Advance the rolling buffer so ``newest_window`` fits in-slot."""
        if self._base_window is None:
            self._base_window = newest_window - self._slots + 1
        shift = newest_window - (self._base_window + self._slots - 1)
        if shift <= 0:
            return
        self._generation += 1
        if shift >= self._slots:
            self._sum[:] = 0.0
            self._max[:] = -np.inf
            self._latest[:] = 0.0
            self._latest_t[:] = -1
            self._count[:] = 0
        else:
            self._sum = np.roll(self._sum, -shift, axis=1)
            self._max = np.roll(self._max, -shift, axis=1)
            self._latest = np.roll(self._latest, -shift, axis=1)
            self._latest_t = np.roll(self._latest_t, -shift, axis=1)
            self._count = np.roll(self._count, -shift, axis=1)
            self._sum[:, -shift:] = 0.0
            self._max[:, -shift:] = -np.inf
            self._latest[:, -shift:] = 0.0
            self._latest_t[:, -shift:] = -1
            self._count[:, -shift:] = 0
        self._base_window += shift

    def add_samples(self, entity_ids: np.ndarray, times_ms: np.ndarray,
                    metrics: np.ndarray, now_ms: int | None = None) -> int:
        """Batch ingest; returns the number of accepted samples.

        Samples outside the monitored period are dropped (ref: the
        aggregator rejects out-of-period samples): older than the retained
        window range, or — when ``now_ms`` is given — timestamped beyond
        one window into the future (clock skew / buggy sampler), which would
        otherwise wipe history by force-rolling the buffer forward.
        """
        with self._lock:
            entity_ids = np.asarray(entity_ids, np.int64)
            times_ms = np.asarray(times_ms, np.int64)
            metrics = np.asarray(metrics, np.float64)
            if now_ms is not None:
                fresh = times_ms <= now_ms + self.window_ms
                entity_ids, times_ms, metrics = (
                    entity_ids[fresh], times_ms[fresh], metrics[fresh]
                )
            if entity_ids.size == 0:
                return 0
            self.ensure_entities(int(entity_ids.max()) + 1)
            windows = times_ms // self.window_ms
            if self._first_window is None:
                self._first_window = int(windows.min())
            else:
                self._first_window = min(self._first_window, int(windows.min()))
            self._roll_to(int(windows.max()))
            slot = windows - self._base_window
            ok = slot >= 0
            if not ok.any():
                return 0
            e, s, t, m = entity_ids[ok], slot[ok], times_ms[ok], metrics[ok]
            # Rows sorted ascending by time: required for last-write-wins
            # LATEST semantics in both the native and numpy paths.
            order = np.argsort(t, kind="stable")
            e, s, t, m = e[order], s[order], t[order], m[order]
            from ccx_torch import native

            if not native.scatter(
                self._sum, self._max, self._latest, self._latest_t,
                self._count, e, s, t, m,
            ):
                np.add.at(self._sum, (e, s), m)
                np.maximum.at(self._max, (e, s), m)
                np.add.at(self._count, (e, s), 1)
                newer = t >= self._latest_t[e, s]
                # later duplicates in the same batch overwrite — sorted order
                # makes fancy-assignment's last-occurrence the newest sample
                self._latest[e[newer], s[newer]] = m[newer]
                self._latest_t[e[newer], s[newer]] = t[newer]
            return int(ok.sum())

    def add_sample(self, entity_id: int, time_ms: int, metrics) -> bool:
        return self.add_samples(
            np.array([entity_id]), np.array([time_ms]),
            np.array([metrics], np.float64)
        ) == 1

    # ----- aggregation -----------------------------------------------------

    def aggregate(self, num_entities: int | None = None) -> AggregationResult:
        """Roll up the W completed windows (newest-but-one backwards).

        ``num_entities`` lets the caller size the result to the metadata
        snapshot (entities never sampled count as invalid, which is exactly
        how completeness sees unmonitored partitions).
        """
        with self._lock:
            E = self.num_entities if num_entities is None else int(num_entities)
            W, M = self.num_windows, self.metric_def.num_metrics
            if self._base_window is None:
                values = np.zeros((E, 0, M))
                extrap = np.zeros((E, 0), np.int8)
                starts = np.zeros(0, np.int64)
                return AggregationResult(
                    values, extrap, np.zeros(E, bool), starts, 0.0,
                    self._generation,
                )
            # Read path: never grow the store (that would bump the generation
            # on a pure read) — entities beyond the stored range are reported
            # as never-sampled via zero-padded virtual rows.
            Es = min(E, self.num_entities)
            sum_, max_, latest = self._sum[:Es, :W], self._max[:Es, :W], self._latest[:Es, :W]
            count = self._count[:Es, :W]
            if E > Es:
                pad = (0, E - Es)
                sum_ = np.pad(sum_, (pad, (0, 0), (0, 0)))
                max_ = np.pad(max_, (pad, (0, 0), (0, 0)),
                              constant_values=-np.inf)
                latest = np.pad(latest, (pad, (0, 0), (0, 0)))
                count = np.pad(count, (pad, (0, 0)))

            with np.errstate(invalid="ignore", divide="ignore"):
                avg = np.where(count[..., None] > 0, sum_ / np.maximum(count[..., None], 1), 0.0)
            vals = np.where(
                self._is_avg, avg,
                np.where(self._is_max, np.where(np.isfinite(max_), max_, 0.0), latest),
            )

            has_any = count > 0
            enough = count >= self.min_samples_per_window
            # AVG_ADJACENT for empty windows with a sampled window on each side
            left = np.zeros_like(has_any)
            right = np.zeros_like(has_any)
            left[:, 1:] = has_any[:, :-1]
            right[:, :-1] = has_any[:, 1:]
            adjacent_ok = (~has_any) & left & right
            vleft = np.zeros_like(vals)
            vright = np.zeros_like(vals)
            vleft[:, 1:] = vals[:, :-1]
            vright[:, :-1] = vals[:, 1:]
            vals = np.where(adjacent_ok[..., None], 0.5 * (vleft + vright), vals)

            extrap = np.full((E, W), Extrapolation.NONE, np.int8)
            extrap[has_any & ~enough] = Extrapolation.FORCED_INSUFFICIENT
            extrap[adjacent_ok] = Extrapolation.AVG_ADJACENT
            extrap[~has_any & ~adjacent_ok] = Extrapolation.NO_VALID

            # Windows predating the first real sample ("pre-genesis") do not
            # exist yet: report only windows since genesis so early models
            # with few-but-complete windows are possible (numValidWindows
            # reflects actual data, as in the reference).
            k = 0
            if self._first_window is not None:
                k = min(max(self._first_window - self._base_window, 0), W)
            vals = vals[:, k:]
            extrap = extrap[:, k:]

            n_extrapolated = (extrap > Extrapolation.NONE).sum(axis=1)
            entity_valid = (
                (extrap != Extrapolation.NO_VALID).all(axis=1)
                & (n_extrapolated <= self.max_allowed_extrapolations)
                & (extrap.shape[1] > 0)
            )
            ratio = float(entity_valid.mean()) if E else 0.0
            starts = (self._base_window + np.arange(k, W)) * self.window_ms
            return AggregationResult(
                vals, extrap, entity_valid, starts, ratio, self._generation
            )

    def completeness(self, num_entities: int | None = None,
                     req: ModelCompletenessRequirements | None = None):
        """(valid_entity_ratio, num_windows, meets) summary (ref
        ``MetricSampleCompleteness``)."""
        r = self.aggregate(num_entities)
        ok = r.meets(req) if req is not None else True
        return r.valid_entity_ratio, r.num_windows, ok
