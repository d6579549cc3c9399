"""Metrics registry — timers/meters/gauges/histograms with a Prometheus
text-exposition view.

A copy of the JAX package's ``metrics`` module (standard library only).

Parity: the reference exports Dropwizard ``MetricRegistry`` timers and
meters over JMX domain ``kafka.cruisecontrol`` — e.g. GoalOptimizer's
``proposal-computation-timer`` and per-endpoint servlet timers (SURVEY.md
§5.1/§5.5). Python has no JMX; the idiomatic equivalent is a registry
rendered in Prometheus text exposition format (version 0.0.4), which
SURVEY.md §7.2 step 5 prescribes for the rebuild.

Exposition contract: every metric family gets ``# HELP`` and ``# TYPE`` lines;
timers render as summaries (``_seconds_sum``/``_seconds_count``) plus a
``_seconds_max`` gauge; counters follow the ``_total`` naming convention;
histograms emit cumulative ``_bucket{le=...}`` series ending at ``+Inf``.
The servlet serves it with ``PROMETHEUS_CONTENT_TYPE``.
"""

from __future__ import annotations

import math
import threading
import time

#: the text-exposition content type the /metrics endpoint must serve
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class Timer:
    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._lock = threading.Lock()

    def update(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)

    def time(self):
        registry_timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.monotonic()
                return self

            def __exit__(self, *exc):
                registry_timer.update(time.monotonic() - self.t0)
                return False

        return _Ctx()

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class Counter:
    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """A SETTABLE gauge (vs the callable-backed gauges ``gauge()``
    registers): holds the last value written. Used for push-style live
    state — e.g. the convergence taps' per-job energy/plateau gauges,
    where the producer (a chunk heartbeat) knows the value and no
    callable could recompute it."""

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Prometheus-style cumulative histogram. The default buckets span
    5 ms .. 10 min — sized for optimizer phases and sidecar RPCs, where
    the interesting tail is a multi-minute cold proposal, not a
    microsecond cache hit."""

    DEFAULT_BUCKETS = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
        30.0, 60.0, 120.0, 300.0, 600.0,
    )

    def __init__(self, buckets: tuple[float, ...] | None = None) -> None:
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        """Cumulative per-bucket counts keyed by upper bound (+Inf last)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        cum = 0
        out: dict = {"count": total, "sum": s, "buckets": {}}
        for le, c in zip(self.buckets, counts):
            cum += c
            out["buckets"][le] = cum
        out["buckets"][math.inf] = total
        return out


def _fmt_le(le: float) -> str:
    if math.isinf(le):
        return "+Inf"
    s = f"{le:g}"
    return s


class MetricsRegistry:
    """Process-wide named timers/counters/gauges/histograms (ref
    MetricRegistry)."""

    def __init__(self, prefix: str = "ccx") -> None:
        self.prefix = prefix
        self._timers: dict[str, Timer] = {}
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, object] = {}  # name -> callable() -> float
        #: settable gauges, composite-keyed like histograms when labeled
        #: ('name|[["k","v"],...]'); one family may NOT also be a
        #: callable gauge (duplicate TYPE) — naming keeps them apart
        self._gauge_values: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _label_key(name: str, labels: dict | None) -> str:
        import json as _json

        if not labels:
            return name
        return name + "|" + _json.dumps(
            sorted((str(k), str(v)) for k, v in labels.items())
        )

    def _set_help(self, name: str, help: str | None) -> None:
        if help and name not in self._help:
            self._help[name] = help

    def timer(self, name: str, help: str | None = None) -> Timer:
        with self._lock:
            self._set_help(name, help)
            return self._timers.setdefault(name, Timer())

    def counter(self, name: str, help: str | None = None) -> Counter:
        with self._lock:
            self._set_help(name, help)
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str, fn, help: str | None = None) -> None:
        with self._lock:
            self._set_help(name, help)
            self._gauges[name] = fn

    def histogram(self, name: str, buckets: tuple[float, ...] | None = None,
                  help: str | None = None,
                  labels: dict[str, str] | None = None) -> Histogram:
        """``labels`` (e.g. ``{"job": cluster_id}`` — fleet serving's
        per-job span histograms) keys a separate series of the SAME metric
        family: one ``# TYPE`` declaration, one ``_bucket``/``_sum``/
        ``_count`` series per label set, labels merged with ``le`` on the
        bucket lines. Label VALUES are arbitrary strings (cluster ids come
        off the wire) — the composite key holds them JSON-encoded so
        ``,``/``=``/``"`` can neither corrupt the key nor the exposition."""
        key = self._label_key(name, labels)
        with self._lock:
            self._set_help(name, help)
            return self._histograms.setdefault(key, Histogram(buckets))

    def set_gauge(self, name: str, value: float,
                  labels: dict[str, str] | None = None,
                  help: str | None = None) -> Gauge:
        """Write a settable gauge series (same label contract as
        ``histogram``): one ``# TYPE gauge`` family, one sample line per
        label set. Used by the convergence taps for the live per-job
        energy / per-phase plateau-step gauges."""
        key = self._label_key(name, labels)
        with self._lock:
            self._set_help(name, help)
            g = self._gauge_values.setdefault(key, Gauge())
        g.set(value)
        return g

    def render_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of everything registered:
        ``# HELP`` + ``# TYPE`` per family, summaries for timers,
        ``_total`` counters, gauges, cumulative histograms."""
        out: list[str] = []

        def sanitize(name: str) -> str:
            return name.replace("-", "_").replace(".", "_").replace(" ", "_")

        def esc(text: str) -> str:
            return text.replace("\\", "\\\\").replace("\n", "\\n")

        with self._lock:
            timers = dict(self._timers)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            gauge_values = dict(self._gauge_values)
            histograms = dict(self._histograms)
            helps = dict(self._help)

        def head(raw_name: str, family: str, typ: str, default_help: str):
            out.append(
                f"# HELP {family} {esc(helps.get(raw_name, default_help))}"
            )
            out.append(f"# TYPE {family} {typ}")

        for name, t in sorted(timers.items()):
            n = f"{self.prefix}_{sanitize(name)}_seconds"
            head(name, n, "summary", f"{name} timer (seconds)")
            out.append(f"{n}_sum {t.total_s:.6f}")
            out.append(f"{n}_count {t.count}")
            head(name + "/max", f"{n}_max", "gauge",
                 f"{name} timer max single observation (seconds)")
            out.append(f"{n}_max {t.max_s:.6f}")
        for name, c in sorted(counters.items()):
            n = f"{self.prefix}_{sanitize(name)}_total"
            head(name, n, "counter", f"{name} counter")
            out.append(f"{n} {c.value}")
        for name, fn in sorted(gauges.items()):
            try:
                v = float(fn())
            except Exception:
                continue
            n = f"{self.prefix}_{sanitize(name)}"
            head(name, n, "gauge", f"{name} gauge")
            out.append(f"{n} {v}")
        # labeled series ('name|[["k","v"],...]' — JSON-packed label
        # pairs) share one family — HELP/TYPE emitted once per family
        # (the strict exposition parser forbids duplicate TYPE
        # declarations). Label values escape \ " and newline per the
        # exposition format.
        import json as _json

        def esc_label(v: str) -> str:
            return (
                v.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def label_str(labelstr: str) -> str:
            if not labelstr:
                return ""
            inner = ",".join(
                f'{sanitize(k)}="{esc_label(v)}"'
                for k, v in _json.loads(labelstr)
            )
            return "{" + inner + "}"

        # settable gauges (push-style — convergence energy/plateau): one
        # gauge family per name, one sample per label set, grouped so
        # every sample follows its family's TYPE line
        declared_g: set[str] = set()
        for key, g in sorted(
            gauge_values.items(),
            key=lambda kv: (kv[0].partition("|")[0], kv[0]),
        ):
            name, _, labelstr = key.partition("|")
            n = f"{self.prefix}_{sanitize(name)}"
            if n not in declared_g:
                declared_g.add(n)
                head(name, n, "gauge", f"{name} gauge")
            out.append(f"{n}{label_str(labelstr)} {g.value}")

        declared: set[str] = set()
        for key, h in sorted(
            histograms.items(), key=lambda kv: (kv[0].partition("|")[0], kv[0])
        ):
            name, _, labelstr = key.partition("|")
            n = f"{self.prefix}_{sanitize(name)}"
            snap = h.snapshot()
            if n not in declared:
                declared.add(n)
                head(name, n, "histogram", f"{name} histogram")
            extra = ""
            if labelstr:
                series = label_str(labelstr)
                extra = "," + series[1:-1]
            else:
                series = ""
            for le, cum in snap["buckets"].items():
                out.append(f'{n}_bucket{{le="{_fmt_le(le)}"{extra}}} {cum}')
            out.append(f"{n}_sum{series} {snap['sum']:.6f}")
            out.append(f"{n}_count{series} {snap['count']}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "timers": {
                    k: {"count": t.count, "meanSec": t.mean_s, "maxSec": t.max_s}
                    for k, t in self._timers.items()
                },
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {
                    k: g.value for k, g in self._gauge_values.items()
                },
                "histograms": {
                    k: {"count": h.count, "sumSec": round(h.sum, 4)}
                    for k, h in self._histograms.items()
                },
            }


#: the process-wide default registry (ref: the app's single MetricRegistry)
REGISTRY = MetricsRegistry()
