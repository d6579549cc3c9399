"""Windowed SLO engine — the accounting half of the closed control loop.

The reference system is a *continuous self-managing service*: an anomaly
detector watches the cluster and fires self-healing verbs. Rounds 5-18
put the raw signals on the wire (chunk-heartbeat energy, warm-pressure
bands, goal/fleet/devmem gauges); this module turns them into
*objectives* an operator can page on and a soak rung can gate on:

- **warm_served** — fraction of serving windows answered by the warm
  incremental path AND verified (the product's headline promise: drift
  served at steady-state latency, not the cold wall);
- **latency** — fraction of windows whose end-to-end wall landed inside
  the per-window latency budget;
- **violation_free** — fraction of windows with no classified anomaly
  signal (goal violations, dead brokers, devmem pressure) — the
  goal-violation *dwell* objective: how much of the timeline the fleet
  spent in violation.

Each objective is tracked per cluster as TWO sliding windows (short /
long, in serving-window counts) and reported as *burn rates*: the
fraction of the error budget consumed per window interval,
``burn = error_rate / (1 - target)`` — burn 1.0 exactly spends the
budget, >1 is on course to violate the SLO, the classic multi-window
alert pairs the fast window (page) with the slow one (ticket).

The engine also owns the *healing episode* ledger: one episode per
(cluster, violation family) from the first violating signal through the
detector's verb to the first verified-clean window, measuring
time-to-detect and time-to-heal. ``ccx.detector.stream`` drives it from
the live signal stream; ``bench.py --soak`` gates on its numbers;
``tools/bench_ledger.py`` trends them.

Like ``ccx.common.convergence``, this module is deliberately
stdlib-only — no jax, no numpy — so the ledger and the tools import it
instantly without dragging the device stack in.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools

#: objective name -> the window-level predicate it counts (documentation;
#: the engine consumes pre-computed booleans)
OBJECTIVES = ("warm_served", "latency", "violation_free")


def percentile(values, q: float):
    """Nearest-rank percentile of an iterable (None when empty) — the
    same convention the bench rungs use for their p99 walls."""
    vals = sorted(values)
    if not vals:
        return None
    i = min(int(round(q * (len(vals) - 1))), len(vals) - 1)
    return vals[i]


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """Per-cluster objective targets + window geometry (config keys
    ``observability.slo.*``; see ``observability_config_def``)."""

    #: span of one accounting window in (simulated or wall) seconds —
    #: the soak bench advances a simulated clock by this much per tick
    window_s: float = 10.0
    #: short (paging) window, in serving-window counts
    short_windows: int = 12
    #: long (ticket) window, in serving-window counts
    long_windows: int = 60
    #: warm-served fraction target (error budget = 1 - target)
    warm_target: float = 0.95
    #: per-window end-to-end latency budget (seconds); windows at or
    #: under budget count as good
    latency_budget_s: float = 5.0
    #: latency-SLO target fraction
    latency_target: float = 0.99
    #: violation-free (goal-violation dwell) target fraction
    dwell_target: float = 0.95

    @classmethod
    def from_config(cls, config) -> "SloObjectives":
        """Build from the ``observability.slo.*`` keys of a
        CruiseControlConfig (missing keys fall back to the dataclass
        defaults, so plain dicts work in tests)."""
        def g(key, default):
            try:
                return config[key]
            except Exception:  # noqa: BLE001 — absent key -> default
                return default
        return cls(
            window_s=float(g("observability.slo.window.seconds", 10.0)),
            short_windows=int(g("observability.slo.short.windows", 12)),
            long_windows=int(g("observability.slo.long.windows", 60)),
            warm_target=float(g("observability.slo.warm.target", 0.95)),
            latency_budget_s=float(
                g("observability.slo.latency.budget.seconds", 5.0)
            ),
            latency_target=float(
                g("observability.slo.latency.target", 0.99)
            ),
            dwell_target=float(g("observability.slo.dwell.target", 0.95)),
        )

    def target(self, objective: str) -> float:
        return {
            "warm_served": self.warm_target,
            "latency": self.latency_target,
            "violation_free": self.dwell_target,
        }[objective]


class _BoolWindow:
    """A sliding window of good/bad window outcomes."""

    __slots__ = ("_dq",)

    def __init__(self, maxlen: int) -> None:
        self._dq: collections.deque = collections.deque(maxlen=max(maxlen, 1))

    def add(self, ok: bool) -> None:
        self._dq.append(bool(ok))

    @property
    def seen(self) -> int:
        return len(self._dq)

    def error_rate(self) -> float | None:
        if not self._dq:
            return None
        return 1.0 - (sum(self._dq) / len(self._dq))


@dataclasses.dataclass
class HealingEpisode:
    """One detected -> verb fired -> recovered arc, with cause
    attribution. Times are engine-clock seconds (the soak bench feeds a
    simulated clock); ``None`` until the phase happens."""

    episode_id: int
    cluster: str
    family: str
    cause: str
    t_first_signal_s: float
    t_detected_s: float
    t_fired_s: float | None = None
    t_recovered_s: float | None = None
    verb: str | None = None
    #: serving windows observed while the episode was open
    windows: int = 0

    @property
    def open(self) -> bool:
        return self.t_recovered_s is None

    @property
    def time_to_detect_s(self) -> float:
        return max(self.t_detected_s - self.t_first_signal_s, 0.0)

    @property
    def time_to_heal_s(self) -> float | None:
        """First violating signal -> first verified-clean window."""
        if self.t_recovered_s is None:
            return None
        return max(self.t_recovered_s - self.t_first_signal_s, 0.0)

    def to_json(self) -> dict:
        tth = self.time_to_heal_s
        return {
            "episode": self.episode_id,
            "cluster": self.cluster,
            "family": self.family,
            "cause": self.cause,
            "detectedS": round(self.t_detected_s, 3),
            "firedS": (
                None if self.t_fired_s is None else round(self.t_fired_s, 3)
            ),
            "recoveredS": (
                None if self.t_recovered_s is None
                else round(self.t_recovered_s, 3)
            ),
            "verb": self.verb,
            "windows": self.windows,
            "timeToDetectS": round(self.time_to_detect_s, 3),
            "timeToHealS": None if tth is None else round(tth, 3),
            "open": self.open,
        }


class SloEngine:
    """Sliding-window objective accounting + the healing-episode ledger.

    Not thread-safe by itself: callers (the stream detector, the soak
    bench) serialize observations per process — the same contract as the
    convergence taps."""

    #: closed episodes retained for the observability timeline
    EPISODE_LIMIT = 256

    def __init__(self, objectives: SloObjectives | None = None) -> None:
        self.objectives = objectives or SloObjectives()
        #: cluster -> objective -> (short window, long window)
        self._windows: dict[str, dict[str, tuple[_BoolWindow, _BoolWindow]]] = {}
        #: cluster -> objective -> (good, total) over the WHOLE run — the
        #: soak bench's compliance gate reads this, not the sliding pair
        self._totals: dict[str, dict[str, list[int]]] = {}
        self._episode_ids = itertools.count(1)
        #: open episodes, keyed by cluster (one verb per episode — a
        #: persistent violation must not storm the facade with verbs)
        self._open: dict[str, HealingEpisode] = {}
        self._closed: collections.deque = collections.deque(
            maxlen=self.EPISODE_LIMIT
        )

    # ----- window accounting ------------------------------------------------

    def _cluster_windows(self, cluster: str):
        w = self._windows.get(cluster)
        if w is None:
            o = self.objectives
            w = self._windows[cluster] = {
                obj: (
                    _BoolWindow(o.short_windows),
                    _BoolWindow(o.long_windows),
                )
                for obj in OBJECTIVES
            }
            self._totals[cluster] = {obj: [0, 0] for obj in OBJECTIVES}
        return w

    def observe(self, cluster: str, *, warm: bool, verified: bool,
                wall_s: float | None, violation_free: bool = True) -> dict:
        """Account one serving window; returns the per-objective goodness
        booleans (the detector reuses them for episode recovery)."""
        good = {
            "warm_served": bool(warm and verified),
            "latency": (
                wall_s is not None
                and wall_s <= self.objectives.latency_budget_s
            ),
            "violation_free": bool(violation_free),
        }
        w = self._cluster_windows(cluster)
        totals = self._totals[cluster]
        for obj, ok in good.items():
            short, long_ = w[obj]
            short.add(ok)
            long_.add(ok)
            totals[obj][0] += int(ok)
            totals[obj][1] += 1
        ep = self._open.get(cluster)
        if ep is not None:
            ep.windows += 1
        return good

    def burn_rates(self, cluster: str | None = None) -> dict:
        """objective -> {short, long} burn rates (error rate over error
        budget; None before any observation). ``cluster=None`` returns
        the worst burn across clusters per objective — the paging view."""
        clusters = (
            [cluster] if cluster is not None else list(self._windows)
        )
        out: dict = {}
        for obj in OBJECTIVES:
            budget = max(1.0 - self.objectives.target(obj), 1e-9)
            short_burn = long_burn = None
            for cid in clusters:
                w = self._windows.get(cid)
                if w is None:
                    continue
                short, long_ = w[obj]
                se, le = short.error_rate(), long_.error_rate()
                if se is not None:
                    b = se / budget
                    short_burn = b if short_burn is None else max(short_burn, b)
                if le is not None:
                    b = le / budget
                    long_burn = b if long_burn is None else max(long_burn, b)
            out[obj] = {"short": short_burn, "long": long_burn}
        return out

    def compliance(self, cluster: str | None = None) -> dict:
        """objective -> {good, total, fraction, target, met} over the
        whole run (aggregated across clusters when ``cluster`` is None)."""
        clusters = (
            [cluster] if cluster is not None else list(self._totals)
        )
        out: dict = {}
        for obj in OBJECTIVES:
            good = total = 0
            for cid in clusters:
                t = self._totals.get(cid)
                if t is None:
                    continue
                good += t[obj][0]
                total += t[obj][1]
            frac = (good / total) if total else None
            target = self.objectives.target(obj)
            out[obj] = {
                "good": good, "total": total,
                "fraction": None if frac is None else round(frac, 4),
                "target": target,
                "met": bool(frac is None or frac >= target),
            }
        return out

    # ----- healing episodes -------------------------------------------------

    def open_episode(self, cluster: str, family: str, cause: str,
                     t_first_signal_s: float,
                     t_detected_s: float) -> HealingEpisode | None:
        """Open a healing episode for ``cluster`` — returns the new
        episode, or None when one is already open (one verb per episode:
        the caller must NOT fire another verb)."""
        if cluster in self._open:
            return None
        ep = HealingEpisode(
            episode_id=next(self._episode_ids),
            cluster=cluster, family=family, cause=cause,
            t_first_signal_s=float(t_first_signal_s),
            t_detected_s=float(t_detected_s),
        )
        self._open[cluster] = ep
        return ep

    def episode(self, cluster: str) -> HealingEpisode | None:
        return self._open.get(cluster)

    def mark_fired(self, cluster: str, verb: str, t_s: float) -> None:
        ep = self._open.get(cluster)
        if ep is not None and ep.t_fired_s is None:
            ep.t_fired_s = float(t_s)
            ep.verb = verb

    def mark_recovered(self, cluster: str, t_s: float) -> HealingEpisode | None:
        """Close the cluster's open episode at the FIRST verified-clean
        window time ``t_s``; returns the closed episode."""
        ep = self._open.pop(cluster, None)
        if ep is None:
            return None
        ep.t_recovered_s = float(t_s)
        self._closed.append(ep)
        return ep

    def abandon(self, cluster: str) -> HealingEpisode | None:
        """Drop an open episode WITHOUT a recovery (kept out of the
        time-to-heal distribution; the soak gate counts it unrecovered)."""
        ep = self._open.pop(cluster, None)
        if ep is not None:
            self._closed.append(ep)
        return ep

    @property
    def open_episodes(self) -> list[HealingEpisode]:
        return list(self._open.values())

    @property
    def closed_episodes(self) -> list[HealingEpisode]:
        return list(self._closed)

    def times_to_heal(self) -> list[float]:
        return [
            ep.time_to_heal_s for ep in self._closed
            if ep.time_to_heal_s is not None
        ]

    def episodes_json(self, limit: int = 32) -> list[dict]:
        """Newest-last episode timeline (closed then open), bounded."""
        eps = list(self._closed)[-limit:] + list(self._open.values())
        return [ep.to_json() for ep in eps[-limit:]]

    # ----- observability ----------------------------------------------------

    def summary(self) -> dict:
        """VIEWER-safe summary for ``AnalyzerState.observability``: pure
        numbers and family names — no recorder paths, no stacks, no
        per-window detail."""
        tth = self.times_to_heal()
        return {
            "objectives": {
                "windowSeconds": self.objectives.window_s,
                "shortWindows": self.objectives.short_windows,
                "longWindows": self.objectives.long_windows,
                "warmTarget": self.objectives.warm_target,
                "latencyBudgetSeconds": self.objectives.latency_budget_s,
                "latencyTarget": self.objectives.latency_target,
                "dwellTarget": self.objectives.dwell_target,
            },
            "burnRates": self.burn_rates(),
            "compliance": self.compliance(),
            "episodes": {
                "open": len(self._open),
                "closed": len(self._closed),
                "recovered": len(tth),
                "timeToHealP50S": percentile(tth, 0.50),
                "timeToHealP99S": percentile(tth, 0.99),
            },
        }
