"""Live-stream anomaly detection — the closing of the control loop.

The seed-ported detectors (``ccx.detector.detectors``) poll the load
monitor on fixed intervals, the way the reference's
``AnomalyDetectorManager`` does. But rounds 5-18 already put a richer
signal stream on the wire — chunk-heartbeat energies, ``warm_pressure``
bands banked with every placement, goal-violation and fleet/devmem
gauges in ``ccx.common.metrics`` — and nothing consumed it. This module
subscribes to that stream and closes the loop:

1. **classify** each serving window with seeded-deterministic rules
   (fixed thresholds, fixed family priority — the same signal stream
   replays to the same decisions, the property every soak gate and test
   relies on);
2. **heal**: on the first classified violation open a healing episode
   (ONE per cluster — a persistent violation must not storm the facade
   with verbs) and fire the healer callback once, at urgent priority in
   the manager wiring;
3. **forecast**: fit a linear trend to the drift history of each
   cluster's warm-pressure band and, when the trend crosses the
   threshold within the horizon, pre-warm the cluster's base via
   ``PlacementStore`` *before* the violation lands (the consumer-group
   autoscaler move: predict from the history you already bank);
4. **account**: every window feeds the windowed SLO engine
   (``ccx.common.slo``), every decision rides the flight recorder as a
   structured healing-event timeline (detected -> fired -> recovered,
   with cause attribution) plus the labeled Prometheus families
   ``ccx_time_to_heal_seconds{family}`` / ``ccx_slo_burn_rate{objective}``.

The detector is transport-agnostic: the facade's
``AnomalyDetectorManager`` wires the healer to the existing anomaly
verbs, ``bench.py --soak`` wires it to an urgent warm re-propose.
"""

from __future__ import annotations

import random

from ccx_torch.common.slo import SloEngine, SloObjectives

#: classification families, in FIXED priority order — when several rules
#: trip in one window, the first match is the episode's family (the
#: cause attribution is deterministic, never racy)
FAMILIES = (
    "broker_failure",
    "devmem_pressure",
    "goal_violation",
    "cold_serve",
    "latency_burst",
    "pressure_surge",
)

#: family -> facade verb the manager-wired healer fires (ref: the
#: anomaly classes' ``fix`` dispatch). The bench healer substitutes an
#: urgent warm re-propose for all of them.
FAMILY_VERB = {
    "broker_failure": "remove_brokers",
    "devmem_pressure": "rebalance",
    "goal_violation": "rebalance",
    "cold_serve": "rebalance",
    "latency_burst": "rebalance",
    "pressure_surge": "rebalance",
}


def _cfg(config, key, default):
    try:
        return config[key]
    except Exception:  # noqa: BLE001 — absent key (plain dict / None)
        return default


def _default_prewarm(cluster: str) -> bool:
    """Touch the cluster's banked warm base at raised priority: the
    ledger LRU-refreshes and re-prices it, so a predicted violation
    finds the base resident instead of evicted."""
    try:
        from ccx_torch.search.incremental import STORE

        return STORE.get(cluster, priority=1, job=f"prewarm-{cluster}") \
            is not None
    except Exception:  # noqa: BLE001 — prewarm is best-effort
        return False


class StreamDetector:
    """Seeded-deterministic anomaly classification over the live signal
    stream, with one-verb-per-episode healing and SLO accounting.

    ``observe(cluster, signals, t_s)`` is the single entry point — call
    it once per serving window with whatever signals are flowing:

    - ``warm`` / ``verified`` / ``wall_s`` — the window outcome;
    - ``dead_brokers`` — tuple of dead broker ids (structural signal);
    - ``goal_violations`` — count of violated goals on the window;
    - ``pressure`` — the warm-pressure band scalar (mean top-band
      broker pressure from the banked ``warm_pressure`` stack);
    - ``energy`` — last chunk-heartbeat energy (tier-0 lex cost);
    - ``devmem_within_budget`` — the unified ledger's verdict;
    - ``fault`` — injected-fault attribution (chaos seam), when known.

    Absent signals are treated as healthy; the rules never crash on a
    partial stream.
    """

    def __init__(self, config=None, healer=None, prewarmer=None,
                 clock=None, objectives: SloObjectives | None = None) -> None:
        self.enabled = bool(_cfg(config, "detector.stream.enabled", True))
        self.seed = int(_cfg(config, "detector.stream.seed", 0))
        #: consecutive clean windows that close an episode (the FIRST of
        #: the streak stamps t_recovered — "first verified-clean window")
        self.clean_windows = max(
            int(_cfg(config, "detector.stream.clean.windows", 2)), 1
        )
        self.pressure_threshold = float(
            _cfg(config, "detector.stream.pressure.threshold", 0.75)
        )
        self.forecast_windows = max(
            int(_cfg(config, "detector.stream.forecast.windows", 8)), 2
        )
        self.forecast_horizon = max(
            int(_cfg(config, "detector.stream.forecast.horizon.windows", 3)),
            1,
        )
        self.slo = SloEngine(
            objectives or SloObjectives.from_config(config)
        )
        self.healer = healer
        self.prewarmer = prewarmer or _default_prewarm
        self.clock = clock
        #: deterministic tie-break / jitter source — NEVER consulted for
        #: classification (rules are pure thresholds); reserved for
        #: sampling decisions so reruns stay replayable
        self.rng = random.Random(self.seed)
        #: cluster -> pressure history (drift trend the forecast fits)
        self._pressure: dict[str, list[float]] = {}
        #: cluster -> consecutive clean windows since the verb fired
        self._clean_streak: dict[str, int] = {}
        #: cluster -> t of the FIRST clean window of the current streak
        self._clean_since: dict[str, float] = {}
        #: cluster -> first violating-signal time for a not-yet-opened
        #: episode (detection latency measurement starts here)
        self._first_signal: dict[str, float] = {}
        #: clusters whose forecast already pre-warmed (re-armed when the
        #: prediction clears) — one prewarm per predicted crossing
        self._forecast_armed: set[str] = set()
        self._prewarms = 0
        self.metrics = {
            "detected": 0, "fired": 0, "recovered": 0, "forecasts": 0,
        }

    # ----- classification rules (seeded-deterministic) ----------------------

    def classify(self, signals: dict) -> list[tuple[str, str]]:
        """(family, cause) list for one window's signals, in family
        priority order. Pure function of the signals — same stream,
        same verdicts."""
        out: list[tuple[str, str]] = []
        dead = tuple(signals.get("dead_brokers") or ())
        if dead:
            out.append(("broker_failure", f"dead brokers {list(dead)}"))
        if signals.get("devmem_within_budget") is False:
            out.append(
                ("devmem_pressure", "device-memory ledger over budget")
            )
        gv = int(signals.get("goal_violations") or 0)
        if gv > 0:
            out.append(("goal_violation", f"{gv} violated goal(s)"))
        if not signals.get("verified", True) or (
            signals.get("warm") is False and signals.get("cold_fallback")
        ):
            why = signals.get("fault") or (
                "unverified window" if not signals.get("verified", True)
                else "cold fallback (warm base lost)"
            )
            out.append(("cold_serve", str(why)))
        wall = signals.get("wall_s")
        if wall is not None and wall > self.slo.objectives.latency_budget_s:
            out.append((
                "latency_burst",
                f"wall {float(wall):.3f}s over "
                f"{self.slo.objectives.latency_budget_s:.3f}s budget",
            ))
        p = signals.get("pressure")
        if p is not None and float(p) >= self.pressure_threshold:
            out.append((
                "pressure_surge",
                f"pressure {float(p):.3f} >= "
                f"{self.pressure_threshold:.3f}",
            ))
        return out

    # ----- drift-history forecast -------------------------------------------

    def _forecast(self, cluster: str, t_s: float) -> dict | None:
        """Least-squares trend over the pressure history; pre-warm when
        the extrapolation crosses the threshold within the horizon."""
        hist = self._pressure.get(cluster)
        if not hist or len(hist) < self.forecast_windows:
            return None
        ys = hist[-self.forecast_windows:]
        n = len(ys)
        xs = range(n)
        mx = (n - 1) / 2.0
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        slope = (sxy / sxx) if sxx else 0.0
        predicted = ys[-1] + slope * self.forecast_horizon
        if ys[-1] >= self.pressure_threshold:
            return None  # already violating: detection's job, not forecast's
        if predicted < self.pressure_threshold:
            self._forecast_armed.discard(cluster)
            return None
        if cluster in self._forecast_armed:
            return None  # one prewarm per predicted crossing
        self._forecast_armed.add(cluster)
        self.metrics["forecasts"] += 1
        prewarmed = False
        try:
            prewarmed = bool(self.prewarmer(cluster))
        except Exception:  # noqa: BLE001 — prewarm is best-effort
            prewarmed = False
        if prewarmed:
            self._prewarms += 1
        event = {
            "cluster": cluster,
            "predicted": round(predicted, 4),
            "slope": round(slope, 5),
            "horizonWindows": self.forecast_horizon,
            "prewarmed": prewarmed,
        }
        self._healing_record("forecast", t_s, **event)
        return event

    # ----- the timeline + metrics sinks -------------------------------------

    def _healing_record(self, phase: str, t_s: float, **attrs) -> None:
        """One structured healing-event record on the flight recorder
        (and every tracer listener): the timeline a dead soak run's
        recording still names."""
        try:
            from ccx_torch.common.tracing import TRACER

            TRACER.healing_event(phase, t=round(float(t_s), 3), **attrs)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            pass

    def _publish_burn_rates(self) -> None:
        try:
            from ccx_torch.common.metrics import REGISTRY

            for obj, burns in self.slo.burn_rates().items():
                v = burns["short"]
                if v is None:
                    continue
                REGISTRY.set_gauge(
                    "slo-burn-rate", float(v),
                    labels={"objective": obj},
                    help="short-window SLO burn rate per objective "
                         "(error rate over error budget; 1.0 spends "
                         "the budget exactly)",
                )
        except Exception:  # noqa: BLE001
            pass

    def _observe_time_to_heal(self, family: str, tth_s: float) -> None:
        try:
            from ccx_torch.common.metrics import REGISTRY

            REGISTRY.histogram(
                "time-to-heal-seconds",
                help="first violating signal to first verified-clean "
                     "window, per anomaly family",
                labels={"family": family},
            ).observe(float(tth_s))
        except Exception:  # noqa: BLE001
            pass

    # ----- the entry point ---------------------------------------------------

    def observe(self, cluster: str, signals: dict, t_s: float) -> dict:
        """Account one serving window and run the control loop. Returns
        the decision record: classification, episode state, and whether
        a verb was fired (and which)."""
        if not self.enabled:
            return {"enabled": False}
        violations = self.classify(signals)
        p = signals.get("pressure")
        if p is not None:
            self._pressure.setdefault(cluster, []).append(float(p))
            del self._pressure[cluster][:-max(self.forecast_windows * 4, 64)]
        forecast = self._forecast(cluster, t_s)
        good = self.slo.observe(
            cluster,
            warm=bool(signals.get("warm")),
            verified=bool(signals.get("verified")),
            wall_s=signals.get("wall_s"),
            violation_free=not violations,
        )
        decision: dict = {
            "cluster": cluster,
            "violations": violations,
            "good": good,
            "fired": False,
            "verb": None,
            "episode": None,
        }
        if forecast is not None:
            decision["forecast"] = forecast
        ep = self.slo.episode(cluster)
        if violations:
            family, cause = violations[0]
            self._clean_streak[cluster] = 0
            self._clean_since.pop(cluster, None)
            if ep is None:
                first = self._first_signal.pop(cluster, t_s)
                ep = self.slo.open_episode(
                    cluster, family, cause,
                    t_first_signal_s=first, t_detected_s=t_s,
                )
                self.metrics["detected"] += 1
                self._healing_record(
                    "detected", t_s, cluster=cluster, family=family,
                    cause=cause, episode=ep.episode_id,
                )
                verb = None
                if self.healer is not None:
                    try:
                        verb = self.healer(cluster, family, cause)
                    except Exception as e:  # noqa: BLE001 — a failed
                        # verb leaves the episode open; the next clean
                        # windows (or the soak gate) decide its fate
                        verb = None
                        self._healing_record(
                            "fire-failed", t_s, cluster=cluster,
                            family=family, episode=ep.episode_id,
                            error=f"{type(e).__name__}: {e}",
                        )
                if verb is not None:
                    self.slo.mark_fired(cluster, verb, t_s)
                    self.metrics["fired"] += 1
                    self._healing_record(
                        "fired", t_s, cluster=cluster, family=family,
                        verb=verb, episode=ep.episode_id,
                    )
                    decision["fired"] = True
                    decision["verb"] = verb
            # else: episode already open — one verb per episode, the
            # persistent violation only extends it
            decision["episode"] = ep.episode_id if ep is not None else None
        else:
            self._first_signal.pop(cluster, None)
            if ep is not None:
                # clean window while an episode is open: recovery needs
                # `clean_windows` consecutive ones; t_recovered is the
                # FIRST of the streak (first verified-clean window)
                streak = self._clean_streak.get(cluster, 0) + 1
                self._clean_streak[cluster] = streak
                self._clean_since.setdefault(cluster, t_s)
                if streak >= self.clean_windows:
                    t_rec = self._clean_since.pop(cluster, t_s)
                    closed = self.slo.mark_recovered(cluster, t_rec)
                    self._clean_streak.pop(cluster, None)
                    if closed is not None:
                        self.metrics["recovered"] += 1
                        tth = closed.time_to_heal_s
                        if tth is not None:
                            self._observe_time_to_heal(closed.family, tth)
                        self._healing_record(
                            "recovered", t_rec, cluster=cluster,
                            family=closed.family, verb=closed.verb,
                            episode=closed.episode_id,
                            timeToHealS=(
                                None if tth is None else round(tth, 3)
                            ),
                        )
                        decision["recovered"] = closed.episode_id
        self._publish_burn_rates()
        return decision

    def note_fired(self, cluster: str, verb: str, t_s: float) -> bool:
        """Mark an open, not-yet-fired episode as healed by an EXTERNAL
        actor — the queue-path drain in service poll mode, which owns
        notifier grace/backoff and must stay the only verb source there.
        The one-verb accounting and the timeline mirror the heal the
        stream itself did not fire."""
        ep = self.slo.episode(cluster)
        if ep is None or ep.verb is not None:
            return False
        self.slo.mark_fired(cluster, verb, t_s)
        self.metrics["fired"] += 1
        self._healing_record(
            "fired", t_s, cluster=cluster, family=ep.family, verb=verb,
            episode=ep.episode_id,
        )
        return True

    def note_signal(self, cluster: str, t_s: float) -> None:
        """Stamp the FIRST violating signal time for a cluster before
        the window that will carry it is observed — callers that see the
        raw signal earlier than the serving window (e.g. a fault
        injection) use this so time-to-detect starts at the signal, not
        at the observation."""
        self._first_signal.setdefault(cluster, float(t_s))

    # ----- observability -----------------------------------------------------

    def state(self) -> dict:
        """VIEWER-safe block (rides ``AnalyzerState.observability``):
        the SLO summary + detector counters, no paths, no stacks."""
        return {
            "enabled": self.enabled,
            "seed": self.seed,
            "cleanWindows": self.clean_windows,
            "pressureThreshold": self.pressure_threshold,
            "metrics": dict(self.metrics),
            "prewarms": self._prewarms,
            "slo": self.slo.summary(),
        }

    def observability_json(self, limit: int = 32) -> dict:
        """The USER-gated block (GET /observability): state plus the
        healing-event timeline."""
        out = self.state()
        out["timeline"] = self.slo.episodes_json(limit)
        return out
