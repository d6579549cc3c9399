"""Adversarial scenario corpus — seeded structural/elasticity workloads.

A quality or latency number taken on ONE clean static snapshot per
config says nothing of the cases the optimizer exists for — broker
failures, full disks, hot-topic skew, capacity waves,
partition-count changes. The elasticity papers ("On Efficiently
Partitioning a Topic in Apache Kafka", arxiv 2205.09415; the
consumer-group autoscalers, 2402.06085/2206.11170 — PAPERS.md) argue
these events are the production COMMON case, not the exception.

This module is the generator: each **family** is a seeded, deterministic
sequence of snapshot windows derived from a converged base — exactly the
delta-snapshot stream a JVM LoadMonitor would send while the event
unfolds — with

* **shape stability by construction**: every window of every family
  keeps the base's padded program-shape key (``shape_key``: pow2 P/B/T
  buckets, the pow2 ``max_partitions_per_topic`` bucket, R, D,
  num_racks) — the precondition for the whole family × window matrix
  running ZERO-COMPILE after one prewarm pass. ``generate`` asserts it;
  a family that would cross a bucket is a bug here, not a recompile
  downstream;
* a **pinned quality envelope** per family (``ENVELOPES``): after each
  window's re-optimization the hard tiers must be clean (the result must
  verify — ``require_hard_zero`` stays on) and every soft goal tier must
  land within ``clean * mult + add`` of the clean converged baseline
  banked before any damage. The bounds are pinned here, scale-free
  (relative to the same cluster's own clean solve), and gated by
  ``tools/bench_ledger.py --check`` once banked;
* an **anomaly-verb mapping** (``ANOMALY_VERB``): the facade verb a
  detector would fire for the family's event — the warm-path routing
  story (a detector event is just a metrics window with structural
  damage; the warm repair + warm-SA pipeline self-heals it at
  steady-state latency instead of a cold solve).

Families (``FAMILIES``):

* ``broker-failures`` — cascading 1→k dead brokers across distinct
  racks, one more per window (the fix-offline-replicas event);
* ``disk-evacuation`` — one victim broker's disk progressively FILLS
  (its DISK capacity ramps below its clean-base usage), forcing the
  capacity repair to evacuate another slice of stored bytes each
  window;
* ``hot-skew`` — the densest topic's CPU/NW loads spike through a ramp
  (2× → 8×) and partially recover (the goal-violation / metric-anomaly
  event; metrics-only, so windows stay delta-graftable);
* ``broker-wave`` — capacity wave: add brokers (two windows), then
  demote ONE incumbent (leadership exclusion), then remove one
  (evacuation) — the add/demote/remove verb chain;
* ``partition-change`` — a topic's partition count grows each window
  (controller-style rack-striped round-robin placement for the new
  partitions), within the padded P bucket and the topic's pow2
  member bucket.

Stdlib + numpy only on the generation path (the bench runs import it
before they touch the device; the tests and tools import it headless).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: generation order is the documentation order — the bench runs the
#: matrix in this order and SCENARIO_r*.json keys its families by it
FAMILIES = (
    "broker-failures",
    "disk-evacuation",
    "hot-skew",
    "broker-wave",
    "partition-change",
)

#: family -> the facade anomaly verb a detector would fire for the event
#: (None = pure elasticity event served through the Propose path). The
#: warm-recovery acceptance gate (``--scenario``) requires at least
#: one VERB-mapped family to recover warm within ~2x the clean steady
#: window p50 — self-healing at steady-state latency, not the cold wall.
ANOMALY_VERB = {
    "broker-failures": "fix_offline_replicas",
    "disk-evacuation": "rebalance",  # DiskCapacityGoal-violation healing
    "hot-skew": "rebalance",  # goal-violation self-healing
    "broker-wave": "add_brokers/demote_brokers/remove_brokers",
    "partition-change": None,
}

#: per-family quality envelope: goal name -> (mult, add) bound applied
#: against the SAME cluster's clean converged baseline —
#: ``after[goal] <= clean[goal] * mult + add``. ``"*"`` is the default
#: for every soft goal the summary reports; per-goal entries override.
#: Hard tiers are not listed: they are gated by verification itself
#: (require_hard_zero — a window that ships hard violations is already a
#: failed window). The bounds are deliberately generous on the
#: distribution tiers for destructive families (k dead brokers of 20
#: concentrate the surviving load — a perfectly healed cluster is
#: legitimately less balanced than the clean one) and tight on the
#: metrics-only family (a skew spike re-balanced at warm budget should
#:  land near the clean frontier).
ENVELOPES: dict[str, dict[str, tuple[float, float]]] = {
    "broker-failures": {"*": (3.0, 64.0)},
    "disk-evacuation": {"*": (3.0, 64.0)},
    "hot-skew": {"*": (2.0, 32.0)},
    # TopicReplicaDistribution's per-topic spread TARGET moves when the
    # broker set grows/shrinks (ceil(members/B) changes for every
    # topic), so the wave family's TRD bound is wider than its usage
    # bounds — the violations jump reflects the new target, not damage
    # the optimizer failed to heal
    "broker-wave": {"*": (3.0, 64.0),
                    "TopicReplicaDistributionGoal": (5.0, 128.0)},
    "partition-change": {"*": (2.0, 48.0)},
}


@dataclasses.dataclass(frozen=True)
class ScenarioOptions:
    """Corpus knobs (config ``optimizer.scenario.*`` / env
    ``CCX_SCENARIO_*`` — the bench applies the env twins)."""

    #: generator seed (``optimizer.scenario.seed``): the whole corpus is
    #: a pure function of (base arrays, seed, windows)
    seed: int = 7
    #: windows per family (``optimizer.scenario.windows``)
    windows: int = 4
    #: families to emit (``optimizer.scenario.families``)
    families: tuple[str, ...] = FAMILIES

    @classmethod
    def from_config(cls, config) -> "ScenarioOptions":
        """Read the ``optimizer.scenario.*`` keys off a
        CruiseControlConfig (the facade/tests construction path)."""
        fams = tuple(config["optimizer.scenario.families"]) or FAMILIES
        unknown = [f for f in fams if f not in FAMILIES]
        if unknown:
            raise ValueError(
                f"unknown scenario families {unknown}; one of {FAMILIES}"
            )
        return cls(
            seed=config["optimizer.scenario.seed"],
            windows=config["optimizer.scenario.windows"],
            families=fams,
        )


@dataclasses.dataclass(frozen=True)
class ScenarioWindow:
    """One emitted window: the FULL dense arrays dict (the bench
    delta-encodes consecutive windows for the wire) plus bookkeeping."""

    label: str
    arrays: dict
    #: True when a non-metric field changed vs the previous window (the
    #: registry rebuild path; False = delta-graftable metrics window)
    structural: bool


# ----- program-shape key -----------------------------------------------------


def _bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def shape_key(arrays: dict) -> tuple:
    """The compiled-program shape family of a dense snapshot: what
    ``build_model`` pads to plus the pow2 ``max_partitions_per_topic``
    bucket that keys every search program. Two snapshots with equal keys
    share ONE compiled program set (the zero-compile contract)."""
    assignment = np.asarray(arrays["assignment"])
    P, R = assignment.shape
    B = np.asarray(arrays["broker_rack"]).shape[0]
    D = np.asarray(arrays["disk_capacity"]).shape[1]
    topic = np.asarray(arrays["partition_topic"])
    T = int(topic.max(initial=0)) + 1
    tml = arrays.get("topic_min_leaders")
    if tml is not None:
        T = max(T, np.asarray(tml).shape[0])
    maxpt = max(int(np.bincount(topic, minlength=T).max(initial=1)), 1)
    return (
        _bucket(P, 64),
        _bucket(B, 8),
        R,
        D,
        _bucket(T, 4),
        max(1 << (maxpt - 1).bit_length(), 8),
        int(arrays.get("num_racks") or 1),
    )


# ----- generation ------------------------------------------------------------


def generate(family: str, base_arrays: dict,
             opts: ScenarioOptions = ScenarioOptions()) -> list[ScenarioWindow]:
    """The family's seeded window sequence against a converged base.

    ``base_arrays`` is the dense ``model_to_arrays`` dict of the APPLIED
    clean state (the cold proposal's placement written back — what the
    cluster looks like the moment before the event). Windows are
    cumulative: window i's arrays build on window i-1's, exactly like
    the delta stream a live monitor would produce. Raises ``KeyError``
    on an unknown family and ``ValueError`` when the base has no
    headroom for the family inside its padded buckets (the generator
    never silently emits a bucket-crossing window)."""
    gen = _GENERATORS.get(family)
    if gen is None:
        raise KeyError(f"unknown scenario family {family!r}; one of {FAMILIES}")
    rng = np.random.default_rng(
        np.random.SeedSequence([opts.seed, FAMILIES.index(family)])
    )
    windows = gen(_copy_arrays(base_arrays), rng, max(opts.windows, 1))
    key0 = shape_key(base_arrays)
    for w in windows:
        key = shape_key(w.arrays)
        if key != key0:
            raise AssertionError(
                f"{family} window {w.label!r} crossed a program-shape "
                f"bucket: {key0} -> {key} — the zero-compile contract "
                "requires the generator to stay inside the base's buckets"
            )
    return windows


def _copy_arrays(arrays: dict) -> dict:
    return {
        k: (np.array(v) if isinstance(v, np.ndarray) else v)
        for k, v in arrays.items()
    }


def _alive_idx(arrays: dict) -> np.ndarray:
    return np.nonzero(np.asarray(arrays["broker_alive"], bool))[0]


def _racks_of(arrays: dict) -> np.ndarray:
    return np.asarray(arrays["broker_rack"])


def _gen_broker_failures(arrays, rng, n_windows) -> list[ScenarioWindow]:
    """Cascading failures: one MORE broker dies per window, chosen to
    spread across distinct racks first (a rack-correlated cascade is the
    adversarial shape rack-aware goals exist for)."""
    racks = _racks_of(arrays)
    alive = list(_alive_idx(arrays))
    rng.shuffle(alive)
    # distinct racks first, then wrap
    order: list[int] = []
    seen_racks: set[int] = set()
    for b in list(alive):
        if int(racks[b]) not in seen_racks:
            order.append(b)
            seen_racks.add(int(racks[b]))
    order += [b for b in alive if b not in order]
    # never kill more than half the alive set: the scenario is damage,
    # not an unsatisfiable cluster (capacity headroom is ~2.5x) — and
    # the corpus never silently truncates (a shorter family would slip
    # into the same ledger trend group as full rounds)
    kmax = max(len(alive) // 2, 1)
    if n_windows > kmax:
        raise ValueError(
            f"broker-failures: base supports at most {kmax} cascade "
            f"windows (half the alive set); asked for {n_windows}"
        )
    out = []
    for i in range(n_windows):
        dead = order[i]
        ba = np.array(arrays["broker_alive"], bool)
        ba[dead] = False
        arrays["broker_alive"] = ba
        out.append(ScenarioWindow(
            label=f"kill-broker-{int(dead)} (cascade {i + 1})",
            arrays=_copy_arrays(arrays), structural=True,
        ))
    return out


#: the disk-fill ramp: the victim's DISK capacity per window, as a
#: fraction of its usage at the clean base. Against the analyzer's 0.8
#: capacity threshold, window 1 forces ~28 % of the victim's stored
#: bytes off and each later window another ~8-10 % — the progressive
#: fill a retention miss actually looks like. (A NEW fully-full victim
#: per window was measured unsatisfiable for the cold pipeline too at
#: B3: shedding >50 % of a big broker repeatedly while the cluster
#: tightens outruns the repair sweep budget — the scenario must be
#: adversarial, not impossible.)
_DISK_FULL_RAMP = (0.9, 0.78, 0.68, 0.6)


def _broker_disk_usage(arrays: dict) -> np.ndarray:
    """f64[B] — DISK bytes hosted per broker under the snapshot's
    placement (role-resolved: leader slots take leader_load, the rest
    follower_load)."""
    assignment = np.asarray(arrays["assignment"])
    leader_slot = np.asarray(arrays["leader_slot"])
    B = np.asarray(arrays["broker_rack"]).shape[0]
    lead_d = np.asarray(arrays["leader_load"], np.float64)[3]
    fol_d = np.asarray(arrays["follower_load"], np.float64)[3]
    P, R = assignment.shape
    is_lead = np.arange(R)[None, :] == leader_slot[:, None]
    load = np.where(is_lead, lead_d[:, None], fol_d[:, None])
    usage = np.zeros(B)
    valid = assignment >= 0
    np.add.at(usage, assignment[valid], load[valid])
    return usage


def _gen_disk_evacuation(arrays, rng, n_windows) -> list[ScenarioWindow]:
    """Full-disk evacuation: ONE victim broker's disk progressively
    FILLS — its DISK capacity ramps down below what it hosted at the
    clean base (a log-retention miss, a compaction backlog), so each
    window the capacity repair must evacuate another slice of stored
    bytes to get back under the analyzer's capacity line. Exercises the
    capacity-shedding damage class (vs broker-failures' dead-broker
    class) and works on single-disk bases."""
    alive = list(_alive_idx(arrays))
    rng.shuffle(alive)
    victim = int(alive[0])
    usage0 = _broker_disk_usage(arrays)[victim]
    out = []
    for i in range(n_windows):
        # past the pinned ramp the disk keeps filling gently (a repeated
        # final factor would emit byte-identical windows — empty deltas
        # counted as recovery windows)
        if i < len(_DISK_FULL_RAMP):
            frac = _DISK_FULL_RAMP[i]
        else:
            frac = _DISK_FULL_RAMP[-1] * 0.95 ** (
                i - len(_DISK_FULL_RAMP) + 1
            )
        cap = np.array(arrays["broker_capacity"], np.float32)
        new_cap = np.float32(max(usage0 * frac, 1.0))
        scale = new_cap / max(float(cap[3, victim]), 1e-9)
        cap[3, victim] = new_cap
        arrays["broker_capacity"] = cap
        # JBOD invariant: broker DISK capacity == sum of its disks
        dc = np.array(arrays["disk_capacity"], np.float32)
        dc[victim, :] *= np.float32(scale)
        arrays["disk_capacity"] = dc
        out.append(ScenarioWindow(
            label=f"disk-fill-broker-{victim} (cap {frac:g}x base usage)",
            arrays=_copy_arrays(arrays), structural=True,
        ))
    return out


#: the hot-skew ramp: spike factors per window relative to the BASE
#: loads (not cumulative products — the last window is the partial
#: recovery that proves the warm loop re-balances back down too)
_SKEW_RAMP = (2.0, 4.0, 8.0, 2.0)


def _gen_hot_skew(arrays, rng, n_windows) -> list[ScenarioWindow]:
    """Hot-topic skew spike: the densest topic's CPU/NW loads ramp up
    then partially recover. Metrics-only by construction (loads are the
    only fields touched), so every window rides the registry's
    delta-graft fast path and the warm run's drift scan."""
    topic = np.asarray(arrays["partition_topic"])
    counts = np.bincount(topic, minlength=int(topic.max(initial=0)) + 1)
    hot_topic = int(np.argmax(counts))
    mask = topic == hot_topic
    base_lead = np.asarray(arrays["leader_load"], np.float32).copy()
    base_fol = np.asarray(arrays["follower_load"], np.float32).copy()
    # CPU / NW_IN / NW_OUT spike; DISK stays (a consumer storm moves
    # bytes and cycles, not stored data) — rows 0..2 of RES=4
    rows = (0, 1, 2)
    out = []
    for i in range(n_windows):
        # beyond one ramp cycle the spike amplifies per cycle: a bare
        # modulo would make window 5 repeat window 4's factor exactly
        # (ramp ends and restarts at x2) — a byte-identical window whose
        # empty delta would count as a recovery window
        f = _SKEW_RAMP[i % len(_SKEW_RAMP)] * (
            1.0 + 0.25 * (i // len(_SKEW_RAMP))
        )
        lead = base_lead.copy()
        fol = base_fol.copy()
        for r in rows:
            lead[r, mask] *= f
            fol[r, mask] *= f
        arrays["leader_load"] = lead
        arrays["follower_load"] = fol
        out.append(ScenarioWindow(
            label=f"hot-topic-{hot_topic} x{f:g}",
            arrays=_copy_arrays(arrays), structural=False,
        ))
    return out


def _gen_broker_wave(arrays, rng, n_windows) -> list[ScenarioWindow]:
    """Capacity wave: two add windows (new brokers join, empty and
    marked ``broker_new``), one demote window (ONE incumbent loses
    leadership eligibility per window), one remove window (one
    incumbent marked dead for evacuation) — the add/demote/remove verb
    chain as one cumulative event, inside the padded B bucket."""
    B = int(np.asarray(arrays["broker_rack"]).shape[0])
    Bp = _bucket(B, 8)
    head = Bp - B
    n_add = min(max(head // 2, 1), 4) if head else 0
    if head == 0:
        raise ValueError(
            "broker-wave needs B-bucket headroom; base is exactly at its "
            f"pow2 bucket ({B})"
        )
    racks = _racks_of(arrays)
    num_racks = int(arrays.get("num_racks") or int(racks.max()) + 1)
    out = []
    plan = ["add", "add", "demote", "remove"]
    added_total = 0
    alive0 = list(_alive_idx(arrays))
    rng.shuffle(alive0)
    # disjoint victim pools walked by pointer, so every window changes
    # state (a re-demote/re-remove of the same broker would be an empty
    # delta counted as a recovery window); ONE broker per demote — a
    # partition whose WHOLE replica set is demoted has no legal leader
    # without a replica move, so real demotes roll one broker at a time
    # (replica sets never duplicate a broker, making a single demote
    # always healable by a leadership transfer). Removals are bounded
    # to a third of the alive set: the wave is damage, not an
    # unsatisfiable cluster.
    demote_pool = alive0[0::2]
    remove_pool = alive0[1::2][: max(len(alive0) // 3, 1)]
    di = ri = 0
    for i in range(n_windows):
        step = plan[i % len(plan)]
        if step == "add" and added_total + n_add > head:
            step = "demote"  # B bucket full: the wave keeps rolling
        if step == "demote" and di >= len(demote_pool):
            step = "remove"
        if step == "remove" and ri >= len(remove_pool):
            step = "demote" if di < len(demote_pool) else None
        if step == "add":
            arrays = _append_brokers(arrays, n_add, num_racks)
            added_total += n_add
            label = f"add-{n_add}-brokers (wave {i + 1})"
        elif step == "demote":
            excl = np.array(arrays["broker_excl_leadership"], bool)
            victim = demote_pool[di]
            di += 1
            excl[victim] = True
            arrays["broker_excl_leadership"] = excl
            label = f"demote-broker-{int(victim)}"
        elif step == "remove":
            ba = np.array(arrays["broker_alive"], bool)
            victim = remove_pool[ri]
            ri += 1
            ba[victim] = False
            arrays["broker_alive"] = ba
            label = f"remove-broker-{int(victim)}"
        else:
            raise ValueError(
                f"broker-wave: base supports only {i} meaningful "
                f"windows (add headroom, demote and removal pools all "
                f"exhausted); asked for {n_windows}"
            )
        out.append(ScenarioWindow(
            label=label, arrays=_copy_arrays(arrays), structural=True,
        ))
    return out


def _append_brokers(arrays: dict, n: int, num_racks: int) -> dict:
    """Grow every B-axis array by ``n`` fresh brokers: empty, alive,
    ``broker_new``, mean capacity, racks striped round-robin, each on
    its own fresh host."""
    rack0 = np.asarray(arrays["broker_rack"])
    B = rack0.shape[0]
    cap = np.asarray(arrays["broker_capacity"], np.float32)
    new_rack = (np.arange(n) + B) % num_racks
    host0 = np.asarray(arrays["broker_host"])
    new_host = host0.max(initial=-1) + 1 + np.arange(n)
    mean_cap = cap.mean(axis=1, keepdims=True)
    arrays["broker_capacity"] = np.concatenate(
        [cap, np.tile(mean_cap, (1, n)).astype(np.float32)], axis=1
    )
    arrays["broker_rack"] = np.concatenate(
        [rack0, new_rack.astype(rack0.dtype)]
    )
    arrays["broker_host"] = np.concatenate(
        [host0, new_host.astype(host0.dtype)]
    )
    for field, fill in (
        ("broker_alive", True), ("broker_new", True),
        ("broker_excl_replicas", False), ("broker_excl_leadership", False),
    ):
        a = np.asarray(arrays[field], bool)
        arrays[field] = np.concatenate([a, np.full(n, fill, bool)])
    dc = np.asarray(arrays["disk_capacity"], np.float32)
    D = dc.shape[1]
    arrays["disk_capacity"] = np.concatenate(
        [dc, np.tile(mean_cap[3] / D, (n, D)).astype(np.float32)], axis=0
    )
    da = np.asarray(arrays["disk_alive"], bool)
    arrays["disk_alive"] = np.concatenate(
        [da, np.ones((n, D), bool)], axis=0
    )
    return arrays


def _gen_partition_change(arrays, rng, n_windows) -> list[ScenarioWindow]:
    """Partition-count growth (arxiv 2205.09415's elasticity event): a
    mid-sized topic gains partitions each window, placed controller-
    style — rack-striped round-robin over alive brokers, leader slot 0,
    per-partition loads = the topic's per-resource median — all inside
    the padded P bucket AND the pow2 max-partitions-per-topic bucket
    (the program-shape contract)."""
    topic = np.asarray(arrays["partition_topic"])
    P = topic.shape[0]
    Pp = _bucket(P, 64)
    T = int(topic.max(initial=0)) + 1
    counts = np.bincount(topic, minlength=T)
    maxpt = max(int(counts.max(initial=1)), 1)
    maxpt_bucket = max(1 << (maxpt - 1).bit_length(), 8)
    p_head = Pp - P
    if p_head <= 0:
        raise ValueError(
            "partition-change needs P-bucket headroom; base is exactly "
            f"at its pow2 bucket ({P})"
        )
    # any topic may grow to the GLOBAL pow2 max-members bucket without
    # re-keying the programs (the bucket is a capacity); pick the topic
    # with the most bucket headroom (tie: the larger topic — the
    # realistic "split the big topic" event) and size the per-window
    # growth to both the P-bucket and that topic's headroom
    cands = [t for t in range(T) if counts[t] > 0]
    if not cands:
        raise ValueError("partition-change: base has no populated topics")
    grow_topic = int(max(
        cands, key=lambda t: (maxpt_bucket - counts[t], counts[t])
    ))
    headroom = int(maxpt_bucket - counts[grow_topic])
    # NO floor here: flooring at 1 would let total growth overrun a
    # small P-bucket headroom and trip the internal bucket assertion —
    # insufficient headroom must be THIS documented error instead
    per_window = min(
        p_head // max(n_windows, 1),
        headroom // max(n_windows, 1),
    )
    if per_window < 1:
        raise ValueError(
            "partition-change: cannot grow at least one partition per "
            f"window inside the buckets (P headroom {p_head}, topic "
            f"member-bucket headroom {headroom}, {n_windows} windows)"
        )
    out = []
    for i in range(n_windows):
        arrays = _append_partitions(arrays, grow_topic, per_window, rng)
        out.append(ScenarioWindow(
            label=f"grow-topic-{grow_topic}+{per_window} (window {i + 1})",
            arrays=_copy_arrays(arrays), structural=True,
        ))
    return out


def _append_partitions(arrays: dict, topic_id: int, n: int, rng) -> dict:
    """Controller-style creation of ``n`` partitions for ``topic_id``."""
    assignment = np.asarray(arrays["assignment"])
    P, R = assignment.shape
    topic = np.asarray(arrays["partition_topic"])
    mask = topic == topic_id
    # replication factor: the topic's modal live-slot count
    rf = int(np.round((assignment[mask] >= 0).sum(axis=1).mean())) or 1
    rf = max(min(rf, R), 1)
    alive = np.nonzero(
        np.asarray(arrays["broker_alive"], bool)
        & ~np.asarray(arrays["broker_excl_replicas"], bool)
    )[0]
    # controller-style rack-aware spread: slot k of partition p takes
    # rack (rot + p + k) mod NR — replica sets are rack-distinct while
    # rf <= NR — and round-robins brokers within the rack; a broker is
    # never doubled within one partition
    by_rack: dict[int, list[int]] = {}
    rack_of = np.asarray(arrays["broker_rack"])
    for b in alive:
        by_rack.setdefault(int(rack_of[b]), []).append(int(b))
    rack_ids = sorted(by_rack)
    NR = len(rack_ids)
    rot = int(rng.integers(0, NR))
    new_assign = np.full((n, R), -1, np.int32)
    for p in range(n):
        chosen: list[int] = []
        k = 0
        while len(chosen) < rf and k < rf * NR * 4:
            r = rack_ids[(rot + p + k) % NR]
            lst = by_rack[r]
            b = lst[((p + k) // NR) % len(lst)]
            if b not in chosen:
                chosen.append(b)
            k += 1
        new_assign[p, : len(chosen)] = chosen
    arrays["assignment"] = np.concatenate([assignment, new_assign])
    arrays["leader_slot"] = np.concatenate(
        [np.asarray(arrays["leader_slot"]), np.zeros(n, np.int32)]
    )
    rd = np.asarray(arrays["replica_disk"])
    new_rd = np.where(new_assign >= 0, 0, -1).astype(rd.dtype)
    arrays["replica_disk"] = np.concatenate([rd, new_rd])
    arrays["partition_topic"] = np.concatenate(
        [topic, np.full(n, topic_id, topic.dtype)]
    )
    arrays["partition_immovable"] = np.concatenate(
        [np.asarray(arrays["partition_immovable"], bool),
         np.zeros(n, bool)]
    )
    for field in ("leader_load", "follower_load"):
        load = np.asarray(arrays[field], np.float32)
        med = np.median(load[:, mask], axis=1, keepdims=True) if mask.any() \
            else load.mean(axis=1, keepdims=True)
        arrays[field] = np.concatenate(
            [load, np.tile(med, (1, n)).astype(np.float32)], axis=1
        )
    return arrays


_GENERATORS = {
    "broker-failures": _gen_broker_failures,
    "disk-evacuation": _gen_disk_evacuation,
    "hot-skew": _gen_hot_skew,
    "broker-wave": _gen_broker_wave,
    "partition-change": _gen_partition_change,
}


# ----- envelope --------------------------------------------------------------


def goals_after(goal_summary: list[dict]) -> dict[str, float]:
    """goal name -> violationsAfter, soft goals only, from a result's
    ``goalSummary`` block (hard tiers are verification's jurisdiction)."""
    return {
        g["goal"]: float(g["violationsAfter"])
        for g in goal_summary or ()
        if not g.get("hard")
    }


def check_envelope(family: str, clean: dict[str, float],
                   after: dict[str, float]) -> list[str]:
    """Envelope failures for one recovered window: every soft goal's
    violations must land within ``clean * mult + add`` of the clean
    converged baseline (``ENVELOPES[family]``; ``"*"`` is the family
    default, per-goal entries override). Returns [] when inside."""
    env = ENVELOPES.get(family)
    if env is None:
        raise KeyError(f"no envelope pinned for family {family!r}")
    default = env.get("*")
    failures = []
    for goal, got in sorted(after.items()):
        mult, add = env.get(goal, default) or (None, None)
        if mult is None:
            continue
        bound = clean.get(goal, 0.0) * mult + add
        if got > bound:
            failures.append(
                f"{goal}: {got:g} > envelope {bound:g} "
                f"(clean {clean.get(goal, 0.0):g} x{mult:g} + {add:g})"
            )
    return failures
