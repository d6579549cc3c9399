"""The plain reference: a proposal applied to a snapshot, the broker
aggregates, the goal stack's per-goal violations and costs, and the cluster
statistics, in NumPy.

It follows the goal definitions of upstream Cruise Control's analyzer as the
system scores them (violations count offenders; costs are normalised hinge
sums) and imports nothing of the system. Sums run in float64 from the
snapshot's float32 loads. ``precision="bf16"`` is the control: the same
arithmetic with the loads and the aggregates rounded to bfloat16 and
carried in float32, which is what a lower-precision scoring path would
report.

Two properties of the system's scoring are part of the definitions here:
TopicReplicaDistribution's cost is normalised by the mean over the topic
axis padded to a power of two (at least 4) with empty topics counting 1, and
every average runs over valid, alive brokers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.reference.generator import CPU, DISK, NUM_RESOURCES, NW_IN, NW_OUT

#: the resource of each capacity and usage-distribution goal
CAPACITY_GOALS = {
    "CpuCapacityGoal": CPU, "NetworkInboundCapacityGoal": NW_IN,
    "NetworkOutboundCapacityGoal": NW_OUT, "DiskCapacityGoal": DISK,
}
USAGE_GOALS = {
    "CpuUsageDistributionGoal": CPU, "NetworkInboundUsageDistributionGoal": NW_IN,
    "NetworkOutboundUsageDistributionGoal": NW_OUT, "DiskUsageDistributionGoal": DISK,
}
#: upstream ClusterModelStats keys of the load rows
STAT_RESOURCES = {"cpu": CPU, "networkInbound": NW_IN, "networkOutbound": NW_OUT, "disk": DISK}


def bucket(n: int, minimum: int) -> int:
    """Next power of two >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class DiffFault(ValueError):
    """A proposal row that cannot be applied to the snapshot it was made for."""


def apply_diff(snap: dict, cols: dict) -> tuple[dict, int]:
    """(the placement of ``snap`` with every row of the columnar diff
    ``cols`` applied, the count of rows that do not fit the snapshot).
    A row fits when its partition exists, its old replicas and old leader
    are the snapshot's, and its new leader is one of its new replicas on
    valid brokers. Rows that do not fit are not applied."""
    a = snap["assignment"].copy()
    lead = snap["leader_slot"].copy()
    P, R = a.shape
    B = snap["broker_capacity"].shape[1]
    part = np.asarray(cols["partition"], np.int64)
    n = part.shape[0]
    if n == 0:
        return {"assignment": a, "leader_slot": lead}, 0
    old = np.asarray(cols["oldReplicas"], np.int64)
    new = np.asarray(cols["newReplicas"], np.int64)
    old_leader = np.asarray(cols["oldLeader"], np.int64)
    new_leader = np.asarray(cols["newLeader"], np.int64)
    ok = (part >= 0) & (part < P) & (old.shape[1] == R) & (new.shape[1] == R)
    p = np.where(ok, part, 0)
    cur = a[p]
    cur_leader = cur[np.arange(n), np.clip(lead[p], 0, R - 1)]
    ok &= (old == cur).all(1) & (old_leader == cur_leader)
    ok &= ((new == -1) | ((new >= 0) & (new < B))).all(1) & (new >= 0).any(1)
    slot = np.argmax(new == new_leader[:, None], axis=1)
    ok &= (new[np.arange(n), slot] == new_leader) & (new_leader >= 0)
    if np.unique(part[ok]).size != int(ok.sum()):
        raise DiffFault("a partition appears twice in the proposal")
    a[part[ok]] = new[ok]
    lead[part[ok]] = slot[ok]
    return {"assignment": a, "leader_slot": lead}, int(n - ok.sum())


@dataclasses.dataclass
class Aggregates:
    broker_load: np.ndarray          # [RES, B]
    replica_count: np.ndarray        # [B]
    leader_count: np.ndarray         # [B]
    potential_nw_out: np.ndarray     # [B]
    leader_bytes_in: np.ndarray      # [B]
    topic_replica_count: np.ndarray  # [T, B]
    topic_leader_count: np.ndarray   # [T, B]


def aggregates(snap: dict, placement: dict, precision: str = "fp64") -> Aggregates:
    """Per-broker loads and counts of ``placement`` on ``snap``'s loads."""
    a = placement["assignment"]
    P, R = a.shape
    B = snap["broker_capacity"].shape[1]
    T = int(snap["partition_topic"].max(initial=0)) + 1
    valid = a >= 0
    is_leader = (np.arange(R)[None, :] == placement["leader_slot"][:, None]) & valid
    ll = np.asarray(snap["leader_load"], np.float32)
    fl = np.asarray(snap["follower_load"], np.float32)
    if precision == "bf16":
        ll, fl = round_bf16(ll), round_bf16(fl)
    b = a[valid]
    lead_b = a[is_leader]
    p_of = np.broadcast_to(np.arange(P)[:, None], (P, R))[valid]
    p_lead = np.broadcast_to(np.arange(P)[:, None], (P, R))[is_leader]
    role = np.where(is_leader[valid], 1.0, 0.0)

    def bsum(idx, w) -> np.ndarray:
        return np.bincount(idx, weights=w, minlength=B).astype(np.float64)

    load = np.stack([
        bsum(b, role * ll[r, p_of] + (1.0 - role) * fl[r, p_of]) for r in range(NUM_RESOURCES)
    ])
    topic = snap["partition_topic"]
    out = Aggregates(
        broker_load=load,
        replica_count=np.bincount(b, minlength=B).astype(np.float64),
        leader_count=np.bincount(lead_b, minlength=B).astype(np.float64),
        potential_nw_out=bsum(b, ll[NW_OUT, p_of].astype(np.float64)),
        leader_bytes_in=bsum(lead_b, ll[NW_IN, p_lead].astype(np.float64)),
        topic_replica_count=np.bincount(topic[p_of] * B + b, minlength=T * B)
        .reshape(T, B).astype(np.float64),
        topic_leader_count=np.bincount(topic[p_lead] * B + lead_b, minlength=T * B)
        .reshape(T, B).astype(np.float64),
    )
    if precision == "bf16":
        for f in ("broker_load", "potential_nw_out", "leader_bytes_in"):
            setattr(out, f, round_bf16(getattr(out, f).astype(np.float32)).astype(np.float64))
    return out


def _safe(x):
    return np.where(x > 0, x, 1.0)


def _band(values, alive, avg, t):
    over = np.clip(values - avg * t, 0, None)
    under = np.clip(avg * (2.0 - t) - values, 0, None)
    pen = np.where(alive, over + under, 0.0)
    return float((pen > 0).sum()), float(pen.sum() / _safe(avg))


def _count_band(counts, alive, total, n, t):
    """``_band`` of integer counts. Whether a count lies outside the band
    is decided as the system decides it, in float32: 2000 leaders over 18
    brokers put the lower edge at exactly 100 in exact arithmetic, and a
    broker with 100 leaders is inside or outside by the last bit."""
    avg32 = np.float32(total) / np.float32(n)
    c32 = np.float32(counts)
    out32 = np.where(alive, np.clip(c32 - avg32 * np.float32(t), 0, None)
                     + np.clip(avg32 * np.float32(2.0 - t) - c32, 0, None), np.float32(0))
    pen = _band(counts, alive, total / n, t)[1]
    return float((out32 > 0).sum()), pen


def goal_stack(snap: dict, placement: dict, goals: list[str], thresholds: dict,
               precision: str = "fp64") -> dict[str, tuple[float, float]]:
    """goal -> (violations, cost) of ``placement`` on ``snap``."""
    agg = aggregates(snap, placement, precision)
    a, lead = placement["assignment"], placement["leader_slot"]
    P, R = a.shape
    B = snap["broker_capacity"].shape[1]
    cap = np.asarray(snap["broker_capacity"], np.float64)
    ok = np.asarray(snap["broker_alive"], bool)
    can_lead = ok & ~np.asarray(snap["broker_excl_leadership"], bool)
    n_ok = max(int(ok.sum()), 1)
    valid = a >= 0
    safe_a = np.clip(a, 0, B - 1)
    cap_thr = thresholds["capacity_threshold"]
    out: dict[str, tuple[float, float]] = {}

    def put(name, n, cost):
        out[name] = (float(n), float(cost))

    for name in goals:
        if name == "StructuralFeasibility":
            on_dead = (valid & ~ok[safe_a]).sum()
            d = np.clip(snap["replica_disk"], 0, snap["disk_alive"].shape[1] - 1)
            on_dead_disk = (valid & ok[safe_a] & (snap["replica_disk"] >= 0)
                            & ~snap["disk_alive"][safe_a, d]).sum()
            lead_b = safe_a[np.arange(P), np.clip(lead, 0, R - 1)]
            excl = snap["broker_excl_leadership"][lead_b].sum()
            # every pair of slots of one row on one broker
            dup = sum(int((valid[:, i] & valid[:, j] & (a[:, i] == a[:, j])).sum())
                      for i in range(R) for j in range(i + 1, R))
            n = on_dead + on_dead_disk + excl + dup
            put(name, n, n)
        elif name == "RackAwareGoal":
            racks = np.where(valid, snap["broker_rack"][safe_a], -1 - np.arange(R)[None, :])
            s = np.sort(racks, axis=1)
            n = ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).sum()
            put(name, n, n)
        elif name == "MinTopicLeadersPerBrokerGoal":
            flagged = np.asarray(snap["topic_min_leaders"], bool)
            T = agg.topic_leader_count.shape[0]
            flagged = np.pad(flagged, (0, max(T - flagged.size, 0)))[:T]
            k = thresholds["min_topic_leaders_per_broker"]
            deficit = np.clip(k - agg.topic_leader_count, 0, None)
            n = np.where(flagged[:, None] & can_lead[None, :], deficit, 0).sum()
            put(name, n, n)
        elif name == "ReplicaCapacityGoal":
            mx = thresholds["max_replicas_per_broker"]
            over = np.where(ok, np.clip(agg.replica_count - mx, 0, None), 0.0)
            put(name, (over > 0).sum(), over.sum() / mx)
        elif name in CAPACITY_GOALS:
            r = CAPACITY_GOALS[name]
            c = cap[r] * cap_thr[r]
            excess = np.where(ok, np.clip(agg.broker_load[r] - c, 0, None), 0.0)
            put(name, (excess > 0).sum(), (excess / _safe(c)).sum())
        elif name == "PotentialNwOutGoal":
            c = cap[NW_OUT] * cap_thr[NW_OUT]
            excess = np.where(ok, np.clip(agg.potential_nw_out - c, 0, None), 0.0)
            put(name, (excess > 0).sum(), (excess / _safe(c)).sum())
        elif name in USAGE_GOALS:
            r = USAGE_GOALS[name]
            load = np.where(ok, agg.broker_load[r], 0.0)
            avg_util = load.sum() / _safe(np.where(ok, cap[r], 0.0).sum())
            util = load / _safe(cap[r])
            n, cost = _band(util, ok, avg_util, thresholds["balance_threshold"][r])
            if not avg_util > thresholds["low_utilization_threshold"][r]:
                n, cost = 0.0, 0.0
            put(name, n, cost)
        elif name == "ReplicaDistributionGoal":
            put(name, *_count_band(agg.replica_count, ok, agg.replica_count.sum(), n_ok,
                                   thresholds["replica_balance_threshold"]))
        elif name == "LeaderReplicaDistributionGoal":
            put(name, *_count_band(agg.leader_count, can_lead, agg.leader_count.sum(),
                                   max(int(can_lead.sum()), 1),
                                   thresholds["leader_balance_threshold"]))
        elif name == "LeaderBytesInDistributionGoal":
            lbi = np.where(can_lead, agg.leader_bytes_in, 0.0)
            avg = lbi.sum() / max(int(can_lead.sum()), 1)
            put(name, *_band(lbi, can_lead, avg,
                             thresholds["leader_bytes_in_balance_threshold"]))
        elif name == "TopicReplicaDistributionGoal":
            trc = np.where(ok[None, :], agg.topic_replica_count, 0.0)
            totals = trc.sum(1)
            avg = totals / n_ok
            t = thresholds["topic_replica_balance_threshold"]
            # the band's integer edges as the system computes them, in
            # float32: at 10 replicas a broker 10 * (2 - 1.1) is 9 there
            # and 8.999999999999998 in float64
            avg32 = np.float32(totals) / np.float32(n_ok)
            upper = np.ceil(avg32 * np.float32(t)).astype(np.float64)[:, None]
            lower = np.floor(avg32 * np.float32(2.0 - t)).astype(np.float64)[:, None]
            c = agg.topic_replica_count
            pen = np.clip(c - upper, 0, None) + np.clip(lower - c, 0, None)
            pen = np.where(ok[None, :], pen, 0.0)
            t_pad = bucket(totals.size, 4)
            norm = (np.clip(avg, 1.0, None).sum() + (t_pad - totals.size)) / t_pad
            put(name, (pen > 0).sum(), pen.sum() / (norm if norm > 0 else 1.0))
        elif name == "PreferredLeaderElectionGoal":
            b0 = a[:, 0]
            eligible = (b0 >= 0) & can_lead[np.clip(b0, 0, B - 1)]
            n = (eligible & (lead != 0)).sum()
            put(name, n, n / max(agg.leader_count.sum(), 1.0))
        else:
            raise KeyError(f"the reference has no goal {name!r}")
    return out


def _dist(v: np.ndarray) -> tuple[float, float, float, float]:
    if v.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    return float(v.mean()), float(v.std()), float(v.min()), float(v.max())


def cluster_stats(snap: dict, placement: dict, precision: str = "fp64") -> dict:
    """Upstream ClusterModelStats over alive brokers:
    ``{"AVG"|"STD"|"MIN"|"MAX": {key: value}}`` and its ``metadata``."""
    agg = aggregates(snap, placement, precision)
    ok = np.asarray(snap["broker_alive"], bool)
    rows = {k: agg.broker_load[r][ok] for k, r in STAT_RESOURCES.items()}
    rows["potentialNwOut"] = agg.potential_nw_out[ok]
    rows["replicas"] = agg.replica_count[ok]
    rows["leaderReplicas"] = agg.leader_count[ok]
    stats = {s: {} for s in ("AVG", "STD", "MIN", "MAX")}
    for k, v in rows.items():
        for s, x in zip(("AVG", "STD", "MIN", "MAX"), _dist(v)):
            stats[s][k] = x
    cells = agg.topic_replica_count[:, ok]
    has = cells.sum(1) > 0
    per = cells[has]
    for s, f in (("AVG", np.mean), ("STD", np.std), ("MIN", np.min), ("MAX", np.max)):
        stats[s]["topicReplicas"] = float(f(per, axis=1).mean()) if per.size else 0.0
    hosts = np.asarray(snap["broker_host"])[ok]
    stats["metadata"] = {
        "brokers": int(ok.sum()), "hosts": int(np.unique(hosts).size),
        "replicas": int((placement["assignment"] >= 0).sum()), "topics": int(has.sum()),
        "partitions": int(placement["assignment"].shape[0]),
    }
    return stats
