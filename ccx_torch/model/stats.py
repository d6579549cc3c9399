"""ClusterModelStats — summary statistics of a cluster model state.

The port's copy of the JAX package's ``model/stats.py``: the stats block of
the reference's ``model/ClusterModelStats.java`` (per-resource utilization
mean/st.dev/min/max over alive brokers, replica / leader-replica /
topic-replica distribution stats, potential nw-out), attached to every
cold ``OptimizerResult.to_json`` as its before/after blocks.

The aggregates come from ``ccx_torch.model.aggregates.broker_aggregates``:
on a CUDA model that is one launch of the aggregates kernel, then one host
copy of each field the block reads; the statistics themselves are numpy in
float64, as in the JAX package.

The JSON shape mirrors upstream's ``ClusterModelStats.getJsonStructure``:
``{"metadata": {brokers, replicas, topics}, "statistics": {AVG, STD, MIN,
MAX}}`` with the eight upstream metric keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ccx_torch.common.resources import Resource
from ccx_torch.model.aggregates import BrokerAggregates, broker_aggregates
from ccx_torch.model.tensor_model import TensorClusterModel

#: Upstream stat keys, in upstream order.
STAT_KEYS = (
    "disk",
    "cpu",
    "networkInbound",
    "networkOutbound",
    "potentialNwOut",
    "replicas",
    "leaderReplicas",
    "topicReplicas",
)

_RESOURCE_KEYS = {
    "cpu": Resource.CPU,
    "networkInbound": Resource.NW_IN,
    "networkOutbound": Resource.NW_OUT,
    "disk": Resource.DISK,
}


@dataclasses.dataclass(frozen=True)
class ClusterModelStats:
    """Summary stats over alive brokers (ref: model/ClusterModelStats.java)."""

    n_brokers: int
    n_replicas: int
    n_topics: int
    n_partitions: int
    avg: dict[str, float]
    std: dict[str, float]
    min: dict[str, float]
    max: dict[str, float]
    #: distinct hosts among alive brokers (equals n_brokers when every
    #: broker is its own host)
    n_hosts: int = 0

    def to_json(self) -> dict:
        return {
            "metadata": {
                "brokers": self.n_brokers,
                "hosts": self.n_hosts,
                "replicas": self.n_replicas,
                "topics": self.n_topics,
                "partitions": self.n_partitions,
            },
            "statistics": {
                "AVG": dict(self.avg),
                "STD": dict(self.std),
                "MIN": dict(self.min),
                "MAX": dict(self.max),
            },
        }


def _dist(values: np.ndarray) -> tuple[float, float, float, float]:
    if values.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    return (
        float(values.mean()),
        float(values.std()),
        float(values.min()),
        float(values.max()),
    )


def cluster_model_stats(
    m: TensorClusterModel, agg: BrokerAggregates | None = None
) -> ClusterModelStats:
    """Compute the stats block from a model state (one aggregate pass)."""
    if agg is None:
        agg = broker_aggregates(m)
    alive = m.broker_ok.cpu().numpy()
    loads = agg.broker_load.cpu().numpy()           # [RES, B]
    repl = agg.replica_count.cpu().numpy()
    lead = agg.leader_count.cpu().numpy()
    pot = agg.potential_nw_out.cpu().numpy()
    trc = agg.topic_replica_count.cpu().numpy()     # [T, B]

    avg: dict[str, float] = {}
    std: dict[str, float] = {}
    mn: dict[str, float] = {}
    mx: dict[str, float] = {}

    def put(key: str, values: np.ndarray) -> None:
        avg[key], std[key], mn[key], mx[key] = _dist(values)

    for key, res in _RESOURCE_KEYS.items():
        put(key, loads[res][alive])
    put("potentialNwOut", pot[alive])
    put("replicas", repl[alive].astype(np.float64))
    put("leaderReplicas", lead[alive].astype(np.float64))

    # Topic-replica distribution: per-topic stats across alive brokers,
    # averaged over topics that have replicas (empty/padding topics carry
    # no signal).
    cells = trc[:, alive].astype(np.float64)        # [T, B_alive]
    has = cells.sum(axis=1) > 0
    if has.any() and cells.shape[1] > 0:
        per_topic = cells[has]
        avg["topicReplicas"] = float(per_topic.mean(axis=1).mean())
        std["topicReplicas"] = float(per_topic.std(axis=1).mean())
        mn["topicReplicas"] = float(per_topic.min(axis=1).mean())
        mx["topicReplicas"] = float(per_topic.max(axis=1).mean())
    else:
        avg["topicReplicas"] = std["topicReplicas"] = 0.0
        mn["topicReplicas"] = mx["topicReplicas"] = 0.0

    return ClusterModelStats(
        n_brokers=int(alive.sum()),
        n_replicas=int(m.replica_valid.sum()),
        n_topics=int(has.sum()) if cells.shape[1] > 0 else 0,
        n_partitions=int(m.partition_valid.sum()),
        avg=avg,
        std=std,
        min=mn,
        max=mx,
        n_hosts=int(np.unique(m.broker_host.cpu().numpy()[alive]).size),
    )


def host_rollup(
    m: TensorClusterModel, agg: BrokerAggregates | None = None
) -> dict[int, dict[str, float]]:
    """Per-HOST aggregates over alive brokers (ref model/Host.java: a host
    aggregates its brokers' capacity and load). Keys are host ids; values
    carry summed loads, capacity, and replica/leader counts."""
    if agg is None:
        agg = broker_aggregates(m)
    alive = m.broker_ok.cpu().numpy()
    hosts = m.broker_host.cpu().numpy()
    loads = agg.broker_load.cpu().numpy()
    caps = m.broker_capacity.cpu().numpy()
    repl = agg.replica_count.cpu().numpy()
    lead = agg.leader_count.cpu().numpy()
    out: dict[int, dict[str, float]] = {}
    for h in np.unique(hosts[alive]):
        sel = alive & (hosts == h)
        row = {"brokers": float(sel.sum())}
        for key, res in _RESOURCE_KEYS.items():
            row[key] = float(loads[res][sel].sum())
            row[key + "Capacity"] = float(caps[res][sel].sum())
        row["replicas"] = float(repl[sel].sum())
        row["leaderReplicas"] = float(lead[sel].sum())
        out[int(h)] = row
    return out


def balancedness_score(stats: ClusterModelStats) -> float:
    """[0, 100] balancedness summary: 100 when every tracked distribution
    has zero spread; decays with the mean coefficient of variation across
    stat keys."""
    cvs = []
    for key in STAT_KEYS:
        a = stats.avg[key]
        if a > 1e-12:
            cvs.append(stats.std[key] / a)
    if not cvs:
        return 100.0
    return float(100.0 / (1.0 + float(np.mean(cvs))))
