"""Leader/follower load decomposition — CPU estimation coefficients.

Parity: ``model/{ModelUtils,ModelParameters,LinearRegressionModelParameters}
.java`` (SURVEY.md C6): the reference estimates a replica's CPU from its
network activity with fixed coefficients (configurable; a legacy linear-
regression training path can fit them), and derives the **follower** role's
load profile from the leader's (follower CPU ~ replication traffic only,
follower NW_OUT = 0, follower NW_IN = leader bytes-in).

These functions produce the ``leader_load`` / ``follower_load`` pair the
TensorClusterModel stores per partition (ccx.model.tensor_model), which is
how leadership transfer re-weights broker loads with no re-aggregation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ccx_torch.common.resources import Resource


@dataclasses.dataclass(frozen=True)
class CpuEstimationParams:
    """Ref MonitorConfig `*.weight.for.cpu.util` keys (SURVEY.md C6)."""

    leader_nw_in_weight: float = 0.6
    leader_nw_out_weight: float = 0.1
    follower_nw_in_weight: float = 0.3

    @classmethod
    def from_config(cls, config) -> "CpuEstimationParams":
        return cls(
            config["leader.network.inbound.weight.for.cpu.util"],
            config["leader.network.outbound.weight.for.cpu.util"],
            config["follower.network.inbound.weight.for.cpu.util"],
        )


def estimate_leader_cpu(params: CpuEstimationParams, broker_cpu: np.ndarray,
                        nw_in: np.ndarray, nw_out: np.ndarray,
                        broker_nw_in: np.ndarray, broker_nw_out: np.ndarray) -> np.ndarray:
    """Apportion measured broker CPU to a leader replica by its share of
    weighted network activity (ref ModelUtils.estimateLeaderCpuUtil)."""
    denom = (params.leader_nw_in_weight * broker_nw_in
             + params.leader_nw_out_weight * broker_nw_out)
    numer = (params.leader_nw_in_weight * nw_in
             + params.leader_nw_out_weight * nw_out)
    with np.errstate(invalid="ignore", divide="ignore"):
        share = np.where(denom > 0, numer / np.maximum(denom, 1e-12), 0.0)
    return broker_cpu * share


def follower_cpu_from_leader(params: CpuEstimationParams,
                             leader_cpu: np.ndarray,
                             leader_nw_in: np.ndarray,
                             leader_nw_out: np.ndarray) -> np.ndarray:
    """Ref ModelUtils.getFollowerCpuUtilFromLeaderLoad: follower CPU is the
    replication-fetch share of the leader's network-attributed CPU."""
    denom = (params.leader_nw_in_weight * leader_nw_in
             + params.leader_nw_out_weight * leader_nw_out)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(
            denom > 0,
            params.follower_nw_in_weight * leader_nw_in / np.maximum(denom, 1e-12),
            0.0,
        )
    return leader_cpu * ratio


class LinearRegressionModelParameters:
    """Parity: ``model/LinearRegressionModelParameters.java`` (SURVEY.md C6)
    — the legacy ``train`` path fitting the CPU coefficients from observed
    (broker CPU, NW_IN, NW_OUT) triples instead of using the static config
    weights. Least-squares over accumulated samples; ``to_params`` emits a
    ``CpuEstimationParams`` once enough observations arrived.
    """

    MIN_SAMPLES = 16

    def __init__(self) -> None:
        self._rows: list[tuple[float, float, float]] = []

    def add_observation(self, broker_cpu: float, nw_in: float, nw_out: float) -> None:
        self._rows.append((broker_cpu, nw_in, nw_out))

    def add_broker_samples(self, agg_values: np.ndarray, cpu_id: int,
                           in_id: int, out_id: int) -> None:
        """Ingest from a broker AggregationResult values array [B, W, M]."""
        v = agg_values.reshape(-1, agg_values.shape[-1])
        for row in v:
            if row[in_id] > 0 or row[out_id] > 0:
                self.add_observation(row[cpu_id], row[in_id], row[out_id])

    @property
    def num_observations(self) -> int:
        return len(self._rows)

    @property
    def trainable(self) -> bool:
        return len(self._rows) >= self.MIN_SAMPLES

    def fit(self) -> tuple[float, float]:
        """(nw_in_weight, nw_out_weight) such that cpu ~ a*in + b*out."""
        if not self.trainable:
            raise ValueError(
                f"need >= {self.MIN_SAMPLES} observations, have {len(self._rows)}"
            )
        rows = np.asarray(self._rows)
        coeffs, *_ = np.linalg.lstsq(rows[:, 1:], rows[:, 0], rcond=None)
        return float(max(coeffs[0], 0.0)), float(max(coeffs[1], 0.0))

    def to_params(self, follower_ratio: float = 0.5) -> CpuEstimationParams:
        a, b = self.fit()
        return CpuEstimationParams(
            leader_nw_in_weight=a,
            leader_nw_out_weight=b,
            follower_nw_in_weight=follower_ratio * a,
        )


def split_roles(params: CpuEstimationParams,
                leader_metrics: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(leader_load, follower_load) float64[RES, P] from leader-side windowed
    metrics float64[P, M] (M = partition metric def = Resource order).

    Role semantics (ref Load/ModelUtils, tensor_model docstring):
    follower NW_OUT = 0 (no consumer traffic), follower NW_IN = leader NW_IN
    (replication), DISK role-independent, follower CPU derived.
    """
    lm = np.asarray(leader_metrics, np.float64)
    leader = lm.T.copy()  # [RES, P]
    follower = leader.copy()
    follower[Resource.NW_OUT] = 0.0
    follower[Resource.CPU] = follower_cpu_from_leader(
        params, leader[Resource.CPU], leader[Resource.NW_IN],
        leader[Resource.NW_OUT],
    )
    return leader, follower
