"""Provisioner SPI — rightsizing verdicts and recommendations.

Parity: ``analyzer/ProvisionStatus``/``ProvisionRecommendation`` +
``detector/BasicProvisioner.java`` behind the ``rightsize`` endpoint
(SURVEY.md C21): given an optimization result, decide whether the cluster is
RIGHT_SIZED / UNDER_PROVISIONED / OVER_PROVISIONED and recommend broker
count changes.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from ccx_torch.common.resources import NUM_RESOURCES, Resource


class ProvisionStatus(enum.Enum):
    RIGHT_SIZED = "RIGHT_SIZED"
    UNDER_PROVISIONED = "UNDER_PROVISIONED"
    OVER_PROVISIONED = "OVER_PROVISIONED"
    UNDECIDED = "UNDECIDED"


@dataclasses.dataclass(frozen=True)
class ProvisionRecommendation:
    status: ProvisionStatus
    num_brokers_to_add: int = 0
    num_brokers_to_remove: int = 0
    reason: str = ""

    def to_json(self) -> dict:
        return {
            "status": self.status.value,
            "numBrokersToAdd": self.num_brokers_to_add,
            "numBrokersToRemove": self.num_brokers_to_remove,
            "reason": self.reason,
        }


class BasicProvisioner:
    """Default `provisioner.class` (ref BasicProvisioner): capacity-headroom
    arithmetic on the tensor model — under-provisioned when any resource's
    cluster-wide utilization exceeds its capacity threshold even if perfectly
    balanced; over-provisioned when the peak resource would still fit under
    threshold on fewer brokers."""

    def __init__(self, config=None) -> None:
        self.thresholds = {
            Resource.CPU: 0.7, Resource.NW_IN: 0.8,
            Resource.NW_OUT: 0.8, Resource.DISK: 0.8,
        }
        if config is not None:
            self.configure(config)

    def configure(self, config) -> None:
        self.thresholds = {
            Resource.CPU: config["cpu.capacity.threshold"],
            Resource.NW_IN: config["network.inbound.capacity.threshold"],
            Resource.NW_OUT: config["network.outbound.capacity.threshold"],
            Resource.DISK: config["disk.capacity.threshold"],
        }

    def rightsize(self, model) -> ProvisionRecommendation:
        alive = np.asarray(model.broker_valid & model.broker_alive)
        cap = np.asarray(model.broker_capacity)            # [RES, B]
        load = np.asarray(model.replica_load).sum(axis=(1, 2))  # total per RES
        total_cap = (cap * alive[None, :]).sum(axis=1)
        n_alive = int(alive.sum())
        if n_alive == 0:
            return ProvisionRecommendation(
                ProvisionStatus.UNDECIDED, reason="no alive brokers"
            )
        per_broker_cap = total_cap / n_alive
        worst_add = 0
        worst_remove = n_alive
        binding = None
        for r in range(NUM_RESOURCES):
            thr = self.thresholds[Resource(r)]
            usable_per_broker = per_broker_cap[r] * thr
            if usable_per_broker <= 0:
                continue
            needed = math.ceil(load[r] / usable_per_broker)
            if needed - n_alive > worst_add:
                worst_add = needed - n_alive
                binding = Resource(r)
            worst_remove = min(worst_remove, n_alive - needed)
        if worst_add > 0:
            return ProvisionRecommendation(
                ProvisionStatus.UNDER_PROVISIONED,
                num_brokers_to_add=worst_add,
                reason=f"{binding.name} demand exceeds usable capacity",
            )
        # keep one spare broker of headroom before calling it over-provisioned
        if worst_remove > 1:
            return ProvisionRecommendation(
                ProvisionStatus.OVER_PROVISIONED,
                num_brokers_to_remove=worst_remove - 1,
                reason="all resources fit under threshold on fewer brokers",
            )
        return ProvisionRecommendation(ProvisionStatus.RIGHT_SIZED)
