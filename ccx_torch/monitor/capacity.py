"""Broker capacity resolution — the ``BrokerCapacityConfigResolver`` SPI.

Parity: ``config/BrokerCapacityConfigResolver`` + the file-based default
``BrokerCapacityConfigFileResolver`` with its three formats
``capacity.json`` / ``capacityJBOD.json`` / ``capacityCores.json``
(SURVEY.md C5, M6): a JSON list of per-broker entries, broker id ``-1`` as
the default row, DISK either a single number or a {logdir: capacity} map
(JBOD), CPU either a percentage or ``num.cores``. Units follow the
reference: DISK in MB, NW in KB/s, CPU in percent (100 = one core fully
used unless cores-mode normalizes).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ccx_torch.common.resources import NUM_RESOURCES, Resource


@dataclasses.dataclass(frozen=True)
class BrokerCapacityInfo:
    """Per-broker capacities (+ per-disk breakdown for JBOD)."""

    capacity: tuple[float, ...]            # indexed by Resource
    disk_capacities: tuple[float, ...] = ()  # per logdir, sums to capacity[DISK]
    estimated: bool = False                # True when the default row was used
    num_cores: int = 1

    def resource(self, r: Resource) -> float:
        return self.capacity[r]


class BrokerCapacityResolver:
    """SPI: resolve capacity for a broker at model-build time (ref C5)."""

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        raise NotImplementedError


DEFAULT_BROKER_ID = -1


class FileCapacityResolver(BrokerCapacityResolver):
    """Reads the reference's capacity JSON formats.

    ``{"brokerCapacities": [{"brokerId": "-1", "capacity": {"DISK": "100000",
    "CPU": "100", "NW_IN": "10000", "NW_OUT": "10000"}}, ...]}``; JBOD DISK =
    ``{"/logdir1": "50000", ...}``; cores-mode CPU = ``{"num.cores": "8"}``.
    """

    def __init__(self, path: str | None = None, config=None) -> None:
        if path is None and config is not None:
            path = config["capacity.config.file"]
        self._by_broker: dict[int, BrokerCapacityInfo] = {}
        if path:
            self._load(path)

    def configure(self, config) -> None:
        if not self._by_broker:
            self._load(config["capacity.config.file"])

    def _load(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        for entry in doc.get("brokerCapacities", []):
            broker_id = int(entry["brokerId"])
            cap = entry["capacity"]
            disk = cap.get("DISK", 0)
            if isinstance(disk, dict):  # JBOD: logdir -> capacity
                disks = tuple(float(v) for v in disk.values())
                disk_total = float(sum(disks))
            else:
                disks = (float(disk),)
                disk_total = float(disk)
            cpu = cap.get("CPU", 100.0)
            num_cores = 1
            if isinstance(cpu, dict):  # capacityCores.json mode
                num_cores = int(cpu["num.cores"])
                cpu_total = 100.0 * num_cores
            else:
                cpu_total = float(cpu)
            vec = [0.0] * NUM_RESOURCES
            vec[Resource.CPU] = cpu_total
            vec[Resource.NW_IN] = float(cap.get("NW_IN", 0))
            vec[Resource.NW_OUT] = float(cap.get("NW_OUT", 0))
            vec[Resource.DISK] = disk_total
            self._by_broker[broker_id] = BrokerCapacityInfo(
                tuple(vec), disks, estimated=False, num_cores=num_cores
            )
        if DEFAULT_BROKER_ID not in self._by_broker:
            raise ValueError(
                f"capacity file {path} has no default entry (brokerId -1)"
            )

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        info = self._by_broker.get(broker_id)
        if info is not None:
            return info
        d = self._by_broker[DEFAULT_BROKER_ID]
        return dataclasses.replace(d, estimated=True)


class StaticCapacityResolver(BrokerCapacityResolver):
    """Uniform capacities for tests/simulation."""

    def __init__(self, capacity: dict[Resource, float] | None = None,
                 num_disks: int = 1, config=None) -> None:
        cap = {Resource.CPU: 100.0, Resource.NW_IN: 1e5, Resource.NW_OUT: 1e5,
               Resource.DISK: 1e6}
        cap.update(capacity or {})
        vec = tuple(cap[Resource(i)] for i in range(NUM_RESOURCES))
        per_disk = cap[Resource.DISK] / num_disks
        self._info = BrokerCapacityInfo(vec, tuple([per_disk] * num_disks))

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        return self._info


def capacity_matrix(resolver: BrokerCapacityResolver,
                    broker_ids: list[int]) -> np.ndarray:
    """float64[RES, B] capacity tensor column for build_model."""
    out = np.zeros((NUM_RESOURCES, len(broker_ids)))
    for i, b in enumerate(broker_ids):
        out[:, i] = resolver.capacity_for(b).capacity
    return out


def disk_capacity_matrix(resolver: BrokerCapacityResolver,
                         broker_ids: list[int]) -> np.ndarray:
    """float64[B, D_max] per-disk capacities, zero-padded."""
    infos = [resolver.capacity_for(b) for b in broker_ids]
    d_max = max((len(i.disk_capacities) for i in infos), default=1) or 1
    out = np.zeros((len(broker_ids), d_max))
    for i, info in enumerate(infos):
        disks = info.disk_capacities or (info.capacity[Resource.DISK],)
        out[i, : len(disks)] = disks
    return out
