"""Resource axes tracked per replica / broker.

A resource is an index into the leading dimension of the load tensors
(float32[NUM_RESOURCES, ...]): CPU, NW_IN, NW_OUT, DISK, as in the
reference's ``common/Resource.java``.
"""

from __future__ import annotations

import enum


class Resource(enum.IntEnum):
    """Index into the resource axis of load/capacity tensors."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3


NUM_RESOURCES = len(Resource)

#: Default capacity-utilization thresholds (AnalyzerConfig
#: ``*.capacity.threshold``).
DEFAULT_CAPACITY_THRESHOLD = {
    Resource.CPU: 0.7,
    Resource.NW_IN: 0.8,
    Resource.NW_OUT: 0.8,
    Resource.DISK: 0.8,
}

#: Default balance thresholds for the resource-usage distribution goals: a
#: broker is balanced when its utilization lies within [avg*(2-t), avg*t].
DEFAULT_BALANCE_THRESHOLD = {
    Resource.CPU: 1.1,
    Resource.NW_IN: 1.1,
    Resource.NW_OUT: 1.1,
    Resource.DISK: 1.1,
}
