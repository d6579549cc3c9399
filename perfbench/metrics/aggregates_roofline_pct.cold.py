"""Kernel: the aggregates pass's share of its roofline. The bound is the bytes
``perfbench.work.aggregates_bytes`` reckons from the cell's shapes over the
H100's published 3.35 TB/s; the time is every device op between the markers
the harness puts around each call of the system's aggregates entry, over
the calls the sampled slices hold whole. Moves propose_s."""

from perfbench.reference.generator import spec_of
from perfbench.work import H100_HBM_BYTES_PER_S, aggregates_bytes


def read(run):
    if run.trace is None or not run.trace["aggregates_ns"]:
        return None
    spec = spec_of(run.config)
    nbytes = aggregates_bytes(spec["n_partitions"], spec["max_rf"], spec["n_brokers"],
                              spec["n_topics"], spec["n_disks"])
    calls = run.trace["aggregates_ns"]
    bound_s = len(calls) * nbytes / H100_HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(calls) / 1e9)
