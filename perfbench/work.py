"""The work of the system's broker-aggregates pass, reckoned from the
problem's shapes alone: every input byte it needs read once, every output
byte written once. A copy of the count the system's cost model keeps, so
that a later change to the system cannot move the yardstick; the padding
rules (partitions to a power of two >= 64, brokers >= 8, topics >= 4) are
the snapshot format's."""

from __future__ import annotations

from perfbench.reference.goals import bucket

#: the published memory rate of one NVIDIA H100 SXM (NVIDIA's data sheet,
#: at the full 700 W power limit)
H100_HBM_BYTES_PER_S = 3.35e12


def aggregates_bytes(n_partitions: int, max_rf: int, n_brokers: int, n_topics: int,
                     n_disks: int) -> int:
    """Bytes one aggregates pass must move on a cluster of these sizes:
    per live partition its assignment and disk rows, leader slot, topic and
    leader and follower loads; one validity byte per padded partition; the
    eight per-broker rows, the two topic-by-broker count matrices and the
    per-disk loads written once. The operations (12 additions a replica)
    bound far less time than the bytes and are not reckoned."""
    P, B, T = bucket(n_partitions, 64), bucket(n_brokers, 8), bucket(n_topics, 4)
    read = P * 1 + n_partitions * (max_rf * 4 * 2 + 4 * 2 + 2 * 4 * 4)
    written = 4 * B * 4 + 4 * B * 4 + 2 * T * B * 4 + B * n_disks * 4
    return read + written
