"""Real-cluster AdminApi over kafka-python (import-guarded).

Parity: the reference's only write path to a live cluster is the Kafka
AdminClient plumbing in ``executor/Executor.java`` / ``KafkaCruiseControlUtils``
(SURVEY.md C28). ``SimulatedAdminClient`` (ccx.executor.admin) serves every
test and benchmark; this module is the production seam — select it with::

    admin.client.class=ccx.executor.kafka_admin.KafkaAdminApi
    bootstrap.servers=host1:9092,host2:9092

kafka-python is NOT a hard dependency: the import is deferred to
construction, with a clear error naming the missing package. Feature gaps in
older kafka-python releases (KIP-455 reassignments, KIP-460 election,
KIP-113 log-dir moves) raise ``UnsupportedAdminOperation`` naming the
required client capability rather than failing obscurely mid-execution.

Conformance: tests/test_admin_conformance.py runs the same AdminApi
behavioral suite against SimulatedAdminClient always, and against this class
when ``CCX_KAFKA_BOOTSTRAP`` points at a reachable broker (skipped
otherwise, like the reference's integration harness without a cluster).
"""

from __future__ import annotations

from ccx_torch.common.metadata import (
    BrokerInfo,
    ClusterMetadata,
    PartitionInfo,
    TopicPartition,
)
from ccx_torch.executor.admin import AdminApi


class UnsupportedAdminOperation(RuntimeError):
    """The installed kafka client lacks an API this operation needs."""


def _require_kafka():
    try:
        import kafka  # noqa: F401
        from kafka import KafkaAdminClient as _K  # noqa: F401
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "ccx_torch.executor.kafka_admin.KafkaAdminApi requires the "
            "`kafka-python` package (pip install kafka-python); the default "
            "SimulatedAdminClient needs no external dependency"
        ) from e
    return _K


class KafkaAdminApi(AdminApi):
    """AdminApi against a real Kafka cluster via kafka-python."""

    def __init__(self, config=None, bootstrap_servers: str | None = None) -> None:
        K = _require_kafka()
        servers = bootstrap_servers or (
            config["bootstrap.servers"] if config is not None else None
        )
        if not servers:
            raise ValueError("bootstrap.servers is required for KafkaAdminApi")
        self._admin = K(
            bootstrap_servers=servers,
            client_id="ccx-admin",
            request_timeout_ms=(
                config["admin.request.timeout.ms"] if config is not None else 30000
            ),
        )
        self._generation = 0

    # ----- reads ------------------------------------------------------------

    def describe_cluster(self) -> ClusterMetadata:
        from kafka.admin import ConfigResource  # noqa: F401  (import check)

        cluster_info = self._admin.describe_cluster()
        alive_ids = {b["node_id"] for b in cluster_info["brokers"]}
        log_dirs = self._safe_log_dirs()
        brokers = tuple(
            BrokerInfo(
                b["node_id"],
                b.get("rack") or "",
                True,
                max(len(log_dirs.get(b["node_id"], {})), 1),
                tuple(
                    i
                    for i, ok in sorted(log_dirs.get(b["node_id"], {}).items())
                    if not ok
                ),
                # hostname from broker metadata: two brokers on one machine
                # share it, which is what the rack fallback (rack || host)
                # and the model's host axis key on
                host=b.get("host") or "",
            )
            for b in sorted(cluster_info["brokers"], key=lambda b: b["node_id"])
        )

        topics = self._admin.describe_topics()
        parts = []
        for t in sorted(topics, key=lambda t: t["topic"]):
            if t["topic"].startswith("__"):
                continue  # internal topics are not rebalanced (ref behavior)
            for p in sorted(t["partitions"], key=lambda p: p["partition"]):
                tp = TopicPartition(t["topic"], p["partition"])
                parts.append(
                    PartitionInfo(
                        tp,
                        tuple(p["replicas"]),
                        p["leader"] if p["leader"] in alive_ids else -1,
                        tuple(0 for _ in p["replicas"]),
                    )
                )
        self._generation += 1
        return ClusterMetadata(self._generation, brokers, tuple(parts))

    def _safe_log_dirs(self) -> dict[int, dict[int, bool]]:
        try:
            return self.describe_log_dirs()
        except UnsupportedAdminOperation:
            return {}

    def describe_log_dirs(self) -> dict[int, dict[int, bool]]:
        if not hasattr(self._admin, "describe_log_dirs"):
            raise UnsupportedAdminOperation(
                "installed kafka-python lacks describe_log_dirs"
            )
        out: dict[int, dict[int, bool]] = {}
        response = self._admin.describe_log_dirs()
        for broker_id, dirs in _iter_log_dir_response(response):
            out[broker_id] = dirs
        return out

    # ----- writes -----------------------------------------------------------

    def alter_partition_reassignments(self, reassignments) -> None:
        if not hasattr(self._admin, "alter_partition_reassignments"):
            raise UnsupportedAdminOperation(
                "installed kafka-python lacks KIP-455 "
                "alter_partition_reassignments; upgrade to >= 2.2"
            )
        from kafka import TopicPartition as KTP

        self._admin.alter_partition_reassignments(
            {
                KTP(tp.topic, tp.partition): list(target)
                for tp, target in reassignments.items()
            }
        )

    def list_partition_reassignments(self):
        if not hasattr(self._admin, "list_partition_reassignments"):
            raise UnsupportedAdminOperation(
                "installed kafka-python lacks KIP-455 "
                "list_partition_reassignments; upgrade to >= 2.2"
            )
        out = {}
        for ktp, st in self._admin.list_partition_reassignments().items():
            # replicas currently include removing members; the target is
            # replicas - removing + adding, order preserved
            target = [r for r in st["replicas"] if r not in st["removing_replicas"]]
            for a in st["adding_replicas"]:
                if a not in target:
                    target.append(a)
            out[TopicPartition(ktp.topic, ktp.partition)] = tuple(target)
        return out

    def elect_leaders(self, partitions=None) -> None:
        if not hasattr(self._admin, "perform_leader_election"):
            raise UnsupportedAdminOperation(
                "installed kafka-python lacks KIP-460 perform_leader_election"
            )
        from kafka import TopicPartition as KTP
        from kafka.admin import ElectionType

        ktps = (
            None
            if partitions is None
            else [KTP(tp.topic, tp.partition) for tp in partitions]
        )
        self._admin.perform_leader_election(ElectionType.PREFERRED, ktps)

    def alter_replica_log_dirs(self, moves) -> None:
        raise UnsupportedAdminOperation(
            "kafka-python exposes no alterReplicaLogDirs (KIP-113); use the "
            "kafka-reassign-partitions tool for intra-broker moves or a "
            "client with log-dir support"
        )

    def incremental_alter_configs(self, broker_configs) -> None:
        from kafka.admin import ConfigResource, ConfigResourceType

        resources = []
        for broker_id, cfgs in broker_configs.items():
            # kafka-python's alter_configs is the legacy full-replace API;
            # deletions are expressed as empty values
            resources.append(
                ConfigResource(
                    ConfigResourceType.BROKER,
                    str(broker_id),
                    configs={k: ("" if v is None else str(v)) for k, v in cfgs.items()},
                )
            )
        self._admin.alter_configs(resources)

    def describe_configs(self, broker_ids):
        from kafka.admin import ConfigResource, ConfigResourceType

        resources = [
            ConfigResource(ConfigResourceType.BROKER, str(b)) for b in broker_ids
        ]
        responses = self._admin.describe_configs(resources)
        out: dict[int, dict[str, str]] = {b: {} for b in broker_ids}
        for resp in responses:
            for res in resp.resources:
                _ec, _em, _rt, name, entries = res[:5]
                out[int(name)] = {e[0]: e[1] for e in entries if e[1] is not None}
        return out

    def create_topic(self, topic: str, partitions: int, rf: int) -> None:
        from kafka.admin import NewTopic

        self._admin.create_topics(
            [NewTopic(name=topic, num_partitions=partitions, replication_factor=rf)]
        )

    def close(self) -> None:
        self._admin.close()


def _iter_log_dir_response(response):
    """Normalize kafka-python describe_log_dirs responses (shape varies by
    version) into (broker_id, {disk_index: online}) pairs."""
    # v2+: list of (broker_id, response) or a dict
    items = response.items() if hasattr(response, "items") else response
    for entry in items:
        try:
            broker_id, payload = entry
        except (TypeError, ValueError):
            continue
        dirs: dict[int, bool] = {}
        log_dirs = getattr(payload, "log_dirs", None) or []
        for i, d in enumerate(log_dirs):
            error_code = d[0] if isinstance(d, tuple) else getattr(d, "error_code", 0)
            dirs[i] = error_code == 0
        yield int(broker_id), dirs
