"""Endpoint registry + request parameter parsing.

Parity: ``servlet/CruiseControlEndPoint.java`` + ``servlet/parameters/``
(SURVEY.md C32): the endpoint enum with its GET/POST split, and one
parameter-spec per endpoint mapping query parameters to typed values
(booleans, csv lists, enums) with unknown-parameter rejection — the
reference returns 400 on unrecognized parameters.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from ccx_torch.common.exceptions import UserRequestException


class EndPoint(enum.Enum):
    # GET
    STATE = "state"
    LOAD = "load"
    PARTITION_LOAD = "partition_load"
    PROPOSALS = "proposals"
    KAFKA_CLUSTER_STATE = "kafka_cluster_state"
    USER_TASKS = "user_tasks"
    REVIEW_BOARD = "review_board"
    PERMISSIONS = "permissions"
    BOOTSTRAP = "bootstrap"
    TRAIN = "train"
    OBSERVABILITY = "observability"
    # POST
    REBALANCE = "rebalance"
    ADD_BROKER = "add_broker"
    REMOVE_BROKER = "remove_broker"
    FIX_OFFLINE_REPLICAS = "fix_offline_replicas"
    DEMOTE_BROKER = "demote_broker"
    STOP_PROPOSAL_EXECUTION = "stop_proposal_execution"
    PAUSE_SAMPLING = "pause_sampling"
    RESUME_SAMPLING = "resume_sampling"
    TOPIC_CONFIGURATION = "topic_configuration"
    RIGHTSIZE = "rightsize"
    ADMIN = "admin"
    REVIEW = "review"


GET_ENDPOINTS = frozenset(
    {
        EndPoint.STATE, EndPoint.LOAD, EndPoint.PARTITION_LOAD,
        EndPoint.PROPOSALS, EndPoint.KAFKA_CLUSTER_STATE, EndPoint.USER_TASKS,
        EndPoint.REVIEW_BOARD, EndPoint.PERMISSIONS, EndPoint.BOOTSTRAP,
        EndPoint.TRAIN, EndPoint.OBSERVABILITY,
    }
)
POST_ENDPOINTS = frozenset(set(EndPoint) - GET_ENDPOINTS)

#: endpoints whose POST semantics mutate the cluster — these are the ones
#: purgatory parks when two-step verification is on (ref C33)
MUTATING_ENDPOINTS = frozenset(
    {
        EndPoint.REBALANCE, EndPoint.ADD_BROKER, EndPoint.REMOVE_BROKER,
        EndPoint.FIX_OFFLINE_REPLICAS, EndPoint.DEMOTE_BROKER,
        EndPoint.TOPIC_CONFIGURATION,
    }
)


class ParamType(enum.Enum):
    STRING = "string"
    BOOLEAN = "boolean"
    INT = "int"
    CSV_INT = "csv_int"     # "1,2,3" -> (1, 2, 3)
    CSV_STR = "csv_str"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    name: str
    type: ParamType
    default: Any = None


_COMMON = (
    ParamSpec("json", ParamType.BOOLEAN, True),
    ParamSpec("verbose", ParamType.BOOLEAN, False),
    ParamSpec("get_response_schema", ParamType.BOOLEAN, False),
    ParamSpec("doAs", ParamType.STRING, None),
    ParamSpec("reason", ParamType.STRING, ""),
)
_MUTATION = (
    ParamSpec("dryrun", ParamType.BOOLEAN, True),
    ParamSpec("goals", ParamType.CSV_STR, ()),
    ParamSpec("allow_capacity_estimation", ParamType.BOOLEAN, True),
    ParamSpec("excluded_topics", ParamType.STRING, ""),
    ParamSpec("replication_throttle", ParamType.INT, None),
    ParamSpec("stop_ongoing_execution", ParamType.BOOLEAN, False),
    ParamSpec("review_id", ParamType.INT, None),
)

PARAMETERS: dict[EndPoint, tuple[ParamSpec, ...]] = {
    EndPoint.STATE: _COMMON + (
        ParamSpec("substates", ParamType.CSV_STR, ()),
        ParamSpec("super_verbose", ParamType.BOOLEAN, False),
    ),
    EndPoint.LOAD: _COMMON + (
        ParamSpec("allow_capacity_estimation", ParamType.BOOLEAN, True),
        ParamSpec("populate_disk_info", ParamType.BOOLEAN, False),
    ),
    EndPoint.PARTITION_LOAD: _COMMON + (
        ParamSpec("max_load_entries", ParamType.INT, 100),
        ParamSpec("topic", ParamType.STRING, ""),
        ParamSpec("resource", ParamType.STRING, "CPU"),
        ParamSpec("min_valid_partition_ratio", ParamType.STRING, None),
    ),
    EndPoint.PROPOSALS: _COMMON + (
        ParamSpec("ignore_proposal_cache", ParamType.BOOLEAN, False),
        ParamSpec("goals", ParamType.CSV_STR, ()),
        ParamSpec("data_from", ParamType.STRING, "VALID_WINDOWS"),
    ),
    EndPoint.KAFKA_CLUSTER_STATE: _COMMON,
    EndPoint.USER_TASKS: _COMMON + (
        ParamSpec("user_task_ids", ParamType.CSV_STR, ()),
        ParamSpec("types", ParamType.CSV_STR, ()),
        ParamSpec("entries", ParamType.INT, 100),
    ),
    EndPoint.REVIEW_BOARD: _COMMON + (
        ParamSpec("review_ids", ParamType.CSV_INT, ()),
    ),
    EndPoint.PERMISSIONS: _COMMON,
    EndPoint.BOOTSTRAP: _COMMON + (
        ParamSpec("start", ParamType.INT, None),
        ParamSpec("end", ParamType.INT, None),
        ParamSpec("clearmetrics", ParamType.BOOLEAN, True),
    ),
    EndPoint.TRAIN: _COMMON + (
        ParamSpec("start", ParamType.INT, None),
        ParamSpec("end", ParamType.INT, None),
    ),
    # the flight deck (ccx.common.tracing): tracer/recorder/watchdog state,
    # live span stacks + chunk progress, live compile counters; threads=true
    # adds an all-thread stack dump — usable DURING a wedged proposal
    EndPoint.OBSERVABILITY: _COMMON + (
        ParamSpec("threads", ParamType.BOOLEAN, False),
    ),
    EndPoint.REBALANCE: _COMMON + _MUTATION + (
        ParamSpec("rebalance_disk", ParamType.BOOLEAN, False),
        ParamSpec("destination_broker_ids", ParamType.CSV_INT, ()),
        ParamSpec("kafka_assigner", ParamType.BOOLEAN, False),
        ParamSpec("data_from", ParamType.STRING, "VALID_WINDOWS"),
    ),
    EndPoint.ADD_BROKER: _COMMON + _MUTATION + (
        ParamSpec("brokerid", ParamType.CSV_INT, ()),
        ParamSpec("throttle_added_broker", ParamType.BOOLEAN, True),
    ),
    EndPoint.REMOVE_BROKER: _COMMON + _MUTATION + (
        ParamSpec("brokerid", ParamType.CSV_INT, ()),
        ParamSpec("destination_broker_ids", ParamType.CSV_INT, ()),
        ParamSpec("throttle_removed_broker", ParamType.BOOLEAN, True),
    ),
    EndPoint.FIX_OFFLINE_REPLICAS: _COMMON + _MUTATION,
    EndPoint.DEMOTE_BROKER: _COMMON + _MUTATION + (
        ParamSpec("brokerid", ParamType.CSV_INT, ()),
        ParamSpec("skip_urp_demotion", ParamType.BOOLEAN, True),
        ParamSpec("exclude_follower_demotion", ParamType.BOOLEAN, False),
    ),
    EndPoint.STOP_PROPOSAL_EXECUTION: _COMMON + (
        ParamSpec("force_stop", ParamType.BOOLEAN, False),
        ParamSpec("review_id", ParamType.INT, None),
    ),
    EndPoint.PAUSE_SAMPLING: _COMMON + (
        ParamSpec("review_id", ParamType.INT, None),
    ),
    EndPoint.RESUME_SAMPLING: _COMMON + (
        ParamSpec("review_id", ParamType.INT, None),
    ),
    EndPoint.TOPIC_CONFIGURATION: _COMMON + _MUTATION + (
        ParamSpec("topic", ParamType.STRING, ""),
        ParamSpec("replication_factor", ParamType.INT, None),
    ),
    EndPoint.RIGHTSIZE: _COMMON + (
        ParamSpec("num_brokers_to_add", ParamType.INT, -1),
        ParamSpec("partition_count", ParamType.INT, -1),
    ),
    EndPoint.ADMIN: _COMMON + (
        ParamSpec("disable_self_healing_for", ParamType.CSV_STR, ()),
        ParamSpec("enable_self_healing_for", ParamType.CSV_STR, ()),
        ParamSpec("concurrent_partition_movements_per_broker", ParamType.INT, None),
        ParamSpec("concurrent_leader_movements", ParamType.INT, None),
        ParamSpec("review_id", ParamType.INT, None),
    ),
    EndPoint.REVIEW: _COMMON + (
        ParamSpec("approve", ParamType.CSV_INT, ()),
        ParamSpec("discard", ParamType.CSV_INT, ()),
    ),
}


def _coerce(spec: ParamSpec, raw: str) -> Any:
    try:
        if spec.type is ParamType.STRING:
            return raw
        if spec.type is ParamType.BOOLEAN:
            if raw.lower() in ("true", "1", ""):
                return True
            if raw.lower() in ("false", "0"):
                return False
            raise ValueError(raw)
        if spec.type is ParamType.INT:
            return int(raw)
        if spec.type is ParamType.CSV_INT:
            return tuple(int(x) for x in raw.split(",") if x.strip())
        if spec.type is ParamType.CSV_STR:
            return tuple(x.strip() for x in raw.split(",") if x.strip())
    except ValueError:
        raise UserRequestException(
            f"Invalid value {raw!r} for parameter {spec.name}"
        ) from None
    raise UserRequestException(f"Unhandled parameter type {spec.type}")


def parse_params(endpoint: EndPoint, query: dict[str, str]) -> dict[str, Any]:
    """Typed parameter dict; rejects unknown parameters (ref 400)."""
    specs = {s.name: s for s in PARAMETERS[endpoint]}
    out = {name: s.default for name, s in specs.items()}
    for name, raw in query.items():
        spec = specs.get(name)
        if spec is None:
            raise UserRequestException(
                f"Unrecognized parameter {name!r} for endpoint "
                f"{endpoint.value}"
            )
        out[name] = _coerce(spec, raw)
    return out
