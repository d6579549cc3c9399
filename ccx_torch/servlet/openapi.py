"""OpenAPI 3.0 document generated from the endpoint registry.

Parity: the reference's optional Vert.x module (SURVEY.md C36) mirrors the
servlet endpoints behind an OpenAPI contract. This spec is generated from
the single source of truth (``ccx.servlet.endpoints.EndPoint`` +
``PARAMETERS``) and served at ``GET /kafkacruisecontrol/openapi`` — zero
drift risk because there is no second endpoint table to maintain. The
document is also the ROUTE TABLE of the second API surface
(``ccx.servlet.openapi_server.OpenApiServer``, enabled by
``webserver.openapi.port``), which validates every request against this
contract before dispatch — the Vert.x module's contract-first design.
"""

from __future__ import annotations

from ccx_torch import __version__
from ccx_torch.servlet.endpoints import (
    GET_ENDPOINTS,
    PARAMETERS,
    EndPoint,
    ParamType,
)

_TYPE_MAP = {
    ParamType.STRING: {"type": "string"},
    ParamType.BOOLEAN: {"type": "boolean"},
    ParamType.INT: {"type": "integer"},
    ParamType.CSV_INT: {
        "type": "string",
        "description": "comma-separated integers",
    },
    ParamType.CSV_STR: {
        "type": "string",
        "description": "comma-separated strings",
    },
}

_SUMMARY = {
    EndPoint.STATE: "Service state (monitor/executor/analyzer/anomaly detector)",
    EndPoint.LOAD: "Per-broker load + ClusterModelStats block",
    EndPoint.PARTITION_LOAD: "Partitions sorted by resource utilization",
    EndPoint.PROPOSALS: "Current optimization proposals",
    EndPoint.KAFKA_CLUSTER_STATE: "Cluster metadata summary",
    EndPoint.USER_TASKS: "Async task audit trail",
    EndPoint.REVIEW_BOARD: "Two-step verification review board",
    EndPoint.PERMISSIONS: "Caller's roles",
    EndPoint.BOOTSTRAP: "Replay a historical metric range into the monitor",
    EndPoint.TRAIN: "Fit the linear-regression CPU estimation model",
    EndPoint.OBSERVABILITY: (
        "Flight-recorder/tracing state: live span stacks, chunk progress, "
        "compile counters, optional all-thread stack dump"
    ),
    EndPoint.REBALANCE: "Compute (and optionally execute) a rebalance",
    EndPoint.ADD_BROKER: "Move replicas onto new brokers",
    EndPoint.REMOVE_BROKER: "Evacuate brokers before decommissioning",
    EndPoint.FIX_OFFLINE_REPLICAS: "Relocate offline replicas",
    EndPoint.DEMOTE_BROKER: "Move leadership off brokers",
    EndPoint.STOP_PROPOSAL_EXECUTION: "Stop the ongoing execution",
    EndPoint.PAUSE_SAMPLING: "Pause metric sampling",
    EndPoint.RESUME_SAMPLING: "Resume metric sampling",
    EndPoint.TOPIC_CONFIGURATION: "Change topic replication factor",
    EndPoint.RIGHTSIZE: "Provisioner rightsizing",
    EndPoint.ADMIN: "Self-healing toggles + concurrency caps",
    EndPoint.REVIEW: "Approve/discard parked requests",
}


def openapi_document(url_prefix: str = "/kafkacruisecontrol") -> dict:
    paths: dict[str, dict] = {}
    for endpoint in EndPoint:
        method = "get" if endpoint in GET_ENDPOINTS else "post"
        params = [
            {
                "name": spec.name,
                "in": "query",
                "required": False,
                "schema": {
                    **_TYPE_MAP[spec.type],
                    **(
                        {"default": spec.default}
                        if spec.default is not None
                        and not isinstance(spec.default, tuple)
                        else {}
                    ),
                },
            }
            for spec in PARAMETERS[endpoint]
        ]
        paths[f"{url_prefix}/{endpoint.value}"] = {
            method: {
                "summary": _SUMMARY.get(endpoint, endpoint.value),
                "operationId": endpoint.value,
                "parameters": params,
                "responses": {
                    "200": {"description": "JSON response"},
                    "202": {
                        "description": "Async in progress; poll with the "
                        "User-Task-ID response header"
                    },
                    "400": {"description": "Invalid parameter"},
                    "401": {"description": "Authentication required"},
                    "403": {"description": "Role not authorized"},
                },
            }
        }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "ccx — Cruise Control for TPU",
            "version": __version__,
            "description": (
                "REST surface of the ccx service. Async verbs return 202 "
                "with a User-Task-ID header; replay the request with that "
                "header to poll (see docs/wiki/REST-API.md)."
            ),
        },
        "paths": paths,
    }
