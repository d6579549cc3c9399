"""The REST API server.

Parity: ``servlet/KafkaCruiseControlServlet.java`` + ``KafkaCruiseControlApp``
(SURVEY.md C32, L6): endpoints under ``/kafkacruisecontrol/<endpoint>``,
JSON responses, async semantics — a request not finished within
``webserver.request.maxBlockTimeMs`` returns 202 with a ``User-Task-ID``
header and progress body; the client re-requests with that header (or polls
``user_tasks``) until 200. Security (C34) and two-step review purgatory
(C33) wrap dispatch. Built on stdlib ``ThreadingHTTPServer`` — the embedded-
Jetty role with zero extra dependencies.
"""

from __future__ import annotations

import json
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ccx_torch.common.exceptions import UserRequestException
from ccx_torch.detector.anomalies import AnomalyType
from ccx_torch.servlet.endpoints import (
    GET_ENDPOINTS,
    MUTATING_ENDPOINTS,
    POST_ENDPOINTS,
    EndPoint,
    parse_params,
)
from ccx_torch.servlet.purgatory import Purgatory
from ccx_torch.servlet.security import NoopSecurityProvider, authorized
from ccx_torch.service.async_ops import TaskState, UserTaskManager

URL_PREFIX = "/kafkacruisecontrol"


class CruiseControlApp:
    """Server wiring (ref KafkaCruiseControlApp): façade + user tasks +
    purgatory + security behind an HTTP listener."""

    def __init__(self, config, facade, clock=None) -> None:
        self.config = config
        self.facade = facade
        self.user_tasks = UserTaskManager.from_config(config, clock=clock)
        self.purgatory = (
            Purgatory.from_config(config, clock=clock)
            if config["two.step.verification.enabled"]
            else None
        )
        if config["webserver.security.enable"]:
            self.security = config.configured_instance("webserver.security.provider")
        else:
            self.security = NoopSecurityProvider()
        self.max_block_ms = config["webserver.request.maxBlockTimeMs"]
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ----- lifecycle --------------------------------------------------------

    def start(self) -> tuple[str, int]:
        handler = _make_handler(self)
        addr = (
            self.config["webserver.http.address"],
            self.config["webserver.http.port"],
        )
        self._httpd = ThreadingHTTPServer(addr, handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ccx-rest", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[:2]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.user_tasks.shutdown()

    # ----- dispatch ---------------------------------------------------------

    def handle(self, method: str, endpoint: EndPoint, params: dict,
               headers: dict, client: str) -> tuple[int, dict, dict]:
        """Returns (status, body, extra_headers)."""
        # --- async replay: a User-Task-ID header resumes a prior request ---
        task_id = headers.get("user-task-id")
        if task_id:
            info = self.user_tasks.get(task_id)
            if info is None:
                raise UserRequestException(f"Unknown User-Task-ID {task_id}")
            # Replay is only valid against the endpoint the task was created
            # for (authorization above was checked against the *requested*
            # endpoint, so an endpoint mismatch would leak another verb's
            # result past the role check — ref UserTaskManager matches the
            # request URL when resuming) and only for the originating client.
            if info.endpoint != endpoint.value.upper():
                raise UserRequestException(
                    f"User-Task-ID {task_id} belongs to endpoint "
                    f"{info.endpoint}, not {endpoint.value.upper()}"
                )
            if info.client_id and client and info.client_id != client:
                raise UserRequestException(
                    f"User-Task-ID {task_id} was created by a different "
                    "client"
                )
            return self._task_response(info)

        # --- two-step review (C33) -----------------------------------------
        if (
            self.purgatory is not None
            and endpoint in MUTATING_ENDPOINTS
            and not params.get("dryrun", True)
        ):
            review_id = params.get("review_id")
            if review_id is None:
                info = self.purgatory.submit(
                    endpoint,
                    {k: v for k, v in params.items() if v is not None},
                    client,
                    reason=params.get("reason", ""),
                )
                return 200, {
                    "RequestInfo": info.to_json(),
                    "message": (
                        "Request parked for review; approve via the review "
                        "endpoint, then re-submit with review_id="
                        f"{info.review_id}"
                    ),
                }, {}
            stored = self.purgatory.take_approved(review_id, endpoint)
            merged = dict(stored.query)
            merged.pop("review_id", None)
            params = {**params, **merged}

        # --- synchronous endpoints -----------------------------------------
        sync = self._sync_dispatch(endpoint, params, headers)
        if sync is not None:
            return 200, sync, {}

        # --- async verbs through the user task manager ---------------------
        fn = self._verb(endpoint, params)
        info = self.user_tasks.submit(
            endpoint.value.upper(), fn,
            request_url=f"{URL_PREFIX}/{endpoint.value}", client_id=client,
            # self-healing fixes bypass the active-task cap (and run at
            # urgent fleet priority below): a saturated dryrun table must
            # never 503 an offline-replica repair
            urgent=endpoint is EndPoint.FIX_OFFLINE_REPLICAS,
        )
        try:
            info.future.result(timeout=self.max_block_ms / 1000.0)
        except TimeoutError:
            pass
        except Exception:
            pass  # surfaced via _task_response
        return self._task_response(info)

    def _task_response(self, info) -> tuple[int, dict, dict]:
        hdrs = {"User-Task-ID": info.task_id}
        if info.state == TaskState.ACTIVE:
            return 202, {
                "progress": info.progress.to_json(),
                "message": "Operation in progress",
                "userTaskId": info.task_id,
            }, hdrs
        if info.state == TaskState.COMPLETED_WITH_ERROR:
            e = info.future.exception()
            status = 400 if isinstance(e, UserRequestException) else 500
            return status, {
                "errorMessage": str(e),
                "stackTrace": "".join(
                    traceback.format_exception(type(e), e, e.__traceback__)
                ),
                "userTaskId": info.task_id,
            }, hdrs
        body = info.future.result()
        if not isinstance(body, dict):
            body = {"result": body}
        body["userTaskId"] = info.task_id
        return 200, body, hdrs

    # ----- endpoint implementations ----------------------------------------

    def _sync_dispatch(self, endpoint: EndPoint, params, headers):
        f = self.facade
        if endpoint is EndPoint.STATE:
            return f.state(params["substates"])
        if endpoint is EndPoint.OBSERVABILITY:
            return f.observability(include_threads=params["threads"])
        if endpoint is EndPoint.KAFKA_CLUSTER_STATE:
            return f.kafka_cluster_state()
        if endpoint is EndPoint.PERMISSIONS:
            auth = self.security.authenticate(headers)
            return {"principal": auth.principal, "roles": sorted(auth.roles)}
        if endpoint is EndPoint.USER_TASKS:
            tasks = self.user_tasks.tasks()
            ids = params["user_task_ids"]
            if ids:
                tasks = [t for t in tasks if t.task_id in ids]
            return {"userTasks": [t.to_json() for t in tasks[: params["entries"]]]}
        if endpoint is EndPoint.REVIEW_BOARD:
            if self.purgatory is None:
                raise UserRequestException(
                    "two.step.verification.enabled is false"
                )
            return {"RequestInfo": self.purgatory.board(params["review_ids"])}
        if endpoint is EndPoint.REVIEW:
            if self.purgatory is None:
                raise UserRequestException(
                    "two.step.verification.enabled is false"
                )
            return {
                "RequestInfo": self.purgatory.review(
                    params["approve"], params["discard"]
                )
            }
        if endpoint is EndPoint.STOP_PROPOSAL_EXECUTION:
            return f.stop_proposal_execution()
        if endpoint is EndPoint.PAUSE_SAMPLING:
            return f.pause_sampling(params["reason"])
        if endpoint is EndPoint.RESUME_SAMPLING:
            return f.resume_sampling(params["reason"])
        if endpoint is EndPoint.ADMIN:
            return self._admin(params)
        return None

    def _admin(self, params) -> dict:
        out = {}
        notifier = self.facade.anomaly_detector.notifier
        toggles = [(n, True) for n in params["enable_self_healing_for"]] + [
            (n, False) for n in params["disable_self_healing_for"]
        ]
        if toggles and not hasattr(notifier, "enabled"):
            raise UserRequestException(
                f"Notifier {type(notifier).__name__} does not support "
                "self-healing toggles"
            )
        for name, value in toggles:
            try:
                anomaly_type = AnomalyType[name.upper()]
            except KeyError:
                raise UserRequestException(
                    f"Unknown anomaly type {name!r}; one of "
                    f"{[t.name.lower() for t in AnomalyType]}"
                ) from None
            notifier.enabled[anomaly_type] = value
            key = "selfHealingEnabled" if value else "selfHealingDisabled"
            out.setdefault(key, []).append(anomaly_type.name)
        cap = params["concurrent_partition_movements_per_broker"]
        if cap is not None:
            self.facade.executor.caps.per_broker_inter = cap
            self.facade.executor.concurrency.cap = cap
            out["concurrentPartitionMovementsPerBroker"] = cap
        leaders = params["concurrent_leader_movements"]
        if leaders is not None:
            self.facade.executor.caps.leadership_batch = leaders
            out["concurrentLeaderMovements"] = leaders
        return out or {"message": "No admin action requested"}

    def _verb(self, endpoint: EndPoint, params):
        f = self.facade
        common = dict(dryrun=params.get("dryrun", True),
                      reason=params.get("reason", ""))

        if endpoint is EndPoint.LOAD:
            return lambda progress: f.load()
        if endpoint is EndPoint.BOOTSTRAP:
            return lambda progress: f.bootstrap(
                params["start"], params["end"],
                clear_metrics=params["clearmetrics"],
            )
        if endpoint is EndPoint.TRAIN:
            return lambda progress: f.train(params["start"], params["end"])
        if endpoint is EndPoint.PARTITION_LOAD:
            return lambda progress: f.partition_load(
                params["max_load_entries"], resource=params["resource"],
                topic=params["topic"],
            )
        if endpoint is EndPoint.PROPOSALS:
            return lambda progress: f.proposals(
                progress, ignore_cache=params["ignore_proposal_cache"]
            )
        if endpoint is EndPoint.RIGHTSIZE:
            return lambda progress: f.rightsize(progress)
        if endpoint is EndPoint.REBALANCE:
            return lambda progress: f.rebalance(
                goals=params["goals"] or None,
                excluded_topics=params["excluded_topics"],
                rebalance_disk=params["rebalance_disk"],
                destination_brokers=params["destination_broker_ids"],
                kafka_assigner=params["kafka_assigner"],
                data_from=params["data_from"],
                replication_throttle=params["replication_throttle"],
                progress=progress, **common,
            )
        if endpoint is EndPoint.ADD_BROKER:
            return lambda progress: f.add_brokers(
                params["brokerid"], goals=params["goals"] or None,
                replication_throttle=params["replication_throttle"],
                progress=progress, **common,
            )
        if endpoint is EndPoint.REMOVE_BROKER:
            return lambda progress: f.remove_brokers(
                params["brokerid"], goals=params["goals"] or None,
                destination_brokers=params["destination_broker_ids"],
                replication_throttle=params["replication_throttle"],
                progress=progress, **common,
            )
        if endpoint is EndPoint.DEMOTE_BROKER:
            return lambda progress: f.demote_brokers(
                params["brokerid"], progress=progress, **common
            )
        if endpoint is EndPoint.FIX_OFFLINE_REPLICAS:
            return lambda progress: f.fix_offline_replicas(
                goals=params["goals"] or None, progress=progress, **common
            )
        if endpoint is EndPoint.TOPIC_CONFIGURATION:
            topic, rf = params["topic"], params["replication_factor"]
            if not topic or rf is None:
                raise UserRequestException(
                    "topic_configuration requires topic and replication_factor"
                )
            return lambda progress: f.update_topic_configuration(
                {topic: rf}, progress=progress, **common
            )
        raise UserRequestException(f"Unhandled endpoint {endpoint.value}")


def _make_handler(app: CruiseControlApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; ops log via logging
            import logging

            logging.getLogger("ccx_torch.servlet.access").debug(
                "%s %s", self.address_string(), fmt % args
            )

        def _dispatch(self, method: str) -> None:
            try:
                # Drain the request body first — with HTTP/1.1 keep-alive an
                # unread body would be parsed as the next request line.
                # Urlencoded form bodies merge into the query parameters
                # (the reference accepts parameters either way).
                body_params: dict[str, str] = {}
                length = int(self.headers.get("Content-Length") or 0)
                if length > 0:
                    raw = self.rfile.read(length)
                    ctype = (self.headers.get("Content-Type") or "").lower()
                    if "application/x-www-form-urlencoded" in ctype:
                        body_params = {
                            k: v[-1]
                            for k, v in urllib.parse.parse_qs(
                                raw.decode(errors="replace"),
                                keep_blank_values=True,
                            ).items()
                        }
                parsed = urllib.parse.urlparse(self.path)
                # non-JSON surfaces: dashboard (ref M5 ui) + Prometheus
                # metrics (ref §5.1 JMX registry -> text exposition).
                # Same authentication gate as the JSON endpoints.
                is_ui = method == "GET" and parsed.path in ("/", "/ui", "/ui/")
                is_metrics = (
                    method == "GET" and parsed.path == URL_PREFIX + "/metrics"
                )
                is_openapi = (
                    method == "GET" and parsed.path == URL_PREFIX + "/openapi"
                )
                if is_ui or is_metrics or is_openapi:
                    hdrs = {k.lower(): v for k, v in self.headers.items()}
                    hdrs["x-ccx-peer-address"] = self.client_address[0]
                    auth = app.security.authenticate(hdrs)
                    if not auth.ok:
                        self._send(
                            401, {"errorMessage": "Authentication required"},
                            {"WWW-Authenticate": auth.challenge or "Basic"},
                        )
                        return
                    if is_ui:
                        from ccx_torch.servlet.ui import PAGE

                        self._send_raw(
                            200, PAGE.encode(), "text/html; charset=utf-8"
                        )
                    elif is_openapi:
                        from ccx_torch.servlet.openapi import openapi_document

                        self._send(200, openapi_document(URL_PREFIX))
                    else:
                        from ccx_torch.common import compilestats
                        from ccx_torch.common.metrics import (
                            PROMETHEUS_CONTENT_TYPE,
                            REGISTRY,
                        )

                        # live compile counters ride every scrape (idempotent
                        # re-registration) — a wedged run's compile activity
                        # is visible from outside the process
                        compilestats.export_gauges(REGISTRY)
                        self._send_raw(
                            200, REGISTRY.render_prometheus().encode(),
                            PROMETHEUS_CONTENT_TYPE,
                        )
                    return
                if not parsed.path.startswith(URL_PREFIX + "/"):
                    self._send(404, {"errorMessage": f"Unknown path {parsed.path}"})
                    return
                name = parsed.path[len(URL_PREFIX) + 1:].strip("/").lower()
                try:
                    endpoint = EndPoint(name)
                except ValueError:
                    self._send(404, {"errorMessage": f"Unknown endpoint {name!r}"})
                    return
                allowed = GET_ENDPOINTS if method == "GET" else POST_ENDPOINTS
                if endpoint not in allowed:
                    self._send(
                        405,
                        {"errorMessage":
                         f"{endpoint.value} does not support {method}"},
                    )
                    return
                headers = {k.lower(): v for k, v in self.headers.items()}
                # Server-injected TCP peer address (cannot be spoofed by the
                # client) — consumed by TrustedProxySecurityProvider.
                headers["x-ccx-peer-address"] = self.client_address[0]
                auth = app.security.authenticate(headers)
                if not auth.ok:
                    self._send(
                        401, {"errorMessage": "Authentication required"},
                        {"WWW-Authenticate": auth.challenge or "Basic"},
                    )
                    return
                if not authorized(auth.roles, endpoint):
                    self._send(
                        403,
                        {"errorMessage":
                         f"{auth.principal} is not authorized for "
                         f"{endpoint.value}"},
                    )
                    return
                query = {
                    k: v[-1]
                    for k, v in urllib.parse.parse_qs(
                        parsed.query, keep_blank_values=True
                    ).items()
                }
                query = {**body_params, **query}
                params = parse_params(endpoint, query)
                status, body, extra = app.handle(
                    method, endpoint, params, headers,
                    client=auth.principal or self.client_address[0],
                )
                self._send(status, body, extra)
            except UserRequestException as e:
                self._send(400, {"errorMessage": str(e)})
            except Exception as e:  # noqa: BLE001 — servlet boundary
                self._send(
                    500,
                    {
                        "errorMessage": str(e),
                        "stackTrace": traceback.format_exc(),
                    },
                )

        def _send(self, status: int, body: dict, extra: dict | None = None) -> None:
            payload = json.dumps({"version": 1, **body}).encode()
            self._send_raw(status, payload, "application/json", extra)

        def _send_raw(self, status: int, payload: bytes, content_type: str,
                      extra: dict | None = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

    return Handler
