"""Python REST client.

Parity: ``cruise-control-client`` (SURVEY.md M4/C38): endpoint methods
mirroring the servlet surface, long-polling async responses — on a 202 the
client re-requests with the returned ``User-Task-ID`` header until the
operation completes, exactly the reference client's retry loop. stdlib-only
(urllib), so the client is a standalone file operators can vendored-copy.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request


class CruiseControlClientError(Exception):
    def __init__(self, status: int, body: dict) -> None:
        self.status = status
        self.body = body
        super().__init__(f"HTTP {status}: {body.get('errorMessage', body)}")


class CruiseControlClient:
    def __init__(self, base_url: str = "http://127.0.0.1:9090",
                 auth: tuple[str, str] | None = None,
                 poll_interval_s: float = 1.0, timeout_s: float = 600.0) -> None:
        self.base = base_url.rstrip("/") + "/kafkacruisecontrol"
        self.auth = auth
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s

    # ----- plumbing ---------------------------------------------------------

    def _request(self, method: str, endpoint: str, params: dict | None = None,
                 task_id: str | None = None) -> tuple[int, dict, dict]:
        query = urllib.parse.urlencode(
            {k: _render(v) for k, v in (params or {}).items() if v is not None}
        )
        url = f"{self.base}/{endpoint}" + (f"?{query}" if query else "")
        req = urllib.request.Request(url, method=method)
        req.add_header("Accept", "application/json")
        if task_id:
            req.add_header("User-Task-ID", task_id)
        if self.auth:
            import base64

            tok = base64.b64encode(f"{self.auth[0]}:{self.auth[1]}".encode())
            req.add_header("Authorization", f"Basic {tok.decode()}")
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return (
                    resp.status,
                    json.loads(resp.read() or b"{}"),
                    dict(resp.headers),
                )
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}"), dict(e.headers)

    def call(self, method: str, endpoint: str, params: dict | None = None) -> dict:
        """Request + long-poll to completion (ref client retry loop)."""
        deadline = time.monotonic() + self.timeout_s
        status, body, headers = self._request(method, endpoint, params)
        task_id = headers.get("User-Task-ID")
        while status == 202:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{endpoint} still running after {self.timeout_s}s "
                    f"(task {task_id})"
                )
            time.sleep(self.poll_interval_s)
            status, body, headers = self._request(
                method, endpoint, None, task_id=task_id
            )
        if status >= 400:
            raise CruiseControlClientError(status, body)
        return body

    # ----- endpoint methods (ref C38 endpoint classes) ----------------------

    def state(self, substates: tuple[str, ...] = ()) -> dict:
        return self.call("GET", "state",
                         {"substates": substates} if substates else None)

    def load(self) -> dict:
        return self.call("GET", "load")

    def partition_load(self, max_load_entries: int = 100, resource: str = "CPU",
                       topic: str = "") -> dict:
        return self.call("GET", "partition_load", {
            "max_load_entries": max_load_entries, "resource": resource,
            "topic": topic or None,
        })

    def proposals(self, ignore_cache: bool = False) -> dict:
        return self.call("GET", "proposals",
                         {"ignore_proposal_cache": ignore_cache})

    def kafka_cluster_state(self) -> dict:
        return self.call("GET", "kafka_cluster_state")

    def user_tasks(self) -> dict:
        return self.call("GET", "user_tasks")

    def permissions(self) -> dict:
        return self.call("GET", "permissions")

    def rebalance(self, dryrun: bool = True, goals: tuple[str, ...] = (),
                  excluded_topics: str = "", rebalance_disk: bool = False,
                  destination_broker_ids: tuple[int, ...] = (),
                  reason: str = "", review_id: int | None = None) -> dict:
        return self.call("POST", "rebalance", {
            "dryrun": dryrun, "goals": goals or None,
            "excluded_topics": excluded_topics or None,
            "rebalance_disk": rebalance_disk or None,
            "destination_broker_ids": destination_broker_ids or None,
            "reason": reason or None, "review_id": review_id,
        })

    def add_broker(self, broker_ids, dryrun: bool = True, reason: str = "",
                   review_id: int | None = None) -> dict:
        return self.call("POST", "add_broker", {
            "brokerid": tuple(broker_ids), "dryrun": dryrun,
            "reason": reason or None, "review_id": review_id,
        })

    def remove_broker(self, broker_ids, dryrun: bool = True, reason: str = "",
                      destination_broker_ids: tuple[int, ...] = (),
                      review_id: int | None = None) -> dict:
        return self.call("POST", "remove_broker", {
            "brokerid": tuple(broker_ids), "dryrun": dryrun,
            "destination_broker_ids": destination_broker_ids or None,
            "reason": reason or None, "review_id": review_id,
        })

    def demote_broker(self, broker_ids, dryrun: bool = True, reason: str = "",
                      review_id: int | None = None) -> dict:
        return self.call("POST", "demote_broker", {
            "brokerid": tuple(broker_ids), "dryrun": dryrun,
            "reason": reason or None, "review_id": review_id,
        })

    def fix_offline_replicas(self, dryrun: bool = True, reason: str = "") -> dict:
        return self.call("POST", "fix_offline_replicas",
                         {"dryrun": dryrun, "reason": reason or None})

    def topic_configuration(self, topic: str, replication_factor: int,
                            dryrun: bool = True) -> dict:
        return self.call("POST", "topic_configuration", {
            "topic": topic, "replication_factor": replication_factor,
            "dryrun": dryrun,
        })

    def rightsize(self) -> dict:
        return self.call("POST", "rightsize")

    def stop_proposal_execution(self) -> dict:
        return self.call("POST", "stop_proposal_execution")

    def pause_sampling(self, reason: str = "") -> dict:
        return self.call("POST", "pause_sampling", {"reason": reason or None})

    def resume_sampling(self, reason: str = "") -> dict:
        return self.call("POST", "resume_sampling", {"reason": reason or None})

    def admin(self, **params) -> dict:
        return self.call("POST", "admin", params)

    def review(self, approve: tuple[int, ...] = (),
               discard: tuple[int, ...] = ()) -> dict:
        return self.call("POST", "review", {
            "approve": approve or None, "discard": discard or None,
        })

    def review_board(self) -> dict:
        return self.call("GET", "review_board")


def _render(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)
