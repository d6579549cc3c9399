"""Two-step review purgatory.

Parity: ``servlet/purgatory/Purgatory.java`` + Review* classes (SURVEY.md
C33): when ``two.step.verification.enabled``, mutating POSTs are parked as
PENDING_REVIEW requests; an ADMIN approves or discards them via the
``review`` endpoint; an approved request is executed by re-submitting the
original POST with its ``review_id``. ``review_board`` lists requests.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

from ccx_torch.common.exceptions import UserRequestException
from ccx_torch.servlet.endpoints import EndPoint


class ReviewStatus:
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


@dataclasses.dataclass
class RequestInfo:
    review_id: int
    endpoint: EndPoint
    query: dict
    submitter: str
    submission_ms: int
    status: str = ReviewStatus.PENDING_REVIEW
    reason: str = ""

    def to_json(self) -> dict:
        return {
            "Id": self.review_id,
            "EndPoint": self.endpoint.value,
            "Status": self.status,
            "SubmitterAddress": self.submitter,
            "SubmissionTimeMs": self.submission_ms,
            "Reason": self.reason,
        }


class Purgatory:
    def __init__(self, retention_ms: int = 1_209_600_000, max_requests: int = 25,
                 clock=None) -> None:
        import time as _time

        self.retention_ms = retention_ms
        self.max_requests = max_requests
        self.clock = clock or (lambda: int(_time.time() * 1000))
        self._requests: dict[int, RequestInfo] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config, clock=None) -> "Purgatory":
        return cls(
            config["two.step.purgatory.retention.time.ms"],
            config["two.step.purgatory.max.requests"],
            clock=clock,
        )

    def submit(self, endpoint: EndPoint, query: dict, submitter: str,
               reason: str = "") -> RequestInfo:
        with self._lock:
            self._expire()
            pending = sum(
                1 for r in self._requests.values()
                if r.status == ReviewStatus.PENDING_REVIEW
            )
            if pending >= self.max_requests:
                raise UserRequestException(
                    "Purgatory is full "
                    f"(two.step.purgatory.max.requests={self.max_requests})"
                )
            info = RequestInfo(
                review_id=next(self._ids),
                endpoint=endpoint,
                query=dict(query),
                submitter=submitter,
                submission_ms=self.clock(),
                reason=reason,
            )
            self._requests[info.review_id] = info
            return info

    def review(self, approve: tuple[int, ...], discard: tuple[int, ...]) -> list[dict]:
        with self._lock:
            for rid in approve:
                info = self._require(rid)
                if info.status != ReviewStatus.PENDING_REVIEW:
                    raise UserRequestException(
                        f"Request {rid} is {info.status}, not reviewable"
                    )
                info.status = ReviewStatus.APPROVED
            for rid in discard:
                info = self._require(rid)
                if info.status == ReviewStatus.SUBMITTED:
                    raise UserRequestException(
                        f"Request {rid} already submitted"
                    )
                info.status = ReviewStatus.DISCARDED
            return [r.to_json() for r in self._requests.values()]

    def take_approved(self, review_id: int, endpoint: EndPoint) -> RequestInfo:
        """Claim an approved request for execution (marks SUBMITTED)."""
        with self._lock:
            info = self._require(review_id)
            if info.endpoint is not endpoint:
                raise UserRequestException(
                    f"Review {review_id} is for {info.endpoint.value}, "
                    f"not {endpoint.value}"
                )
            if info.status != ReviewStatus.APPROVED:
                raise UserRequestException(
                    f"Request {review_id} is {info.status}, not APPROVED"
                )
            info.status = ReviewStatus.SUBMITTED
            return info

    def board(self, review_ids: tuple[int, ...] = ()) -> list[dict]:
        with self._lock:
            self._expire()
            rs = self._requests.values()
            if review_ids:
                rs = [r for r in rs if r.review_id in review_ids]
            return [r.to_json() for r in rs]

    def _require(self, rid: int) -> RequestInfo:
        info = self._requests.get(rid)
        if info is None:
            raise UserRequestException(f"No review request with id {rid}")
        return info

    def _expire(self) -> None:
        now = self.clock()
        for rid in list(self._requests):
            if now - self._requests[rid].submission_ms > self.retention_ms:
                del self._requests[rid]
