"""Sidecar client — the JVM bridge's reference implementation.

The port's copy of the JAX package's ``sidecar/client.py``, with snapshots
packed by the port's own codec (``ccx_torch.model.snapshot``). It mirrors
what the JVM-side ``goal.optimizer.backend=tpu`` strategy does: serialize
the cluster snapshot, stream progress, collect the ``OptimizerResult``.
Every envelope comes from ``ccx_torch/sidecar/wire.py``; the client speaks
to either package's sidecar.

Failure semantics (docs/sidecar-wire.md "Retryability"):
every RPC takes a per-call deadline, and transient failures retry with
capped exponential backoff + deterministic jitter, classified per method:

* **Ping / PutSnapshot** are idempotent — PutSnapshot by
  ``(session, generation)``: a retried full put overwrites with identical
  content, and a retried delta whose first attempt actually landed is
  ACKed by the server as a duplicate delivery (generation match) instead
  of failing the base-generation guard. Retried on UNAVAILABLE /
  RESOURCE_EXHAUSTED / DEADLINE_EXCEEDED.
* **Propose** never resumes a stream — a died/truncated/corrupted stream
  (:class:`~ccx_torch.sidecar.wire.StreamTruncated`, a locally-undecodable
  frame, a server ``internal``/``cancelled`` error frame, UNAVAILABLE)
  RESTARTS the whole request. That is safe because Propose mutates
  nothing the rerun depends on: the snapshot state is read-only to it,
  and warm-base banking is bank-last and idempotent per
  (session, generation). A retried ``warm_start`` Propose simply
  re-resolves its base — if the failed attempt lost the bank it degrades
  to the documented cold-start, never an error. Structured client-fault
  codes (``invalid-argument``, ``bad-snapshot``, ``malformed-request``
  from the SERVER, ``unsupported-wire-version``) never retry.

The client is a context manager (``with SidecarClient(addr) as c:``) so
bench/test paths stop leaking channels.
"""

from __future__ import annotations

import random
import time

from ccx_torch.sidecar import GRPC_MESSAGE_OPTIONS, SERVICE, wire
from ccx_torch.sidecar import identity as _identity

# NOTE: ccx_torch.model.snapshot (and with it torch and numpy) is imported
# lazily inside the methods that need it — a remote-only client (ping,
# session reuse) works without them.

#: server error-frame codes a Propose retry may recover from: the
#: optimizer died (injected or organic — ``internal``) or the server
#: cancelled a worker racing our own reconnect (``cancelled``). Request
#: faults (invalid-argument, bad-snapshot, server-side malformed-request,
#: unsupported-wire-version) are permanent by definition.
_RETRYABLE_FRAME_CODES = frozenset({wire.ERR_INTERNAL, wire.ERR_CANCELLED})


class SidecarClient:
    """gRPC client with per-RPC deadlines and transient-failure retry.

    ``deadline_s`` bounds each unary RPC attempt (Ping/PutSnapshot);
    ``propose_deadline_s`` bounds one whole Propose stream attempt. Both
    default to None (unbounded — a cold B5 solve is minutes on CPU, and
    a B5-scale full snapshot put over a slow link can legitimately run
    long; GRPC_MESSAGE_OPTIONS exists precisely for huge payloads):
    deadlines are opt-in per deployment, as the chaos bench does.
    ``retries`` is the number of RE-attempts after the first try (0
    disarms retry entirely — no retry); backoff doubles
    from ``backoff_s`` up to ``backoff_max_s`` with deterministic jitter
    when ``retry_seed`` is set (the chaos bench pins it for
    reproducibility)."""

    def __init__(self, address: str, *, deadline_s: float | None = None,
                 propose_deadline_s: float | None = None,
                 retries: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 retry_seed: int | None = None) -> None:
        import grpc

        self._grpc = grpc
        self.deadline_s = deadline_s
        self.propose_deadline_s = propose_deadline_s
        self.retries = max(int(retries), 0)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._rng = random.Random(retry_seed)
        #: retry accounting (the chaos bench's client-side evidence)
        self.stats = {"attempts": 0, "retries": 0, "stream_restarts": 0}
        self.channel = grpc.insecure_channel(
            address, options=list(GRPC_MESSAGE_OPTIONS)
        )
        self._propose = self.channel.unary_stream(
            f"/{SERVICE}/Propose",
            request_serializer=_identity, response_deserializer=_identity,
        )
        self._put = self.channel.unary_unary(
            f"/{SERVICE}/PutSnapshot",
            request_serializer=_identity, response_deserializer=_identity,
        )
        self._ping = self.channel.unary_unary(
            f"/{SERVICE}/Ping",
            request_serializer=_identity, response_deserializer=_identity,
        )

    # ----- retry machinery --------------------------------------------------

    def _backoff(self, attempt: int) -> None:
        base = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        time.sleep(base * (0.5 + 0.5 * self._rng.random()))

    def _transient_rpc(self, e: BaseException, unary: bool) -> bool:
        grpc = self._grpc
        if not isinstance(e, grpc.RpcError):
            return False
        code = e.code() if callable(getattr(e, "code", None)) else None
        transient = {
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.RESOURCE_EXHAUSTED,
        }
        if unary:
            # unary methods are cheap and idempotent — an expired
            # per-attempt deadline is worth one more try
            transient.add(grpc.StatusCode.DEADLINE_EXCEEDED)
        return code in transient

    def _retrying_unary(self, call, request: bytes) -> bytes:
        last: BaseException | None = None
        for attempt in range(self.retries + 1):
            self.stats["attempts"] += 1
            try:
                return call(request, timeout=self.deadline_s)
            except Exception as e:  # noqa: BLE001 — classified below
                if attempt >= self.retries or not self._transient_rpc(
                    e, unary=True
                ):
                    raise
                last = e
                self.stats["retries"] += 1
                self._backoff(attempt)
        raise last  # pragma: no cover — loop always returns or raises

    # ----- RPCs -------------------------------------------------------------

    def ping(self) -> dict:
        return wire.decode_response(
            self._retrying_unary(self._ping, wire.ping_request())
        )

    def put_snapshot(self, model, session: str, generation: int,
                     is_delta: bool = False, base_generation: int | None = None,
                     packed: bytes | None = None,
                     cluster_id: str | None = None,
                     request_id: str | None = None) -> dict:
        """``request_id`` (optional) names the request on the sidecar's
        spans."""
        req = wire.put_snapshot_request(
            session=session, generation=generation,
            packed=packed if packed is not None else _pack_model(model),
            is_delta=is_delta, base_generation=base_generation,
            cluster_id=cluster_id, request_id=request_id,
        )
        return wire.decode_response(self._retrying_unary(self._put, req))

    def propose(self, model=None, session: str | None = None,
                goals: tuple[str, ...] = (), on_progress=None,
                columnar: bool = False, cluster_id: str | None = None,
                priority: int | None = None, warm_start: bool = False,
                base_generation: int | None = None,
                stream_result: bool | None = None,
                timings: dict | None = None,
                request_id: str | None = None, **options) -> dict:
        """``columnar=True`` requests the proposals as one raw-buffer
        arrays blob (``diff_columnar`` schema) instead of per-proposal
        maps — the fast path for B5-scale results; the returned dict then
        carries numpy arrays under ``proposalsColumnar``. ``cluster_id``
        names the fleet job on the sidecar's multi-job chunk scheduler
        (default: the session id); ``priority`` orders it in the run queue
        (higher preempts at the next chunk boundary). ``warm_start``
        asks the server to warm-start from the session's last
        converged placement at ``base_generation`` — incremental
        re-optimization with graceful cold-start fallback.

        ``stream_result`` (default: follows ``columnar``) asks
        the server to ship the columnar blob as incremental
        ``resultSegment`` frames — this client reassembles them and
        returns the same dict shape as the monolithic form (including the
        ``goalSummary`` list, reconstructed from the streamed flat-array
        form). ``timings`` (optional dict) receives client-side decode
        seconds and frame counts — the ``bench.py --wire`` split.
        ``request_id`` (optional) names the request on the sidecar's spans
        and on the result's span tree (``spanTree.request``).

        Transient failures (module docstring) RESTART the whole stream —
        segments from a dead attempt are discarded, never resumed."""
        if stream_result is None:
            stream_result = columnar
        req = wire.propose_request(
            goals=goals, options=options,
            snapshot=_pack_model(model) if model is not None else None,
            session=session, columnar=columnar,
            cluster_id=cluster_id, priority=priority,
            warm_start=warm_start, base_generation=base_generation,
            stream_result=bool(stream_result and columnar),
            request_id=request_id,
        )
        last: BaseException | None = None
        for attempt in range(self.retries + 1):
            self.stats["attempts"] += 1
            try:
                return self._propose_once(
                    req, session=session, cluster_id=cluster_id,
                    on_progress=on_progress, timings=timings,
                )
            except Exception as e:  # noqa: BLE001 — classified below
                if attempt >= self.retries or not self._retryable_propose(e):
                    raise
                last = e
                self.stats["retries"] += 1
                self.stats["stream_restarts"] += 1
                self._backoff(attempt)
        raise last  # pragma: no cover — loop always returns or raises

    def _retryable_propose(self, e: BaseException) -> bool:
        if self._transient_rpc(e, unary=False):
            return True
        if isinstance(e, wire.StreamTruncated):
            # the stream died or arrived short — restart it (the Propose
            # retry-safety contract; never resume mid-blob)
            return True
        if isinstance(e, wire.SidecarError):
            if isinstance(e.__cause__, wire.WireError):
                # the frame failed LOCAL decode/validation — undecodable
                # bytes OR an impossible wire-version value are equally
                # consistent with transit corruption (a flipped byte can
                # land anywhere, including the version int), so both
                # restart. A genuinely incompatible server fails each
                # quick attempt at its FIRST frame (and the cancel above
                # kills its worker), so the bounded retries cost little;
                # the SERVER-SENT unsupported-wire-version error frame
                # (no local cause) stays permanent below.
                return True
            return e.code in _RETRYABLE_FRAME_CODES
        return False

    def _propose_once(self, req: bytes, session, cluster_id,
                      on_progress, timings) -> dict:
        result: dict | None = None
        segments: list[bytes] = []
        n_frames = 0
        call = self._propose(req, timeout=self.propose_deadline_s)
        try:
            for raw in call:
                update = wire.decode_frame(raw)  # SidecarError on error
                n_frames += 1
                if wire.FIELD_RESULT_SEGMENT in update:
                    segments.append(update["data"])
                    continue
                if "progress" in update and on_progress:
                    on_progress(update["progress"])
                if "result" in update:
                    result = update["result"]
        except BaseException:
            # ABANDON the attempt's RPC before the caller retries: an
            # un-cancelled stream lives until GC, and its server-side
            # worker keeps computing (and holding its scheduler
            # grant/residency) concurrently with the retry — the exact
            # compute-for-a-dead-peer leak the disconnect cancellation
            # exists to stop. cancel() fires the server's context
            # callback, which cancels the worker at its next chunk
            # boundary.
            cancel = getattr(call, "cancel", None)
            if cancel is not None:
                cancel()
            raise
        if result is None:
            raise wire.StreamTruncated(
                "stream ended without a result",
                session=session, cluster_id=cluster_id,
                frames=n_frames, segments=len(segments),
            )
        t0 = time.monotonic()
        expected = result.get("proposalsColumnarSegments")
        if expected is not None:
            if len(segments) != int(expected):
                raise wire.StreamTruncated(
                    "result stream truncated",
                    session=session, cluster_id=cluster_id,
                    frames=n_frames, segments=len(segments),
                    segments_expected=int(expected),
                )
            blob = b"".join(segments)
            want = result.get("proposalsColumnarBytes")
            if want is not None and len(blob) != int(want):
                raise wire.StreamTruncated(
                    f"result stream corrupt: {len(blob)} joined bytes, "
                    f"server sent {want}",
                    session=session, cluster_id=cluster_id,
                    frames=n_frames, segments=len(segments),
                    segments_expected=int(expected),
                )
            result["proposalsColumnar"] = blob
        if isinstance(result.get("proposalsColumnar"), (bytes, bytearray)):
            from ccx_torch.model.snapshot import decode_msgpack

            self._check_crc(
                result["proposalsColumnar"],
                result.get("proposalsColumnarCrc32"),
                "proposals blob", session, cluster_id, n_frames,
                len(segments),
            )
            try:
                result["proposalsColumnar"] = decode_msgpack(
                    result["proposalsColumnar"]
                )
            except Exception as e:  # noqa: BLE001 — corrupt in transit:
                # the server packed a valid blob (it priced it), so an
                # undecodable one was damaged on the wire — retryable
                raise wire.StreamTruncated(
                    f"result blob undecodable: {e}",
                    session=session, cluster_id=cluster_id,
                    frames=n_frames, segments=len(segments),
                ) from e
        if isinstance(result.get("planColumnar"), (bytes, bytearray)):
            # movement plan (additive): decode the wave-schedule
            # blob in place — consumers read result["planColumnar"] as a
            # dict of flat arrays next to the scalar result["plan"] block
            self._check_crc(
                result["planColumnar"],
                result.get("planColumnarCrc32"),
                "movement plan blob", session, cluster_id, n_frames,
                len(segments),
            )
            from ccx_torch.model.snapshot import decode_msgpack

            try:
                result["planColumnar"] = decode_msgpack(
                    result["planColumnar"]
                )
            except Exception as e:  # noqa: BLE001 — damaged in transit
                raise wire.StreamTruncated(
                    f"movement plan blob undecodable: {e}",
                    session=session, cluster_id=cluster_id,
                    frames=n_frames, segments=len(segments),
                ) from e
        if isinstance(result.get("goalSummaryColumnar"), (bytes, bytearray)):
            self._check_crc(
                result["goalSummaryColumnar"],
                result.get("goalSummaryColumnarCrc32"),
                "goal summary blob", session, cluster_id, n_frames,
                len(segments),
            )
            # streamed terminal frames carry the goal summary as flat
            # typed arrays — reconstruct the per-goal dict list so every
            # consumer sees one result shape regardless of transport
            from ccx_torch.model.snapshot import decode_msgpack

            gs = decode_msgpack(result.pop("goalSummaryColumnar"))
            result["goalSummary"] = [
                {
                    "goal": g, "hard": bool(h),
                    "violationsBefore": float(vb),
                    "violationsAfter": float(va),
                    "costBefore": float(cb), "costAfter": float(ca),
                }
                for g, h, vb, va, cb, ca in zip(
                    gs["goal"], gs["hard"],
                    gs["violationsBefore"], gs["violationsAfter"],
                    gs["costBefore"], gs["costAfter"],
                )
            ]
        if timings is not None:
            timings["decode_s"] = time.monotonic() - t0
            timings["frames"] = n_frames
            timings["segments"] = len(segments)
        return result

    @staticmethod
    def _check_crc(blob, want, what: str, session, cluster_id,
                   n_frames: int, n_segments: int) -> None:
        """Round-16 integrity check: byte flips inside a bin payload
        decode cleanly and preserve length — the server's crc32 is the
        only detector. Absent key (older server) ⇒ no check."""
        if want is None:
            return
        import zlib

        if (zlib.crc32(blob) & 0xFFFFFFFF) != int(want):
            raise wire.StreamTruncated(
                f"result stream corrupt: {what} checksum mismatch",
                session=session, cluster_id=cluster_id,
                frames=n_frames, segments=n_segments,
            )

    # ----- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self.channel.close()

    def __enter__(self) -> "SidecarClient":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _pack_model(model) -> bytes:
    from ccx_torch.model.snapshot import to_msgpack

    return to_msgpack(model)
