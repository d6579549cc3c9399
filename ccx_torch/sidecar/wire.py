"""Single-source wire schema for the sidecar hop (docs/sidecar-wire.md).

A copy of the JAX package's ``sidecar/wire.py``: every msgpack envelope that
crosses the JVM ↔ sidecar boundary is built and parsed here, byte for byte
as the JAX package builds it, so either sidecar serves the same clients
(``tests/test_torch_sidecar.py`` holds every builder's bytes equal). The
port's ``server.py`` and ``client.py`` consume this module.

Canonical encoding: map keys sorted lexicographically, msgpack minimal-width
integers, ``use_bin_type`` bins for raw buffers. The sidecar ACCEPTS any key
order; producers that want byte-exact conformance with the golden fixtures
must emit canonically (``packb`` here, ``MsgPack.Writer`` on the JVM).

Versioning: every request, response and stream frame carries an integer
``wire`` field. A missing field is accepted (pre-versioning peers); a value
outside ``SUPPORTED_WIRE_VERSIONS`` is a structured error
(``unsupported-wire-version``), never a crash — unary methods surface it as
gRPC INVALID_ARGUMENT, ``Propose`` as a terminal ``{"error", "code"}`` frame.

Dependency-light on purpose: msgpack only — no jax/numpy/grpc — so a remote
client (and the fixture cross-check) can import it anywhere.
"""

from __future__ import annotations

from typing import Any, Iterable

import msgpack

#: bump when an envelope field changes meaning; additions are compatible.
WIRE_VERSION = 1
SUPPORTED_WIRE_VERSIONS = (1,)
#: envelope field carrying the version (requests, responses, frames alike)
FIELD_WIRE = "wire"
#: fleet-serving envelope fields (additive — absent fields keep
#: pre-fleet semantics: session id doubles as cluster id, priority 0)
FIELD_CLUSTER_ID = "cluster_id"
FIELD_PRIORITY = "priority"
#: heartbeat-frame field naming the job a chunk belongs to
FIELD_JOB = "job"
#: incremental re-optimization (additive): a Propose with
#: ``warm_start`` true asks the sidecar to warm-start from the session's
#: last converged placement, resolved by (session, base_generation) —
#: ``base_generation`` doubles as the delta base when a delta rides the
#: same request (they are the same generation by construction: the
#: placement being warmed from was computed on that base). Absent ⇒
#: from-scratch semantics; an unresolvable warm base
#: cold-starts gracefully (the result's ``incremental`` block names the
#: reason), never fails the RPC.
FIELD_WARM_START = "warm_start"
#: streamed columnar results (additive): a Propose carrying
#: ``stream_result`` true (meaningful only with ``columnar_proposals``)
#: asks the sidecar to ship the columnar proposals blob as incremental
#: ``resultSegment`` frames riding the progress stream, with the terminal
#: ``result`` frame carrying only the scalar blocks (goal summary as flat
#: typed arrays, counters, verification) — frame packing never holds the
#: whole blob in one envelope. Absent ⇒ the monolithic result frame,
#: the older semantics (the legacy-client compatibility pin).
FIELD_STREAM_RESULT = "stream_result"
#: segment-frame field: the 0-based sequence number of this segment
#: (``of`` carries the total, ``data`` the raw blob bytes)
FIELD_RESULT_SEGMENT = "resultSegment"
#: request tracing (additive, the port's client only): an id the client
#: gives a PutSnapshot or Propose; every span the sidecar opens for the
#: request carries it (``ccx_torch.common.tracing``). Absent ⇒ the sidecar
#: makes one; the bytes of a request without it are unchanged.
FIELD_REQUEST_ID = "request_id"

# ----- structured error codes ----------------------------------------------

#: request carried a wire version this end does not speak
ERR_UNSUPPORTED_VERSION = "unsupported-wire-version"
#: request body is not decodable msgpack / not a map / missing required keys
ERR_MALFORMED = "malformed-request"
#: the packed snapshot/delta payload is undecodable (e.g. truncated buffer)
ERR_BAD_SNAPSHOT = "bad-snapshot"
#: semantically invalid request (unknown goal, missing session, bad base gen)
ERR_INVALID = "invalid-argument"
#: the optimizer itself failed — not the caller's fault
ERR_INTERNAL = "internal"
#: the server cancelled the work (additive): the client
#: disconnected mid-Propose and the worker was cancelled at the next
#: chunk boundary. Only ever seen by a peer that raced its own
#: disconnect; retry-safe (the cancelled run banked nothing).
ERR_CANCELLED = "cancelled"


#: Every ``Propose`` ``options`` key the sidecar understands — the single
#: source the server validates requests against (``ccx/sidecar/server.py``)
#: and the bench serializer (``bench._wire_options``) must stay a subset
#: of. An unknown key is a structured ``invalid-argument`` error, never a
#: silent fallback to the server default: a typo'd engine knob (or a field
#: added to build_opts but not serialized) must fail the RPC loudly
#: instead of quietly benchmarking the wrong configuration. Additions are
#: wire-compatible (older clients simply never send them); an older
#: server REJECTS keys it cannot honor rather than misreporting results.
PROPOSE_OPTION_KEYS = frozenset({
    # SA engine
    "chains", "steps", "moves_per_step", "seed", "chunk_steps",
    "p_swap", "p_swap_end", "swap_coupling",
    "n_temps", "exchange_interval", "bf16_scoring",
    # greedy polish / leadership pass (chunked descent engine)
    "polish_candidates", "polish_max_iters", "polish_patience",
    "polish_batch_moves", "polish_swap_fraction", "polish_chunk_iters",
    # pipeline stages
    "check_evacuation", "max_repair_rounds", "require_hard_zero",
    "run_polish", "run_leader_pass", "run_cold_greedy",
    "repair_backend", "overlap_repair",
    "topic_rebalance_rounds", "topic_rebalance_max_sweeps",
    "topic_rebalance_move_leaders", "topic_rebalance_guarded",
    "topic_rebalance_polish_iters", "leader_pass_max_iters",
    # usage-coupled swap polish
    "swap_polish_iters", "swap_polish_post_iters",
    "swap_polish_candidates", "swap_polish_guarded",
    "swap_polish_chunk_iters",
    # incremental re-optimization warm-path knobs (honored on
    # warm-start Proposes, inert otherwise)
    "warm_swap_iters", "warm_swap_patience", "warm_swap_candidates",
    "warm_steps", "warm_chunk_steps", "warm_chains", "warm_moves",
    "plateau_window", "warm_t0", "warm_leader_iters",
    # movement planning (additive): device-scheduled execution
    # waves on the proposal + optional movement-cost tier on the lex
    # objective. Absent ⇒ plan-off, older results byte-stable.
    "plan_enabled", "plan_cost_tier", "plan_max_waves",
    "plan_broker_cap", "plan_wave_bytes_mb", "plan_throttle_mbps",
})

#: movement-plan result fields (additive): when the Propose ran
#: with ``plan_enabled``, the terminal result frame carries the wave
#: schedule as one canonical msgpack blob of flat typed arrays
#: (``wave/partition/moves/moveBytes`` per diff row +
#: ``waveBytes/waveInflowPeak/waveOutflowPeak`` per wave) next to its
#: crc32, and the ``result.plan`` scalar block (projected makespan, peak
#: inflow, wave count) rides the json result. Absent ⇒ plan-off,
#: older decoding unchanged (legacy fixtures byte-stable).
FIELD_PLAN_COLUMNAR = "planColumnar"
FIELD_PLAN_COLUMNAR_CRC32 = "planColumnarCrc32"


class WireError(ValueError):
    """A structured wire-contract violation: ``code`` is one of the ERR_*
    constants and rides the wire next to the message (error frame ``code``
    field / INVALID_ARGUMENT detail prefix), so a JVM client can branch on
    it without parsing prose."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code


class SidecarError(RuntimeError):
    """Client-side image of a server error frame (or abort): ``code`` is the
    structured error code when the server sent one, else None. Subclasses
    RuntimeError so pre-versioning callers' ``except RuntimeError`` and
    message-matching keep working."""

    def __init__(self, message: str, code: str | None = None) -> None:
        super().__init__(message)
        self.code = code


class StreamTruncated(SidecarError):
    """A Propose stream died without a (complete) result — the server
    crashed mid-stream, the transport severed, or segment frames went
    missing (replaces the bare "stream ended without a result").
    Carries the context an operator (and the retry loop) needs: which
    session/cluster, how many frames arrived, how many result segments of
    how many expected. RETRY-SAFE by the Propose contract
    (docs/sidecar-wire.md "Retryability"): the client restarts the whole
    stream — never resumes mid-blob — and a rerun recomputes from the
    sidecar's own consistent state."""

    def __init__(self, message: str, session: str | None = None,
                 cluster_id: str | None = None, frames: int = 0,
                 segments: int = 0,
                 segments_expected: int | None = None) -> None:
        ctx = (
            f" (session={session!r}, cluster={cluster_id!r}, "
            f"frames={frames}, segments={segments}"
            + (f"/{segments_expected}" if segments_expected is not None
               else "")
            + ")"
        )
        super().__init__(message + ctx, code=None)
        self.session = session
        self.cluster_id = cluster_id
        self.frames = frames
        self.segments = segments
        self.segments_expected = segments_expected


# ----- canonical msgpack ----------------------------------------------------

def canonicalize(obj: Any) -> Any:
    """Recursively sort map keys (tuples become lists) — the deterministic
    form the golden fixtures are generated in."""
    if isinstance(obj, dict):
        return {k: canonicalize(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return [canonicalize(v) for v in obj]
    return obj


def packb(obj: Any) -> bytes:
    """Canonical msgpack bytes (sorted keys, bin type for bytes)."""
    return msgpack.packb(canonicalize(obj), use_bin_type=True)


def unpackb(buf: bytes) -> dict:
    """Decode an envelope; malformed bytes raise ``WireError(ERR_MALFORMED)``
    instead of leaking msgpack internals to the RPC edge."""
    try:
        obj = msgpack.unpackb(buf, raw=False)
    except Exception as e:  # noqa: BLE001 — any unpack failure is malformed
        raise WireError(ERR_MALFORMED, f"undecodable msgpack request: {e}") from e
    if not isinstance(obj, dict):
        raise WireError(
            ERR_MALFORMED, f"request must be a msgpack map, got {type(obj).__name__}"
        )
    return obj


def check_version(msg: dict, what: str = "request") -> None:
    """Graceful unknown-version gate: absent ⇒ pre-versioning peer, accepted;
    present-but-unsupported ⇒ structured ``unsupported-wire-version``."""
    v = msg.get(FIELD_WIRE)
    if v is None:
        return
    if not isinstance(v, int) or v not in SUPPORTED_WIRE_VERSIONS:
        raise WireError(
            ERR_UNSUPPORTED_VERSION,
            f"unsupported {what} wire version {v!r}; this end speaks "
            f"{list(SUPPORTED_WIRE_VERSIONS)}",
        )


def _stamped(payload: dict) -> dict:
    out = dict(payload)
    out[FIELD_WIRE] = WIRE_VERSION
    return out


# ----- requests (client side / fixture generator) ---------------------------

def ping_request() -> bytes:
    """Canonical Ping body. The server also accepts empty bytes (legacy)."""
    return packb(_stamped({}))


def put_snapshot_request(session: str, generation: int, packed: bytes,
                         is_delta: bool = False,
                         base_generation: int | None = None,
                         cluster_id: str | None = None,
                         request_id: str | None = None) -> bytes:
    req: dict = {
        "session": session,
        "generation": int(generation),
        "packed": packed,
        "is_delta": bool(is_delta),
    }
    if base_generation is not None:
        req["base_generation"] = int(base_generation)
    if cluster_id is not None:
        # fleet serving (additive): names the Kafka cluster this
        # snapshot belongs to in the sidecar's device-resident registry.
        # Absent ⇒ the session id doubles as the cluster id (pre-fleet
        # peers unchanged, fixtures byte-stable).
        req["cluster_id"] = str(cluster_id)
    if request_id is not None:
        req[FIELD_REQUEST_ID] = str(request_id)
    return packb(_stamped(req))


def propose_request(goals: Iterable[str] = (), options: dict | None = None,
                    snapshot: bytes | None = None, session: str | None = None,
                    delta: bytes | None = None,
                    base_generation: int | None = None,
                    generation: int | None = None,
                    columnar: bool = False,
                    cluster_id: str | None = None,
                    priority: int | None = None,
                    warm_start: bool = False,
                    stream_result: bool = False,
                    request_id: str | None = None) -> bytes:
    req: dict = {"goals": list(goals), "options": dict(options or {})}
    if warm_start:
        # incremental re-optimization (additive): warm-start
        # from the session's last converged placement at base_generation
        # (FIELD_WARM_START docstring); absent ⇒ from-scratch
        req["warm_start"] = True
    if snapshot is not None:
        req["snapshot"] = snapshot
    if session is not None:
        req["session"] = session
    if delta is not None:
        req["delta"] = delta
    if base_generation is not None:
        req["base_generation"] = int(base_generation)
    if generation is not None:
        req["generation"] = int(generation)
    if columnar:
        req["columnar_proposals"] = True
    if stream_result:
        # streamed columnar result (additive): segment frames +
        # a scalar terminal frame; absent ⇒ one monolithic result frame
        req["stream_result"] = True
    if cluster_id is not None:
        # fleet serving (additive): the job id this Propose runs
        # under on the multi-job chunk scheduler; absent ⇒ session id
        req["cluster_id"] = str(cluster_id)
    if priority is not None:
        # integer scheduler priority (higher = more urgent — an urgent
        # fix-offline-replicas preempts a queued dryrun at the next chunk
        # boundary); absent ⇒ 0
        req["priority"] = int(priority)
    if request_id is not None:
        req[FIELD_REQUEST_ID] = str(request_id)
    return packb(_stamped(req))


# ----- responses / stream frames (server side) ------------------------------

def ack_response(generation: int) -> bytes:
    return packb(_stamped({"generation": int(generation)}))


def pong_response(version: str, backend: str, num_devices: int,
                  device: str | None = None) -> bytes:
    """``device`` (additive, the port's: the serving device's name) is left
    out when None, so the bytes equal the JAX package's."""
    pong = {"version": version, "backend": backend, "num_devices": int(num_devices)}
    if device is not None:
        pong["device"] = device
    return packb(_stamped(pong))


def progress_frame(text: str) -> dict:
    return _stamped({"progress": text})


def heartbeat_frame(text: str, span: str | None = None,
                    chunk: int | None = None,
                    total: int | None = None,
                    job: str | None = None,
                    energy: float | None = None) -> dict:
    """A progress frame carrying structured span context — the wire face
    of the flight-recorder chunk heartbeats (ccx.common.tracing), so the
    JVM's OperationProgress can show live per-phase chunk progress during
    a long device window. Additive and wire-compatible: pre-observability
    clients read only the ``progress`` text and ignore the extra keys.
    ``job`` (additive) is the fleet cluster id the chunk belongs
    to, so an interleaved multi-job stream stays attributable per job.
    ``energy`` (additive) is the convergence taps' tier-0 lex
    energy at this chunk (possibly one chunk stale on sync-free SA
    drives) — the JVM's progress view then shows live QUALITY, not just
    depth; absent when taps are off (legacy fixtures byte-stable)."""
    f: dict = {"progress": text}
    if span is not None:
        f["span"] = span
    if chunk is not None:
        f["chunk"] = int(chunk)
    if total is not None:
        f["total"] = int(total)
    if job is not None:
        f["job"] = str(job)
    if energy is not None:
        f["energy"] = float(energy)
    return _stamped(f)


def result_frame(result: dict) -> dict:
    return _stamped({"result": result})


def result_segment_frame(seq: int, total: int, data: bytes) -> dict:
    """One incremental columnar-result segment: ``data`` is a
    raw slice of the ``proposalsColumnar`` arrays blob; the client
    concatenates segments in ``resultSegment`` order and decodes the
    joined bytes exactly like a monolithic blob. The terminal ``result``
    frame follows the last segment and carries
    ``proposalsColumnarSegments``/``proposalsColumnarBytes`` so a
    truncated stream is detectable, never silently short."""
    return _stamped({
        FIELD_RESULT_SEGMENT: int(seq), "of": int(total), "data": data,
    })


def error_frame(message: str, code: str = ERR_INVALID) -> dict:
    return _stamped({"error": message, "code": code})


def pack_frame(frame: dict) -> bytes:
    """Stream frames are NOT canonicalized: a B5 row-mode result frame
    holds ~62k proposal maps, and the recursive key-sort would deep-copy
    all of it on the hot path the <5 s T1 budget measures. Only bytes with
    golden fixtures (requests, unary responses) need canonical form —
    frame CONTENT is compared as JSON, key-order-insensitive."""
    return msgpack.packb(frame, use_bin_type=True)


def code_of(exc: BaseException) -> str:
    """Structured code for an exception escaping a method implementation."""
    if isinstance(exc, WireError):
        return exc.code
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return ERR_INVALID
    return ERR_INTERNAL


# ----- frame decode (client side) -------------------------------------------

def decode_frame(buf: bytes) -> dict:
    """Decode one Propose stream frame; raises ``SidecarError`` (with the
    server's structured code) on an error frame or a version we don't speak."""
    try:
        frame = unpackb(buf)
        check_version(frame, what="frame")
    except WireError as e:
        raise SidecarError(str(e), code=e.code) from e
    if "error" in frame:
        raise SidecarError(str(frame["error"]), code=frame.get("code"))
    return frame


def decode_response(buf: bytes) -> dict:
    """Decode a unary response, tolerating (but checking) the version."""
    try:
        resp = unpackb(buf)
        check_version(resp, what="response")
    except WireError as e:
        raise SidecarError(str(e), code=e.code) from e
    return resp
