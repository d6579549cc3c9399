"""Device cost observatory — per-program call counts, first-call captures and
roofline projections on the card.

The port's counterpart of the JAX package's ``common/costmodel.py``. The
JAX package wraps each compiled program and reads XLA's cost and memory
analyses; the port has no compiled programs, so it counts and measures the
Python functions that put a chunk of work on the card. Each instrumented
site (``instrument``; see the call sites: ``broker-aggregates``,
``stack-eval``, ``repair-sweep``, ``hot-list``, ``chain-init``,
``sa-chunk``, ``polish-chunk``, ``swap-polish-chunk``, ``warm-init``,
``warm-finish``, ``plan-waves``) is treated so:

* **Counting.** Every call is counted per (label, shape signature). The
  signature reads shapes, dtypes and devices, never tensor data, so
  counting adds no device sync. The sites are at chunk granularity (one
  count per SA or descent chunk, never per step), because the cold and warm
  paths are bound by host launches and counting must not add to them.
* **Work.** Where the work of a call can be reckoned (``broker-aggregates``:
  the bytes it must move and the operations it must do, from the kernel's
  sizes and this model's live partition and replica counts,
  ``aggregates_work``), it is reckoned once per shape: the counts are
  copied behind the call into pinned memory and read when the projection
  is asked for. Elsewhere flops and bytes are ``None``, as the JAX package
  records a field its backend does not report. Projections use the work,
  so they cover calls that were never captured.
* **Capture.** Off by default (``set_capture``, env ``CCX_COST_CAPTURE``).
  When armed, the first call of a shape that has no record, made inside a
  cold run (``cold_window``; the optimizer opens one around its cold
  pipeline only), is measured: its device seconds with CUDA events around
  it and the allocator's peak (``torch.cuda.max_memory_allocated`` after a
  peak reset; a capture nested in another keeps the outer one's reset).
  On the CPU the host clock times it and the peak is ``None``. The events
  are read by ``capture_pending`` — the optimizer's ``cost-capture`` phase —
  so a capture adds no sync to the call. A warm run never captures.
  Capture never raises: an error of the measurement is recorded in the
  record's ``error`` field; the call's own errors propagate.

From the work and a table of NVIDIA cards (``DEVICE_SPECS``, matched on
``torch.cuda.get_device_name``; an operator override with
``set_device_override``) ``projection`` computes roofline seconds —
``max(flops/peak, bytes/bandwidth)`` — per program and for the live card;
an unknown card has spec ``None`` and no roofline. The rollup rides
``OptimizerResult.cost_model`` (the result's ``costModel``), every phase
span (``ccx_torch.common.tracing``) and the sidecar's gauges.
"""

from __future__ import annotations

import functools
import hashlib
import os
import sys
import threading
import time

#: env switch for capture arming
ENV_CAPTURE = "CCX_COST_CAPTURE"
#: the fleet snapshot budget override, in MB
ENV_FLEET_HBM_MB = "CCX_FLEET_HBM_MB"
#: floor of the derived device-memory budget
MIN_BUDGET_BYTES = 64_000_000

#: NVIDIA cards: peak float32 rate outside the tensor cores (the rate the
#: port's sums and scores run at), memory rate and memory size, from
#: NVIDIA's data sheets (dense rates, full power limit)
DEVICE_SPECS = {
    "h100-sxm": {"peakFlops": 67e12, "hbmBytesPerSec": 3.35e12, "hbmBytes": 80e9},
    "h100-pcie": {"peakFlops": 51e12, "hbmBytesPerSec": 2.0e12, "hbmBytes": 80e9},
}

#: device-name substring -> spec key, first match wins (the PCIe part
#: before the SXM part, whose name only says HBM3)
_KIND_MATCHES = (
    ("h100 pcie", "h100-pcie"),
    ("h100 80gb hbm3", "h100-sxm"),
    ("h100 sxm", "h100-sxm"),
)

_LOCK = threading.Lock()
#: shape key -> cumulative call count
_CALLS: dict[str, int] = {}
#: shape key -> (label, work or None, loop iterations), set at first sight
_WORK: dict[str, tuple] = {}
#: shape key -> captured record
_RECORDS: dict[str, dict] = {}
#: shape key -> a measured call whose events are not read yet
_PENDING: dict[str, dict] = {}
_CAPTURE = None  # None: follow the env
_OVERRIDE: dict = {}
_TL = threading.local()


def set_capture(on: bool | None) -> None:
    """Arm or disarm capture; ``None`` restores the env default."""
    global _CAPTURE
    _CAPTURE = on if on is None else bool(on)


def capture_enabled() -> bool:
    if _CAPTURE is not None:
        return _CAPTURE
    return os.environ.get(ENV_CAPTURE) == "1"


def set_device_override(peak_tflops: float = 0.0, hbm_gbps: float = 0.0) -> None:
    """Operator roofline ceilings for the live card; 0 keeps the table's."""
    with _LOCK:
        _OVERRIDE.clear()
        if peak_tflops and peak_tflops > 0:
            _OVERRIDE["peakFlops"] = float(peak_tflops) * 1e12
        if hbm_gbps and hbm_gbps > 0:
            _OVERRIDE["hbmBytesPerSec"] = float(hbm_gbps) * 1e9


def reset() -> None:
    """Clear counts, work, records and pending captures (tests only: the
    ledger is process-wide by design)."""
    with _LOCK:
        _CALLS.clear()
        _WORK.clear()
        _RECORDS.clear()
        _PENDING.clear()


class cold_window:  # noqa: N801 — used as a context manager
    """Marks this thread as running a cold pipeline: the only place a
    capture may happen."""

    def __enter__(self):
        _TL.cold = getattr(_TL, "cold", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _TL.cold -= 1


def _in_cold_window() -> bool:
    return getattr(_TL, "cold", 0) > 0


# ----- the instrumentation seam ---------------------------------------------------


def _leaf_sig(x) -> object:
    """One argument's part of the shape signature: a tensor's shape, dtype
    and device; a dataclass holding tensors (a model, a search state) its
    fields' signatures; a frozen dataclass of values (options, a goal
    config) its hash; anything else (a generator, a closure) its type name,
    never an identity. Reads no tensor data."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype), str(getattr(x, "device", "")))
    if isinstance(x, (int, float, bool, str, bytes, type(None))):
        return repr(x)
    if isinstance(x, (tuple, list)):
        return tuple(_leaf_sig(v) for v in x)
    fields = getattr(x, "__dataclass_fields__", None)
    if fields is not None:
        vals = [getattr(x, f, None) for f in fields]
        if any(getattr(v, "shape", None) is not None for v in vals):
            return (type(x).__name__, tuple(_leaf_sig(v) for v in vals))
        try:
            return f"{type(x).__name__}#{hash(x)}"
        except TypeError:
            pass
    return type(x).__name__


def signature(*xs) -> tuple:
    """The shape signature of ``xs`` (for a site's fixed ``sig``)."""
    return tuple(_leaf_sig(x) for x in xs)


def _key_of(label: str, sig) -> str:
    digest = hashlib.blake2b(repr(sig).encode(), digest_size=6).hexdigest()
    return f"{label}#{digest}"


def _device_of(args, kwargs):
    import torch

    for x in (*args, *kwargs.values()):
        d = getattr(x, "device", None)
        if isinstance(d, torch.device):
            return d
    return None


def instrument(label: str, iters: int = 1, work=None, sig=None, device=None):
    """Decorator naming one site for the cost ledger.

    ``iters``: the site's loop trip count per call (a chunk's steps or
    iterations), which scales the work of a call in projections.
    ``work(*args, **kwargs)``: the call's work, reckoned once per shape
    (``aggregates_work_of``); None: not reckonable. ``sig``/``device``: a
    fixed signature and device for a closure whose arguments say nothing
    of its shapes (the chunk drivers' ``run_one``)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            s = sig if sig is not None else tuple(_leaf_sig(a) for a in args) + tuple(
                (k, _leaf_sig(v)) for k, v in sorted(kwargs.items()))
            key = _key_of(label, s)
            with _LOCK:
                _CALLS[key] = _CALLS.get(key, 0) + 1
                seen = key in _WORK
                capture = (key not in _RECORDS and key not in _PENDING
                           and _in_cold_window() and capture_enabled())
            if not seen:
                w = work(*args, **kwargs) if work is not None else None
                with _LOCK:
                    _WORK.setdefault(key, (label, w, max(int(iters), 1)))
            if capture:
                dev = device if device is not None else _device_of(args, kwargs)
                return _capture_call(key, label, dev, fn, args, kwargs)
            return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper

    return deco


def _capture_call(key: str, label: str, dev, fn, args, kwargs):
    """Run ``fn`` once under measurement and queue the measurement."""
    rec: dict = {"label": label, "key": key, "seconds": None, "peakBytes": None,
                 "workingBytes": None, "timer": None, "error": None}
    nested = getattr(_TL, "capturing", False)
    _TL.capturing = True
    on_card = dev is not None and dev.type == "cuda"
    start = end = None
    try:
        if on_card:
            import torch

            try:
                before = torch.cuda.memory_allocated(dev)
                if not nested:
                    torch.cuda.reset_peak_memory_stats(dev)
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            except RuntimeError as e:
                rec["error"] = f"capture start: {e}"
            out = fn(*args, **kwargs)
            if start is not None:
                try:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    peak = torch.cuda.max_memory_allocated(dev)
                    rec.update(peakBytes=float(peak), workingBytes=float(max(peak - before, 0)),
                               timer="cuda-events")
                except RuntimeError as e:
                    rec["error"] = f"capture end: {e}"
                    end = None
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            rec.update(seconds=time.perf_counter() - t0, timer="host-clock")
    finally:
        _TL.capturing = nested
    with _LOCK:
        if key not in _RECORDS and key not in _PENDING:
            _PENDING[key] = {"rec": rec, "start": start, "end": end}
    return out


def capture_pending() -> int:
    """Read the queued measurements into records (the optimizer's
    ``cost-capture`` phase). Waits for each capture's end event. Returns the
    number of records made. Never raises."""
    with _LOCK:
        pending = dict(_PENDING)
        _PENDING.clear()
    for key, entry in pending.items():
        rec = entry["rec"]
        if entry["end"] is not None:
            try:
                entry["end"].synchronize()
                rec["seconds"] = entry["start"].elapsed_time(entry["end"]) / 1e3
            except RuntimeError as e:
                rec["error"] = f"event read: {e}"
        with _LOCK:
            _RECORDS[key] = rec
    return len(pending)


def pending_count() -> int:
    with _LOCK:
        return len(_PENDING)


def records() -> dict[str, dict]:
    """The captured ledger (key -> record), a copy."""
    with _LOCK:
        return {k: dict(v) for k, v in _RECORDS.items()}


def exec_snapshot() -> dict[str, int]:
    """Cumulative per-shape call counts (a dict copy; spans snapshot this
    at start and end)."""
    with _LOCK:
        return dict(_CALLS)


def exec_delta(before: dict[str, int]) -> dict[str, int]:
    """Calls since ``before`` (keys with a positive delta only)."""
    now = exec_snapshot()
    return {k: n - before.get(k, 0) for k, n in now.items() if n > before.get(k, 0)}


# ----- the aggregates kernel's work -------------------------------------------------


def aggregates_work(P: int, R: int, B: int, T: int, D: int, n_valid: int,
                    n_replicas: int) -> tuple[float, float]:
    """(operations, bytes) of one broker-aggregates pass: every input it
    needs read once and every output written once, and at most 12 additions
    per replica (7 float, 5 int32). A padding partition costs only its
    ``partition_valid`` byte."""
    # assignment and replica_disk rows, leader_slot, partition_topic, and the
    # leader and follower loads of a live partition
    per_valid = R * 4 * 2 + 4 * 2 + 2 * 4 * 4
    read = P * 1 + n_valid * per_valid
    written = 4 * B * 4 + 4 * B * 4 + 2 * T * B * 4 + B * D * 4
    return float(12 * n_replicas), float(read + written)


class _CountsOnHost:
    """A model's live partition and replica counts, copied behind the
    queued work into pinned memory and read when first asked for."""

    def __init__(self, m) -> None:
        import torch

        counts = torch.stack([m.partition_valid.sum(), m.replica_valid.sum()])
        self.dims = (m.P, m.R, m.B, m.num_topics, m.D)
        self.event = None
        if counts.device.type == "cuda":
            self.host = torch.empty(2, dtype=counts.dtype, pin_memory=True)
            self.host.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = counts
        self._work = None

    def resolve(self) -> tuple[float, float]:
        if self._work is None:
            if self.event is not None:
                self.event.synchronize()
            n_valid, n_replicas = (int(v) for v in self.host.tolist())
            self._work = aggregates_work(*self.dims, n_valid, n_replicas)
        return self._work


def aggregates_work_of(m) -> _CountsOnHost:
    """The ``work`` of the ``broker-aggregates`` site."""
    return _CountsOnHost(m)


def aggregates_bound_ms(m, spec: dict | None = None) -> tuple[float, str]:
    """Least time for the aggregate pass on ``m`` and what sets it
    (``"bytes"`` or ``"operations"``), on ``spec`` (default: the live
    card's); the same reckoning the ``broker-aggregates`` program row uses.
    Reads the model's counts (a host read)."""
    flops, nbytes = aggregates_work_of(m).resolve()
    secs, bound = roofline_seconds(flops, nbytes, spec if spec is not None else device_spec(m.device))
    if secs is None:
        raise ValueError("no roofline for this device: its spec is not in DEVICE_SPECS")
    return 1e3 * secs, ("bytes" if bound == "memory" else "operations")


def _work_of(key: str):
    """(flops, bytes, loop iterations) of one call of ``key``, or None."""
    with _LOCK:
        entry = _WORK.get(key)
    if entry is None or entry[1] is None:
        return None
    flops, nbytes = entry[1].resolve()
    return flops, nbytes, entry[2]


# ----- roofline ----------------------------------------------------------------------


def device_kind(device=None) -> str:
    """The device's name: ``torch.cuda.get_device_name`` for a CUDA device
    (the current one when ``device`` is None and there is a card), else
    ``"cpu"``."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return str(torch.cuda.get_device_name(device))


def spec_for(kind: str) -> dict | None:
    """The table row for a device name (None: not an NVIDIA card the table
    holds, so no roofline)."""
    k = kind.lower()
    for needle, spec_key in _KIND_MATCHES:
        if needle in k:
            return {"key": spec_key, **DEVICE_SPECS[spec_key]}
    return None


def device_spec(device=None) -> dict:
    """The device's roofline ceilings: its table row, the operator override
    on top."""
    kind = device_kind(device)
    spec = spec_for(kind) or {"key": None, "peakFlops": None, "hbmBytesPerSec": None,
                              "hbmBytes": None}
    out = {"deviceKind": kind, **spec}
    with _LOCK:
        override = dict(_OVERRIDE)
    if override:
        out.update(override)
        out["source"] = "override"
    else:
        out["source"] = "table" if spec.get("key") else "unknown"
    return out


def roofline_seconds(flops, bytes_accessed, spec: dict):
    """(max(flops/peak, bytes/bandwidth), bound) with bound ``"compute"`` or
    ``"memory"``; (None, None) when neither input or no ceiling is known."""
    t_c = flops / spec["peakFlops"] if flops is not None and spec.get("peakFlops") else None
    t_m = (bytes_accessed / spec["hbmBytesPerSec"]
           if bytes_accessed is not None and spec.get("hbmBytesPerSec") else None)
    if t_c is None and t_m is None:
        return None, None
    if t_m is None:
        return t_c, "compute"
    if t_c is None:
        return t_m, "memory"
    return (t_m, "memory") if t_m >= t_c else (t_c, "compute")


def hbm_watermark_bytes() -> int:
    """The optimizer's peak device working set: the most the caching
    allocator has reserved on the current CUDA device (0 without one)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.max_memory_reserved())


#: config-layer override of the fleet snapshot budget (the facade wires
#: ``optimizer.fleet.snapshot.hbm.mb`` here; None = no override)
_FLEET_HBM_MB: float | None = None


def set_fleet_hbm_budget(mb: float | None) -> None:
    """Config hook (``optimizer.fleet.snapshot.hbm.mb``): 0/None restores
    the derived budget."""
    global _FLEET_HBM_MB
    _FLEET_HBM_MB = float(mb) if mb else None


def fleet_snapshot_budget_bytes(explicit_mb: float | None = None) -> int:
    """The device-memory budget with no ledger override: ``explicit_mb``,
    else the config hook's value (``set_fleet_hbm_budget``), else
    ``CCX_FLEET_HBM_MB`` when set, else half of (the card's capacity, from
    ``torch.cuda.mem_get_info``, minus ``hbm_watermark_bytes``), floor 64 MB;
    unlimited without a card (entries then live in host memory, which the
    ledger does not bound)."""
    if explicit_mb is None:
        explicit_mb = _FLEET_HBM_MB
    if explicit_mb is None:
        env = os.environ.get(ENV_FLEET_HBM_MB)
        explicit_mb = float(env) if env else None
    if explicit_mb is not None and explicit_mb > 0:
        return int(explicit_mb * 1e6)
    import torch

    if not torch.cuda.is_available():
        return sys.maxsize
    _, capacity = torch.cuda.mem_get_info()
    budget = (float(capacity) - hbm_watermark_bytes()) / 2.0
    return int(max(budget, MIN_BUDGET_BYTES))


# ----- projections -------------------------------------------------------------------


def projection(delta: dict[str, int], specs: dict[str, dict] | None = None) -> dict:
    """Roll an execution delta (shape key -> calls) up: per-label totals,
    roofline seconds per spec, allocator peak of the captured calls, and
    coverage (calls whose shape has no record are counted, never guessed
    at). A label whose calls share one shape with known work also carries
    ``boundMsPerCall``, the roofline of one call on the first spec."""
    if specs is None:
        specs = {"device": device_spec()}
    with _LOCK:
        recs = {k: _RECORDS.get(k) for k in delta}
    programs: dict[str, dict] = {}
    totals = {"calls": 0, "flops": None, "bytesAccessed": None}
    peak = None
    uncaptured = captured = 0
    per_call: dict[str, list] = {}
    for key, calls in delta.items():
        label = key.rsplit("#", 1)[0]
        slot = programs.setdefault(label, {
            "calls": 0, "shapes": 0, "flops": None, "bytesAccessed": None,
            "hbmPeakBytes": None, "captured": False, "sampleSeconds": None})
        slot["calls"] += calls
        slot["shapes"] += 1
        totals["calls"] += calls
        work = _work_of(key)
        if work is not None:
            flops, nbytes, iters = work
            mult = calls * iters
            for field, v in (("flops", flops), ("bytesAccessed", nbytes)):
                slot[field] = (slot[field] or 0.0) + v * mult
                totals[field] = (totals[field] or 0.0) + v * mult
            per_call.setdefault(label, []).append((flops * iters, nbytes * iters))
        rec = recs.get(key)
        if rec is None:
            uncaptured += calls
            continue
        captured += 1
        slot["captured"] = True
        if rec.get("seconds") is not None:
            slot["sampleSeconds"] = (slot["sampleSeconds"] or 0.0) + rec["seconds"]
        if rec.get("peakBytes") is not None:
            slot["hbmPeakBytes"] = max(slot["hbmPeakBytes"] or 0.0, rec["peakBytes"])
            peak = max(peak or 0.0, rec["peakBytes"])
    proj = {}
    for name, spec in specs.items():
        secs, bound = roofline_seconds(totals["flops"], totals["bytesAccessed"], spec)
        proj[name] = {"seconds": secs, "bound": bound}
    first = next(iter(specs.values()))
    for label, slot in programs.items():
        slot["projectedSeconds"] = {
            name: roofline_seconds(slot["flops"], slot["bytesAccessed"], spec)[0]
            for name, spec in specs.items()
        }
        one = per_call.get(label)
        if one is not None and len(one) == 1 and slot["shapes"] == 1:
            secs = roofline_seconds(one[0][0], one[0][1], first)[0]
            slot["boundMsPerCall"] = None if secs is None else 1e3 * secs
    return {
        "totals": {**totals, "hbmPeakBytes": peak},
        "projected": proj,
        "programs": programs,
        "coverage": {"programsExecuted": len(delta), "programsCaptured": captured,
                     "callsUncaptured": uncaptured},
    }


def projection_compact(delta: dict[str, int], device=None) -> dict | None:
    """The rollup a phase span carries: projected device seconds on the
    device, the captured calls' allocator peak, call counts. None for an
    empty delta (a host-only phase)."""
    if not delta:
        return None
    p = projection(delta, {"device": device_spec(device)})
    dev = p["projected"]["device"]
    out = {
        "calls": p["totals"]["calls"],
        "flops": p["totals"]["flops"],
        "bytesAccessed": p["totals"]["bytesAccessed"],
        "projectedSeconds": dev["seconds"],
        "bound": dev["bound"],
        "hbmPeakBytes": p["totals"]["hbmPeakBytes"],
    }
    if p["coverage"]["callsUncaptured"]:
        out["callsUncaptured"] = p["coverage"]["callsUncaptured"]
    return out


def cost_model_json(delta: dict[str, int], span_tree: dict | None = None, device=None) -> dict:
    """The ``OptimizerResult.cost_model`` block: the device's spec and
    roofline projections rolled up per program and per phase (each phase
    span carries its own rollup). Machine-dependent by construction."""
    spec = device_spec(device)
    p = projection(delta, {"device": spec})
    phases = {}
    for child in (span_tree or {}).get("children", ()):
        if child.get("kind") == "phase" and child.get("costModel"):
            phases[child["name"]] = child["costModel"]
    return {
        "device": spec,
        "totals": p["totals"],
        "projected": p["projected"],
        "programs": p["programs"],
        "coverage": p["coverage"],
        **({"phases": phases} if phases else {}),
    }


# ----- export ------------------------------------------------------------------------


def summary() -> dict:
    """The ledger: capture state, records, live call totals."""
    with _LOCK:
        recs = {k: dict(v) for k, v in _RECORDS.items()}
        calls = dict(_CALLS)
        pending = len(_PENDING)
    return {
        "captureEnabled": capture_enabled(),
        "device": device_spec(),
        "programsSeen": len(calls),
        "programsCaptured": len(recs),
        "programsPending": pending,
        "records": recs,
        "calls": calls,
    }


def export_gauges(registry=None) -> None:
    """The observatory's gauges on the metrics registry (idempotent):
    captured and pending shapes, and the projected device seconds of every
    call so far on the live card. Projected seconds far below the wall is
    the signature of a host-bound run."""
    if registry is None:
        from ccx_torch.common.metrics import REGISTRY as registry  # noqa: N811

    def _projected_total() -> float:
        p = projection(exec_snapshot())
        return float(p["projected"]["device"]["seconds"] or 0.0)

    def _captured() -> float:
        with _LOCK:
            return float(len(_RECORDS))

    registry.gauge("cost-programs-captured", _captured,
                   help="program shapes with a captured device-time record")
    registry.gauge("cost-programs-pending", lambda: float(pending_count()),
                   help="program shapes measured and waiting for their events to be read")
    registry.gauge("cost-projected-device-seconds", _projected_total,
                   help="roofline-projected device seconds of every instrumented call so far "
                        "(live card spec)")
