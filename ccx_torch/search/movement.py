"""Movement planning: an execution plan for every proposal.

A proposal's real cost is the bytes it moves and how long the cluster stays
degraded while they move. ``plan_movement`` orders a columnar diff's rows
into execution waves under per-broker concurrent-move caps and per-wave
per-broker byte budgets: rows in largest-bytes-first (LPT) order, each
placed by the lexicographic wave rule of ``_plan_numpy`` (avoid raising the
schedule-wide peak inflow, then least bottleneck growth, then lowest
resulting destination inflow, earliest wave on full ties).
``movement_cost(before, after)`` is the movement-cost tier of the lex
objective: (bytes moved, peak per-broker inbound bytes).

Two backends implement the same deterministic greedy and give equal
arrays: the numpy oracle ``_plan_numpy``, and ``_plan_device``, a loop of
torch ops over the rows on a device (the card, or the CPU), whose wave
state stays on that device until the loop ends. The backend is chosen by
``CCX_DEVICE_PLAN`` (``0`` numpy, ``1`` device) or else by the diff's size
(``DEVICE_PLAN_MIN_ROWS``). A failure of either propagates.

Scheduling unit = one diff row (partition): the executor starts every
destination replica of a partition at once. A row's cost is its
per-replica disk footprint (the DISK resource row is role-independent);
each destination broker receives that many bytes, each vacated source
broker sends them. Schedules are priced under a round-barrier fluid model:
a wave completes before the next starts, and lasts the slowest broker's
``max(inbound, outbound) / throttle_rate``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ccx_torch.common import costmodel

#: ``CCX_DEVICE_PLAN=0`` routes every plan through the numpy oracle, ``=1``
#: forces the device loop; unset applies the size gate below
ENV_DEVICE_PLAN = "CCX_DEVICE_PLAN"

#: diff rows from which the device loop plans by default: below it the
#: numpy oracle takes milliseconds
DEVICE_PLAN_MIN_ROWS = 4096

#: padded partitions from which ``movement_cost`` runs on the model's
#: device by default
DEVICE_COST_MIN_P = 8192


def _backend(env_var: str, device_default: bool) -> str:
    env = os.environ.get(env_var)
    if env == "0":
        return "numpy"
    if env == "1":
        return "device"
    return "device" if device_default else "numpy"


@dataclasses.dataclass(frozen=True)
class PlanOptions:
    """Wave-planner knobs.

    ``broker_cap`` mirrors ``num.concurrent.partition.movements.per.
    broker`` (a broker participates in at most this many concurrent
    partition movements per wave, as source or destination).
    ``wave_bytes`` is the per-broker per-wave byte budget in model load
    units (MB) — the replication-throttle image: at throttle rate R and a
    target wave duration T, set ``wave_bytes ≈ R*T``; <=0 = uncapped
    (count caps only). ``throttle_mb_per_sec`` prices the projected wave
    durations; <=0 reports makespan in relative byte units (rate 1)."""

    broker_cap: int = 5
    wave_bytes: float = 0.0
    max_waves: int = 64
    throttle_mb_per_sec: float = 0.0
    #: None = env/size gate; "numpy"/"device" force a path
    backend: str | None = None


@dataclasses.dataclass
class MovementPlan:
    """A scheduled execution plan over one columnar diff.

    ``wave`` is ALIGNED with the diff's row order (``wave[i]`` schedules
    diff row i) — the executor's tasks are built from the same rows, so
    consumption is an O(1) lookup per task. Rows with no inter-broker
    movement (pure leadership / intra-broker disk rows) carry wave 0 and
    zero scheduled bytes."""

    wave: np.ndarray              #: int32[N], aligned with diff rows
    partition: np.ndarray         #: int32[N], the diff's partition column
    moves: np.ndarray             #: int32[N] replicas entering new brokers
    move_bytes: np.ndarray        #: float32[N] bytes per moving replica
    wave_bytes: np.ndarray        #: float32[W] total bytes entering per wave
    wave_inflow_peak: np.ndarray  #: float32[W] max per-broker inbound bytes
    wave_outflow_peak: np.ndarray  #: float32[W] max per-broker outbound bytes
    n_waves: int
    #: rows that fit no feasible wave and were forced into the last one
    #: (max_waves too small for the diff at these caps)
    overflow_rows: int
    backend: str
    opts: PlanOptions

    # ----- derived metrics --------------------------------------------------

    @property
    def n_moves(self) -> int:
        return int(self.moves.sum())

    @property
    def bytes_moved(self) -> float:
        return float(self.wave_bytes.sum())

    @property
    def peak_inflow(self) -> float:
        """Max per-broker inbound bytes of any single wave — the
        concurrent-inflow pressure the schedule ever puts on one broker."""
        return float(self.wave_inflow_peak.max(initial=0.0))

    @property
    def wave_seconds(self) -> np.ndarray:
        """Projected duration per wave under the round-barrier fluid
        model: the slowest broker's max(in, out) bytes over the throttle
        rate (rate <= 0 → relative byte units)."""
        rate = self.opts.throttle_mb_per_sec
        peak = np.maximum(self.wave_inflow_peak, self.wave_outflow_peak)
        return peak / np.float32(rate if rate > 0 else 1.0)

    @property
    def makespan_seconds(self) -> float:
        return float(self.wave_seconds.sum())

    # ----- serialization ----------------------------------------------------

    def summary_json(self) -> dict:
        """The additive ``plan`` result block: scalars + per-wave profile
        (never the per-row arrays — those ride the columnar wire blob)."""
        return {
            "nWaves": int(self.n_waves),
            "nMoves": self.n_moves,
            "bytesMoved": round(self.bytes_moved, 3),
            "peakInflowMb": round(self.peak_inflow, 3),
            "makespanSeconds": round(self.makespan_seconds, 3),
            "overflowRows": int(self.overflow_rows),
            "backend": self.backend,
            "brokerCap": int(self.opts.broker_cap),
            "waveBytesBudgetMb": float(self.opts.wave_bytes),
            "throttleMbPerSec": float(self.opts.throttle_mb_per_sec),
            "waveBytesMb": [round(float(x), 3) for x in self.wave_bytes],
            "waveInflowPeakMb": [
                round(float(x), 3) for x in self.wave_inflow_peak
            ],
            "waveSeconds": [round(float(x), 3) for x in self.wave_seconds],
        }

    def wire_cols(self) -> dict[str, np.ndarray]:
        """The flat typed arrays of the columnar result path
        (``planColumnar``): the row-aligned wave/partition columns plus the
        per-wave profiles, ``pack_arrays``-ready."""
        return {
            "wave": self.wave.astype(np.int32),
            "partition": self.partition.astype(np.int32),
            "moves": self.moves.astype(np.int32),
            "moveBytes": self.move_bytes.astype(np.float32),
            "waveBytes": self.wave_bytes.astype(np.float32),
            "waveInflowPeak": self.wave_inflow_peak.astype(np.float32),
            "waveOutflowPeak": self.wave_outflow_peak.astype(np.float32),
        }


# ----- movement-cost tier ----------------------------------------------------


def _cost_numpy(a0, a1, pvalid, bytes_pp, B: int):
    a0 = np.asarray(a0)
    a1 = np.asarray(a1)
    member = (a1[:, :, None] == a0[:, None, :]).any(axis=2)
    dst = (a1 >= 0) & ~member & np.asarray(pvalid)[:, None]
    b = np.where(dst, np.asarray(bytes_pp, np.float32)[:, None], np.float32(0))
    inflow = np.zeros(B, np.float32)
    np.add.at(inflow, np.clip(a1, 0, B - 1).reshape(-1), b.reshape(-1))
    return float(b.sum(dtype=np.float64)), float(inflow.max(initial=0.0))


def _cost_device(before, after) -> tuple[float, float]:
    """``_cost_numpy`` in torch ops on the models' device."""
    from ccx_torch.common.resources import Resource

    a0, a1 = before.assignment, after.assignment
    B = int(before.B)
    member = (a1[:, :, None] == a0[:, None, :]).any(2)
    dst = (a1 >= 0) & ~member & before.partition_valid[:, None]
    b = torch.where(dst, before.leader_load[Resource.DISK][:, None], 0.0)
    inflow = torch.zeros(B, dtype=torch.float32, device=b.device)
    inflow.index_add_(0, a1.clamp(0, B - 1).reshape(-1).long(), b.reshape(-1))
    return float(b.sum()), float(inflow.max())


def movement_cost(before, after, backend: str | None = None) -> tuple[float, float]:
    """The movement-cost tier of a candidate placement: ``(bytes moved,
    peak per-broker inbound bytes)`` of ``before -> after``. On the models'
    device from ``DEVICE_COST_MIN_P`` padded partitions (or as
    ``CCX_DEVICE_PLAN`` says), else the numpy reference."""
    from ccx_torch.common.resources import Resource

    if backend is None:
        backend = _backend(ENV_DEVICE_PLAN, int(before.P) >= DEVICE_COST_MIN_P)
    if backend == "device":
        return _cost_device(before, after)
    return _cost_numpy(
        before.assignment.cpu().numpy(), after.assignment.cpu().numpy(),
        before.partition_valid.cpu().numpy(),
        before.leader_load[Resource.DISK].cpu().numpy(), int(before.B),
    )


# ----- wave planner ----------------------------------------------------------


def _prepare(cols: dict, bytes_pp: np.ndarray | None):
    """Host-side planning inputs from the diff columns: per-row source /
    destination broker slots (-1 pad), per-replica bytes, and the
    deterministic processing order (largest-bytes-first, partition-index
    tie-break — the LPT rule both backends replay identically)."""
    old = np.asarray(cols["oldReplicas"], np.int32)
    new = np.asarray(cols["newReplicas"], np.int32)
    part = np.asarray(cols["partition"], np.int32)
    if old.size == 0:
        z = np.zeros((0,), np.int32)
        return z.reshape(0, 1), z.reshape(0, 1), np.zeros(0, np.float32), z
    in_old = (new[:, :, None] == old[:, None, :]).any(axis=2)
    in_new = (old[:, :, None] == new[:, None, :]).any(axis=2)
    dst = np.where((new >= 0) & ~in_old, new, -1).astype(np.int32)
    src = np.where((old >= 0) & ~in_new, old, -1).astype(np.int32)
    if bytes_pp is not None:
        b = np.asarray(bytes_pp, np.float32)[part]
    else:
        b = np.ones(part.shape[0], np.float32)
    # rows with no inter-broker movement cost nothing and pin to wave 0
    b = np.where((dst >= 0).any(axis=1), b, np.float32(0)).astype(np.float32)
    order = np.lexsort((part, -b)).astype(np.int32)
    return src, dst, b, order


@costmodel.instrument("plan-waves")
def _plan_numpy(src, dst, b, order, W: int, B: int, cap: int, budget: float):
    """The reference greedy (the correctness pin): for each row in LPT
    order, among the waves where every involved broker is below the
    concurrent-move cap and the row's bytes fit the per-broker byte
    budget (a broker with nothing scheduled in a wave always admits one
    row, so an over-budget single row still schedules), pick the wave
    whose round-barrier bottleneck — ``max_b max(in, out)`` — grows the
    LEAST, earliest wave on ties. That is LPT least-loaded packing: big
    rows land first where they raise no wave's duration, which minimizes
    the fluid-model makespan AND spreads concurrent inflow instead of
    piling the largest rows onto one broker's wave-0 cap. No feasible
    wave → the last wave, counted as overflow. float32 accumulation
    throughout; cross-broker reductions happen once on the host
    (``plan_movement``) — equal arrays from the device loop."""
    n = order.shape[0]
    cnt = np.zeros((W, B), np.int32)
    inb = np.zeros((W, B), np.float32)
    outb = np.zeros((W, B), np.float32)
    peak = np.zeros(W, np.float32)  # per-wave bottleneck max_b max(in,out)
    p_in = np.float32(0)  # schedule-wide peak per-broker inflow so far
    inf = np.float32(np.inf)
    wave = np.zeros(n, np.int32)
    overflow = 0
    bud = np.float32(budget)
    for i in order.tolist():
        d = dst[i][dst[i] >= 0]
        s = src[i][src[i] >= 0]
        bi = np.float32(b[i])
        ok = (cnt[:, d] < cap).all(axis=1) & (cnt[:, s] < cap).all(axis=1)
        ok &= ((inb[:, d] + bi <= bud) | (inb[:, d] <= 0)).all(axis=1)
        ok &= ((outb[:, s] + bi <= bud) | (outb[:, s] <= 0)).all(axis=1)
        if ok.any():
            cand_in = (
                (inb[:, d] + bi).max(axis=1) if d.size
                else np.zeros(W, np.float32)
            )
            cand_out = (
                (outb[:, s] + bi).max(axis=1) if s.size
                else np.zeros(W, np.float32)
            )
            cand = np.maximum(cand_in, cand_out)
            # lexicographic wave choice, earliest wave on full ties:
            # (1) never raise the schedule-wide peak inflow when some
            #     feasible wave avoids it (a dominant source outflow must
            #     not hide inflow stacking under a "free" makespan move);
            # (2) least growth of that wave's round-barrier bottleneck —
            #     the greedy-makespan term;
            # (3) lowest resulting destination inflow (balance).
            raise_in = np.where(ok, np.maximum(cand_in - p_in, 0), inf)
            t1 = ok & (raise_in == raise_in.min())
            grow = np.where(t1, np.maximum(peak, cand) - peak, inf)
            t2 = t1 & (grow == grow.min())
            w = int(np.argmin(np.where(t2, cand_in, inf)))
        else:
            w = W - 1
            overflow += 1
        cnt[w, d] += 1
        cnt[w, s] += 1
        inb[w, d] += bi
        outb[w, s] += bi
        new_in = inb[w, d].max() if d.size else np.float32(0)
        new_out = outb[w, s].max() if s.size else np.float32(0)
        peak[w] = max(peak[w], new_in, new_out)
        p_in = max(p_in, new_in)
        wave[i] = w
    return wave, inb, outb, overflow


@costmodel.instrument("plan-waves")
def _plan_device(src, dst, b, order, W: int, B: int, cap: int, budget: float, device):
    """The oracle's greedy as a loop of torch ops over the rows on
    ``device``: the rows are copied there once, the [W, B] per-wave broker
    state stays there, and the waves and accumulators come back once at the
    end (no host read inside the loop). Infeasible rows go to the last wave
    and count as overflow. Returns the oracle's tuple."""
    dev = torch.device(device)
    n = order.shape[0]
    dst_t = torch.from_numpy(np.ascontiguousarray(dst)).long().to(dev)
    src_t = torch.from_numpy(np.ascontiguousarray(src)).long().to(dev)
    b_t = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev)
    dval_t, sval_t = dst_t >= 0, src_t >= 0
    dcl_t, scl_t = dst_t.clamp(0, B - 1), src_t.clamp(0, B - 1)
    f32 = dict(dtype=torch.float32, device=dev)
    cnt = torch.zeros(W, B, dtype=torch.int32, device=dev)
    inb = torch.zeros(W, B, **f32)
    outb = torch.zeros(W, B, **f32)
    peak = torch.zeros(W, **f32)
    p_in = torch.zeros((), **f32)
    wave = torch.zeros(n, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    inf = float("inf")
    last = torch.full((), W - 1, dtype=torch.long, device=dev)
    for i in order.tolist():
        dval, sval, dcl, scl, bi = dval_t[i], sval_t[i], dcl_t[i], scl_t[i], b_t[i]
        in_d, out_s = inb[:, dcl], outb[:, scl]
        ok = (
            torch.where(dval[None, :], cnt[:, dcl] < cap, True).all(1)
            & torch.where(sval[None, :], cnt[:, scl] < cap, True).all(1)
            & torch.where(dval[None, :], (in_d + bi <= budget) | (in_d <= 0), True).all(1)
            & torch.where(sval[None, :], (out_s + bi <= budget) | (out_s <= 0), True).all(1)
        )
        feasible = ok.any()
        cand_in = torch.where(dval[None, :], in_d + bi, 0.0).amax(1)
        cand_out = torch.where(sval[None, :], out_s + bi, 0.0).amax(1)
        cand = torch.maximum(cand_in, cand_out)
        raise_in = torch.where(ok, (cand_in - p_in).clamp(min=0.0), inf)
        t1 = ok & (raise_in == raise_in.min())
        grow = torch.where(t1, torch.maximum(peak, cand) - peak, inf)
        t2 = t1 & (grow == grow.min())
        w = torch.where(feasible, torch.where(t2, cand_in, inf).argmin(), last).reshape(1)
        wr = w.expand(dcl.shape[0])
        cnt.index_put_((wr, dcl), dval.int(), accumulate=True)
        cnt.index_put_((wr, scl), sval.int(), accumulate=True)
        inb.index_put_((wr, dcl), torch.where(dval, bi, 0.0), accumulate=True)
        outb.index_put_((wr, scl), torch.where(sval, bi, 0.0), accumulate=True)
        new_in = torch.where(dval, inb.index_select(0, w)[0, dcl], 0.0).amax()
        new_out = torch.where(sval, outb.index_select(0, w)[0, scl], 0.0).amax()
        peak.index_copy_(0, w, torch.maximum(peak.index_select(0, w), torch.maximum(new_in, new_out)))
        p_in = torch.maximum(p_in, new_in)
        wave[i] = w[0]
        overflow += (~feasible).int()
    return wave.cpu().numpy(), inb.cpu().numpy(), outb.cpu().numpy(), int(overflow)


def plan_movement(
    diff,
    bytes_per_partition,
    n_brokers: int,
    opts: PlanOptions = PlanOptions(),
    device=None,
) -> MovementPlan:
    """Schedule a columnar diff into execution waves.

    ``diff`` is a ``ccx_torch.proposals.ColumnarDiff`` or its ``cols``
    dict; ``bytes_per_partition`` the float32[P] per-replica disk footprint
    (a numpy array or a tensor; None: unit bytes); ``n_brokers`` the broker
    axis of the per-wave state; ``device`` where the device loop runs
    (default: the tensor's device, else the CPU). The backend is
    ``opts.backend``, else ``CCX_DEVICE_PLAN``, else the device loop from
    ``DEVICE_PLAN_MIN_ROWS`` rows."""
    if torch.is_tensor(bytes_per_partition):
        if device is None:
            device = bytes_per_partition.device
        bytes_per_partition = bytes_per_partition.cpu().numpy()
    cols = diff.cols if hasattr(diff, "cols") else diff
    src, dst, b, order = _prepare(cols, bytes_per_partition)
    part = np.asarray(cols["partition"], np.int32)
    n = part.shape[0]
    W = max(int(opts.max_waves), 1)
    cap = max(int(opts.broker_cap), 1)
    budget = float(opts.wave_bytes) if opts.wave_bytes > 0 else np.inf
    backend = opts.backend or _backend(ENV_DEVICE_PLAN, n >= DEVICE_PLAN_MIN_ROWS)
    if n == 0:
        z = np.zeros(0, np.float32)
        return MovementPlan(
            wave=np.zeros(0, np.int32), partition=part,
            moves=np.zeros(0, np.int32), move_bytes=z,
            wave_bytes=z, wave_inflow_peak=z, wave_outflow_peak=z,
            n_waves=0, overflow_rows=0, backend="empty", opts=opts,
        )
    if backend == "device":
        wave, inb, outb, overflow = _plan_device(
            src, dst, b, order, W, int(n_brokers), cap, budget, device or "cpu"
        )
    else:
        wave, inb, outb, overflow = _plan_numpy(
            src, dst, b, order, W, int(n_brokers), cap, budget
        )
    # cross-broker reductions on the host, from the equal [W, B]
    # accumulators: the per-wave profiles never differ between backends
    wb = inb.sum(axis=1, dtype=np.float32)
    wip = inb.max(axis=1, initial=0.0)
    wop = outb.max(axis=1, initial=0.0)
    n_waves = int(wave.max(initial=0)) + 1
    return MovementPlan(
        wave=np.asarray(wave, np.int32),
        partition=part,
        moves=(dst >= 0).sum(axis=1).astype(np.int32),
        move_bytes=np.asarray(b, np.float32),
        wave_bytes=np.asarray(wb, np.float32)[:n_waves],
        wave_inflow_peak=np.asarray(wip, np.float32)[:n_waves],
        wave_outflow_peak=np.asarray(wop, np.float32)[:n_waves],
        n_waves=n_waves,
        overflow_rows=int(overflow),
        backend=backend,
        opts=opts,
    )


# ----- naive executor baseline ----------------------------------------------


def naive_schedule(
    diff,
    bytes_per_partition: np.ndarray | None,
    n_brokers: int,
    cap: int = 5,
    throttle_mb_per_sec: float = 0.0,
    max_cluster_movements: int | None = None,
) -> dict:
    """The legacy executor's batching, priced under the same round-barrier
    fluid model as the planner: repeated ``inter_broker_batch``-style
    rounds (task-id order, skip rows whose src/dst broker is at the
    per-broker cap, optional cluster-wide budget), each round's duration
    = the slowest broker's max(in, out) bytes over the throttle rate.
    The planner's baseline."""
    cols = diff.cols if hasattr(diff, "cols") else diff
    src, dst, b, _ = _prepare(cols, bytes_per_partition)
    n = src.shape[0]
    rate = np.float32(
        throttle_mb_per_sec if throttle_mb_per_sec > 0 else 1.0
    )
    moving = [i for i in range(n) if (dst[i] >= 0).any()]
    pending = list(moving)  # task-id (diff-row) order, like the tracker
    rounds = 0
    makespan = np.float32(0)
    peak_inflow = np.float32(0)
    round_seconds: list[float] = []
    budget = (
        int(max_cluster_movements) if max_cluster_movements else n + 1
    )
    while pending:
        cnt = np.zeros(n_brokers, np.int32)
        inb = np.zeros(n_brokers, np.float32)
        outb = np.zeros(n_brokers, np.float32)
        batch: list[int] = []
        rest: list[int] = []
        for i in pending:
            d = dst[i][dst[i] >= 0]
            s = src[i][src[i] >= 0]
            if (
                len(batch) < budget
                and (cnt[d] < cap).all()
                and (cnt[s] < cap).all()
            ):
                cnt[d] += 1
                cnt[s] += 1
                inb[d] += np.float32(b[i])
                outb[s] += np.float32(b[i])
                batch.append(i)
            else:
                rest.append(i)
        if not batch:  # cap <= 0 pathology: avoid spinning forever
            break
        rounds += 1
        peak_inflow = max(peak_inflow, np.float32(inb.max(initial=0.0)))
        dur = np.float32(
            max(inb.max(initial=0.0), outb.max(initial=0.0))
        ) / rate
        round_seconds.append(float(dur))
        makespan = np.float32(makespan + dur)
        pending = rest
    return {
        "rounds": rounds,
        "makespanSeconds": float(makespan),
        "peakInflowMb": float(peak_inflow),
        "roundSeconds": [round(s, 3) for s in round_seconds],
        "nMoves": int(sum((dst[i] >= 0).sum() for i in moving)),
    }
