#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ccx_torch``) on one NVIDIA GPU.

Phases, one JSON line each:

1. device — the card's name, count and ``nvidia-smi`` name/power limit,
   and whether ``grpc`` and ``msgpack`` import (with their versions); the
   port's liveness probe (``ccx_torch.device.ensure_responsive_backend``,
   a subprocess) must pass; TF32 off for matrix products and convolutions;
2. build — the hand-written CUDA kernels, compiled with nvcc for sm_90a from
   the sources in this checkout, with their build time;
3. kernel checks — each kernel against its plain PyTorch version on the
   card: B5 (1000 brokers / 100k partitions), B5 with its partitions in a
   seeded random order (which must also equal B5 on every integer field),
   a B4-style JBOD fixture (4 disks per broker), a dead-broker fixture (B3),
   sparse 4000- and 8000-broker fixtures, and two calls in a row on two
   B5-shaped models (the second gets the first's freed output buffer,
   filled with a non-zero pattern in between). Every fixture runs the
   kernel as it chooses and with each of its two ways of summing the
   per-broker rows forced (shared memory, global), with each plan reported.
   Integers must match exactly, floats within rtol 1e-5 / atol 1e-3 (float
   sums are taken with atomics in a run-dependent order);
4. main path — ``ccx_torch.optimizer.optimize`` on B5 with the full
   default goal stack at the bench's "target" rung, built by
   ``ccx_torch.rungs.build_opts("B5", "target")`` (16 chains x 250 steps x 8
   moves at the JAX defaults: ``p_swap=0.15``, the batched SA step,
   usage-coupled swaps; polish 150 iterations patience 8, leader pass 100;
   no topic-rebalance stage, no portfolio): wall and phase seconds,
   violations before and after, ``verified``, the SA engine, the move
   counters and the kernel launch counts of this run; the final stack is
   re-scored with the plain aggregates;
5. lean path — the same on B5 at the "lean" rung, not shrunk (16 chains x
   500 steps x 8 moves; the pre-shed polish skipped; one topic-rebalance
   round of up to 1024 sweeps with leader moves and a guarded
   700-iteration re-polish; swap polish 150 + 300 iterations with 128
   candidates, guarded; leader pass 150), with the same line and checks;
6. warm path — the steady-state loop at B5, full width: ``main-path``'s
   verified result banked as the session's warm base (``remember``), then
   2 + 20 metrics windows (the bench's drift rule, 1% of the partitions'
   loads by +-50%, seed 123, cumulative; the snapshot keeps the applied
   placement), each ``optimize(..., warm_start=STORE.get(session))`` at the
   target rung with ``rungs.steady_options()`` and the movement plan, and
   re-banked from ``warm_pressure``. Per window: wall and phase seconds,
   touched brokers, diff rows, any revert, the plan's waves and backend,
   ``verified``, hard violations, aggregates launches; each window's diff is
   also planned with the device loop forced and held array-exact against
   the numpy oracle, as is the shipped plan. Over the 20 measured windows
   (the first 2 warm up): p50 and p99 of the wall and the card's memory
   peak. Fails on a window that is not warm-started, unverified, has a
   hard violation or ships a stack significantly lex-worse than its base;
7. structural window — one more window on the drifted B5 with 2 live
   brokers marked dead: it must repair, run the plateau-terminated warm SA
   over the targeted hot list and the swap polish, verify with no hard
   violation and leave no replica on a dead broker; the plateau report,
   chunks run against the budget, offenders and wall;
8. ladder — SA on the repaired B5 at the target rung's budget (16 chains x
   250 steps x 8 moves) in chunks of 25, with ``n_temps=4`` and with
   ``n_temps=1``: wall, exchange attempts and accepts from the taps, and the
   result's stack;
9. sidecar serve — the port's sidecar (``ccx_torch.sidecar.server``) on
   ``127.0.0.1:0`` in this process, driven by the port's gRPC client
   (in process through the byte-identity handlers when ``grpc`` does not
   import): a full PutSnapshot of B5, a streamed cold Propose at the target
   rung's options (``rungs.wire_options``), a repeat Propose of the same
   generation (which must take its input-side stats from the memo), then
   10 windows of the drift rule, each a metric-only delta PutSnapshot and a
   warm Propose (``rungs.steady_options``). Every result must verify with
   zero hard violations, the streamed segments must reassemble to the
   columns the server packed, every delta must be grafted (none rebuilt)
   and every Propose must launch the aggregates kernel. The flight recorder
   is armed for the phase; its summary must name every phase of the cold
   Propose. Put, round-trip and wire-overhead seconds, segments,
   ``DEVMEM.stats()`` and the card's memory peak;
10. sidecar options — the same sidecar path with the three options the port
   once refused (``repair_backend="host"``, ``overlap_repair=true``,
   ``polish_swap_fraction=0.25``) and the cost ledger's capture armed: a
   full PutSnapshot of B5, a streamed cold Propose at the target rung, its
   250 SA steps in two chunks of 125 so the overlap runs (it
   must verify with zero hard violations, run the ``repair-join``,
   ``repair-concurrent`` and ``cost-capture`` phases, and carry a
   ``costModel`` naming the card with ``broker-aggregates``, ``sa-chunk``
   and ``polish-chunk`` rows, and phase spans with the cost rollup), a
   repeat of it (memo hit: no new record), a delta and one warm window (no
   ``cost-capture`` phase, no new record); then the ``compile-*`` and
   ``cost-*`` gauges must be on the registry and show the kernel's build.
   Phase seconds beside ``sidecar-serve``'s default cold Propose, the
   polish's accepted moves by kind, launches, and the ``broker-aggregates``
   row's bound, which must equal the ``kernels`` line's ``bound_ms``;
11. fleet — two sessions of B3 with priorities 0 and 5 Propose at once
   through the fleet scheduler under a registry budget of 1.5 models,
   so the urgent job's build evicts the other's: both verify, each gets
   chunk grants while the other is registered, the evicted session's next
   Propose rebuilds and verifies (and gives one job's time alone), the pair
   runs again at dispatch width 8 for its seconds, and a job cancelled
   mid-anneal raises ``JobCancelled`` and leaves the run queue;
12. service — the port's REST service over B5: a ``SimulatedCluster`` with
   B5's brokers, racks and placement, its per-broker capacities in a
   capacity file (``FileCapacityResolver``, named by the JAX package's
   class path, which resolves under ``ccx_torch``), and a sampler here
   (``B5Sampler``) replaying B5's per-partition leader loads; the port's
   ``CruiseControl`` on the card and its ``CruiseControlApp`` on
   ``127.0.0.1:0`` in this process. 4 metrics windows are sampled (seconds
   each), the monitor's model is built (seconds) and its per-broker
   replica and leader counts, from the kernel, must equal B5's. Through
   the port's REST client: ``state``, ``load`` (its per-broker counts equal
   the model's) and ``kafka_cluster_state`` answer 200; a dry-run
   ``rebalance`` at the target rung, set through the façade's config keys
   (the façade's options must equal ``rungs.build_opts("B5", "target")``),
   long-polls its 202 and must verify with zero hard violations (its wall,
   phase seconds and round trip beside ``main-path``'s wall); one
   detection round (``anomaly_detector.run_once``: anomalies by type); one
   more window, then ``proposals`` with ``ignore_proposal_cache``, which
   must warm-start from the base the dry run banked and verify. Then a
   second façade on the demo cluster of ``ccx_torch.main.build_demo_admin``
   (topic demo-a skewed onto brokers 0 and 1) executes a rebalance, which
   must drain. No ``jax`` or ``ccx`` module may have been loaded. Whether
   the native host scatter ran (``ccx_torch.native.state()``) and the
   card's memory peak;
13. result check — a small cluster's stack on the card held against the same
   stack on the CPU, and three batched SA steps on a 64-broker cluster (3
   chains, 4 moves), then three swap-polish iterations, fed the same draws
   on the card and on the CPU: integer state, placement and grouped mirror
   equal, cost vectors within rtol 1e-5; one exchange sweep on the same cost
   vectors, temperatures and uniforms gives the same permutation; a warm
   window on the 64-broker cluster gives the same merged placement, touched
   mask and hot list (pressure stack within rtol 1e-5 / atol 1e-3) on both,
   and the CPU window's diff planned by the device loop on both gives the
   same waves;
14. after the paths, which so run as they would alone: the same kernel
   check on B6 (10k brokers / 1M partitions, whose shared rows need broker
   tiles), then the kernel times at B5, 4000 brokers and B6 (last, since
   torch.profiler's tracing slows every later launch of the process):
   ``device_ms`` (every device op of a call, from torch.profiler, each named
   in ``device_ops``), ``call_ms`` (CUDA events around back-to-back calls),
   ``host_us`` (host enqueue time per call) and the byte bound, for the
   kernel's own choice and for each forced way; at B5 also the plain
   version's time, and the same times on the model the sidecar built from
   the wire. The ``kernels`` line gives B5's: its ``ms`` is the call time
   ``call_ms``, beside ``device_ms`` and ``host_us``;
15. profile — the device busy share and kernel count, under torch.profiler,
   of windows on the repaired B5 model: 10 single-move SA steps
   (``p_swap=0``) and 10 polish iterations, as measured before the swap
   engine, then 10 batched SA steps at ``p_swap=0.15`` and 10 swap-polish
   iterations, and one more warm window on the warm path's last snapshot;
   before them, how many times each of these calls (10 steps or
   iterations; one warm window) makes the host wait for the card;
16. the card's ``nvidia-smi`` line, then the ``kernels`` line, then the
   contract line ``{"ok": true, "device": {...}}`` last.

Any failed check, an unverified result, remaining hard violations, a path
that never proposed both kinds of swap (target) or launched a kernel of
the path zero times exits non-zero. Each path (main, lean, warm,
structural, ladder, sidecar serve, sidecar options, fleet, and the service's
dry run, detection round, warm proposal and demo execution) sets the launch
count to 0 just before it runs and reads it just after. Needs one CUDA
device; run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

RTOL, ATOL = 1e-5, 1e-3
FLOAT_FIELDS = ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load")
INT_FIELDS = ("replica_count", "leader_count", "topic_replica_count", "topic_leader_count")
#: the two paths: the bench's rungs, from ``ccx_torch.rungs.build_opts``
PATHS = (("main-path", "target"), ("lean-path", "lean"))
#: CUDA-event timing launches per kernel; SA steps and descent iterations
#: under the profiler
TIMING_ITERS, PROFILE_STEPS = 200, 10
#: the card-against-CPU batched step: a cluster wide enough for the batched
#: engine (64 brokers >= 4 * R * 4 moves), chains, moves, steps
STEP_SPEC = dict(n_brokers=64, n_racks=8, n_topics=16, n_partitions=400,
                 n_dead_brokers=2, seed=11)
STEP_CHAINS, STEP_MOVES, STEP_COUNT = 3, 4, 3
#: sparse wide clusters, two partitions per broker: B pads to 4096, then to
#: 8192, where the kernel's rows in shared memory need broker tiles
WIDE_SPEC = dict(n_brokers=4000, n_racks=40, n_topics=64, n_partitions=8000,
                 n_dead_brokers=3, seed=7)
WIDER_SPEC = dict(n_brokers=8000, n_racks=40, n_topics=64, n_partitions=16000,
                  n_dead_brokers=3, seed=8)
#: the warm path: windows to warm up, windows measured, the drift rule's
#: share of partitions and seed (the bench's ``run_steady``)
WARM_UP, WARM_WINDOWS, DRIFT, DRIFT_SEED = 2, 10, 0.01, 123
#: live brokers marked dead in the structural window
DEAD_IN_WINDOW = 2
#: the sidecar's metrics windows (delta PutSnapshot + warm Propose)
SERVE_WINDOWS = 10
#: the sidecar-options phase's Propose options beyond the target rung's,
#: and its SA chunk: the overlap needs more steps than one chunk, so the
#: target rung's 250 steps run as two chunks of 125
OPTION_VALUES = {"repair_backend": "host", "overlap_repair": True, "polish_swap_fraction": 0.25}
OPTION_CHUNK_STEPS = 125
#: the fleet phase: B3's priorities, the device-memory budget in resident
#: models, the dispatch widths the concurrent pair runs at, and its budget
#: (B3's 20 brokers take the sequential SA engine, so the target rung's
#: 16 x 250 x 8 would take minutes): 8 chains x 50 steps x 2 moves in
#: chunks of 10, polish 48 iterations in chunks of 16, leader pass 32
FLEET_PRIORITIES, FLEET_BUDGET_MODELS, FLEET_WIDTHS = (0, 5), 1.5, (1, 8)
FLEET_ANNEAL = dict(n_chains=8, n_steps=50, moves_per_step=2, chunk_steps=10)
FLEET_POLISH = dict(max_iters=48, chunk_iters=16)
FLEET_LEADER_ITERS = 32
#: the service phase: metrics windows sampled before the dry run, their
#: length, the target rung (``rungs.build_opts("B5", "target")``) as the
#: façade's config keys (every other field of the rung is the façade's
#: default; the phase checks the two option sets equal), and the demo
#: cluster's search budget for its executed rebalance (its 6 brokers take
#: the sequential SA engine: 8 x 100 steps took 24 s of a 30 s run on an
#: H100, 8 x 200 steps with the config's default descents 65 s)
SERVICE_WINDOWS, SERVICE_WINDOW_MS = 4, 60_000
SERVICE_TARGET_KEYS = {
    "optimizer.num.chains": 16, "optimizer.num.steps": 250, "optimizer.moves.per.step": 8,
    "optimizer.chunk.steps": 250, "optimizer.polish.candidates": 256,
    "optimizer.polish.max.iters": 150, "optimizer.topic.rebalance.rounds": 0,
    "optimizer.leader.pass.max.iters": 100, "optimizer.portfolio.cold.greedy": False,
    "optimizer.swap.polish.iters": 0, "optimizer.swap.polish.post.iters": 0,
}
DEMO_KEYS = {"optimizer.num.chains": 8, "optimizer.num.steps": 40,
             "optimizer.polish.max.iters": 100, "optimizer.swap.polish.iters": 30,
             "optimizer.swap.polish.post.iters": 30}
#: the ladder phase: temperature rungs and steps per chunk
LADDER_TEMPS, LADDER_CHUNK = 4, 25
#: fixtures of the kernel-time phase: B5, a sparse wide cluster, and B6,
#: whose 16384 brokers need broker tiles for rows in shared memory
TIME_FIXTURES = ("B5", "4000-brokers", "B6")
#: the kernel's ways of summing the per-broker rows, forced in the checks
ROW_WAYS = ("shared", "global")


#: every JSON line, also kept whole under smoke_out/ (git ignores it)
LOG = ROOT / "smoke_out" / "chip_smoke.jsonl"
T0 = time.monotonic()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.monotonic() - T0}
    line = json.dumps(obj)
    print(line, flush=True)
    with LOG.open("a") as f:
        f.write(line + "\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches, after a
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def short_name(name: str) -> str:
    """A device op's name without its return type, namespace noise and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0] if "(" in name else name


def kernel_times(fn, iters: int) -> dict:
    """One call ``fn`` read three ways, each over ``iters`` back-to-back
    calls after a warm-up: ``host_us``, the host clock around the enqueues
    with no synchronize inside; ``call_ms``, CUDA events around the calls;
    ``device_ms``, the device time per call of every op the calls put on the
    card, from torch.profiler, with ``device_ops`` naming each op, its
    count per call and its time per launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    call_ms = cuda_ms(fn, iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_us = ops.setdefault(short_name(e.name), [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
    # each op's mean time times its launches per call: the trace of a long
    # loop may miss a few events
    return {
        "device_ms": sum(us / n * max(1, round(n / iters)) for n, us in ops.values()) / 1e3,
        "call_ms": call_ms, "host_us": host_us,
        "device_ops": {k: {"per_call": n / iters, "ms": us / n / 1e3}
                       for k, (n, us) in ops.items()},
    }


def fixture_spec(name: str, fixtures):
    """The ``RandomClusterSpec`` of a named fixture, from the ``fixtures``
    module given (``ccx_torch.model.fixtures`` of some checkout)."""
    if name == "4000-brokers":
        return fixtures.RandomClusterSpec(**WIDE_SPEC)
    if name == "8000-brokers":
        return fixtures.RandomClusterSpec(**WIDER_SPEC)
    return fixtures.bench_spec(name)


def time_kernel(agg_op, m, rows: str | None = None, costmodel=None) -> dict:
    """``kernel_times`` of one ``agg_op.broker_aggregates_cuda`` call on
    ``m`` (``rows`` forced where given), beside the bound: the least time
    for the pass on the live card, from the cost model's reckoning
    (``costmodel.aggregates_bound_ms``, by default this checkout's
    ``ccx_torch.common.costmodel``: every input read once and every output
    written once over the card's memory rate, against at most 12 additions
    per replica at its float32 rate, from the model's live partition and
    replica counts; the table's peaks are the data sheet's), the same
    number its ``broker-aggregates`` program row carries."""
    if costmodel is None:
        from ccx_torch.common import costmodel

    if rows is None:
        call = lambda: agg_op.broker_aggregates_cuda(m)  # noqa: E731
    else:
        call = lambda: agg_op.broker_aggregates_cuda(m, rows)  # noqa: E731
    bound_ms, bound_by = costmodel.aggregates_bound_ms(m)
    return {**kernel_times(call, TIMING_ITERS), "bound_ms": bound_ms, "bound_by": bound_by}


def compare_aggregates(got, ref) -> float:
    """Exact integer fields, toleranced float fields; returns the largest
    absolute float difference."""
    import torch

    for f in INT_FIELDS:
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            fail(f"kernel disagrees with the plain version on {f}")
    worst = 0.0
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"kernel disagrees with the plain version on {f}: max |d| {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def device_busy(fn) -> dict:
    """Run ``fn`` under torch.profiler: wall seconds, the union of the
    device-kernel intervals in seconds, the busy share and the kernel count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall, "kernels": len(spans)}


def host_syncs(fn) -> int:
    """How many times ``fn`` makes the host wait for the card (PyTorch's
    synchronizing-operation warnings, ``torch.cuda.set_sync_debug_mode``)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def draws_to(d, device):
    """A draws dataclass (nested ones included) with every tensor on
    ``device``."""
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        out[f.name] = v.to(device) if hasattr(v, "to") else draws_to(v, device)
    return type(d)(**out)


def card_against_cpu(dev) -> dict:
    """``STEP_COUNT`` batched SA steps, then as many swap-polish iterations,
    on a small cluster, on the card and on the CPU from the same arrays and
    the same draws (drawn on the CPU): placement, grouped mirror, integer
    aggregates, accumulators and counters must be equal, cost vectors within
    rtol 1e-5 / atol 1e-6."""
    import torch
    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
    from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
    from ccx_torch.model.tensor_model import model_arrays, model_from_arrays
    from ccx_torch.search import annealer as ann
    from ccx_torch.search import state as st
    from ccx_torch.search.greedy import SwapPolishIteration, SwapPolishOptions, draw_swap_polish

    host = random_cluster(RandomClusterSpec(**STEP_SPEC), device="cpu")
    arrays = model_arrays(host)
    cfg, goals = GoalConfig(), DEFAULT_GOAL_ORDER
    opts = ann.AnnealOptions(n_chains=STEP_CHAINS, moves_per_step=STEP_MOVES)
    runs = []
    for where in ("cpu", dev):
        m = model_from_arrays(arrays, host.num_topics, host.num_racks, where)
        p_real, b_real = ann.real_sizes(m)
        pp = ann.proposal_params(opts, goals, cfg, p_real, b_real)
        engine = ann.step_engine(opts, pp, m.R, False)
        group = st.make_topic_group(m, st.max_partitions_per_topic(m))
        evac, n_evac = ann.hot_partition_list(m, goals, cfg)
        state = st.init_search_state(m, cfg, goals, group=group, n_chains=STEP_CHAINS)
        runs.append((m, pp, engine, group, evac, n_evac, state))
    (m_c, pp_c, engine, group_c, evac_c, n_c, s_c), (m_d, pp_d, _, group_d, evac_d, n_d, s_d) = runs
    if engine != "batched" or n_c != n_d:
        fail(f"batched step check: engine {engine}, hot lists {n_c} / {n_d}")
    gen = torch.Generator().manual_seed(3)
    kw_c = ann.step_kwargs(m_c, cfg, goals, pp_c, engine, STEP_MOVES, group_c)
    kw_d = ann.step_kwargs(m_d, cfg, goals, pp_d, engine, STEP_MOVES, group_d)
    for _ in range(STEP_COUNT):
        d = ann.draw_batched(gen, STEP_CHAINS, STEP_MOVES, m_c, pp_c, n_c)
        ann._anneal_step_batched(s_c, d, 0.3, pp_c.p_swap, evac_c, n_c, **kw_c)
        ann._anneal_step_batched(s_d, draws_to(d, dev), 0.3, pp_d.p_swap, evac_d, n_d, **kw_d)
    torch.cuda.synchronize()
    exact = ("assignment", "leader_slot", "replica_disk", "grouped_assign", "grouped_leader",
             "part_sums", "topic_totals", "mtl_sum", "trd_sum", "n_accepted", "n_prop_kind",
             "n_acc_kind")
    for f in exact:
        if not torch.equal(getattr(s_c, f), getattr(s_d, f).cpu()):
            fail(f"batched step: {f} differs between the card and the CPU")
    for f in ("replica_count", "leader_count"):
        if not torch.equal(getattr(s_c.agg, f), getattr(s_d.agg, f).cpu()):
            fail(f"batched step: {f} differs between the card and the CPU")
    if not torch.allclose(s_c.cost_vec, s_d.cost_vec.cpu(), rtol=RTOL, atol=1e-6):
        fail("batched step: cost vectors differ between the card and the CPU")
    sa = {"engine": engine, "chains": STEP_CHAINS, "moves": STEP_MOVES, "steps": STEP_COUNT,
          "accepted": int(s_c.n_accepted.sum()),
          "accepted_by_kind": s_c.n_acc_kind.sum(0).tolist(),
          "cost_max_abs_err": float((s_c.cost_vec - s_d.cost_vec.cpu()).abs().max())}

    # swap-polish iterations on one chain, same draws on both
    sp_opts = SwapPolishOptions(n_swap_candidates=32, n_lead_candidates=32)
    steps = [SwapPolishIteration(m, cfg, goals, sp_opts) for m in (m_c, m_d)]
    states = [st.init_search_state(m, cfg, goals, group=it.group) for m, it in zip((m_c, m_d), steps)]
    applied = 0
    for _ in range(STEP_COUNT):
        d = draw_swap_polish(gen, m_c, steps[0].N)
        on_cpu = int(steps[0](states[0], d, guard_on=True))
        on_card = int(steps[1](states[1], draws_to(d, dev), guard_on=True))
        if on_cpu != on_card:
            fail(f"swap polish: {on_cpu} candidates applied on the CPU, {on_card} on the card")
        applied += on_cpu
    torch.cuda.synchronize()
    for f in exact:
        if not torch.equal(getattr(states[0], f), getattr(states[1], f).cpu()):
            fail(f"swap polish: {f} differs between the card and the CPU")
    if not torch.allclose(states[0].cost_vec, states[1].cost_vec.cpu(), rtol=RTOL, atol=1e-6):
        fail("swap polish: cost vectors differ between the card and the CPU")
    return {"batched_step": sa, "swap_polish": {"iters": STEP_COUNT, "applied": applied}}


def plan_options(opts, backend: str):
    """The plan options ``optimize`` plans with, the backend forced."""
    from ccx_torch.search.movement import PlanOptions

    return PlanOptions(broker_cap=opts.plan_broker_cap, wave_bytes=opts.plan_wave_bytes_mb,
                       max_waves=opts.plan_max_waves,
                       throttle_mb_per_sec=opts.plan_throttle_mb_per_sec, backend=backend)


def same_plan(a, b) -> bool:
    import numpy as np

    return (np.array_equal(a.wave, b.wave) and np.array_equal(a.wave_bytes, b.wave_bytes)
            and np.array_equal(a.wave_inflow_peak, b.wave_inflow_peak)
            and np.array_equal(a.wave_outflow_peak, b.wave_outflow_peak)
            and a.n_waves == b.n_waves and a.overflow_rows == b.overflow_rows)


def stack_line(stack) -> dict:
    return {"hard": float(stack.hard_violations),
            "violations": {n: v for n, (v, _) in stack.by_name().items()}}


def warm_path(b5, base, cfg, goal_names, opts, agg_op) -> tuple[dict, object, object]:
    """The steady-state loop (module docstring, phase 6). Returns (its line,
    the last window's snapshot, the session name)."""
    import numpy as np
    import torch
    from ccx_torch import rungs
    from ccx_torch.common.resources import Resource
    from ccx_torch.optimizer import optimize
    from ccx_torch.search import incremental as inc
    from ccx_torch.search.movement import plan_movement

    wopts = dataclasses.replace(opts, incremental=rungs.steady_options(), plan_enabled=True)
    session = "chip-smoke-B5"
    inc.STORE.clear()
    inc.remember(session, 1, base.model, cfg)
    applied = b5.replace(assignment=base.model.assignment, leader_slot=base.model.leader_slot,
                         replica_disk=base.model.replica_disk)
    loads = {f: getattr(applied, f).cpu().numpy() for f in ("leader_load", "follower_load")}
    rng = np.random.default_rng(DRIFT_SEED)
    p_real = int(b5.partition_valid.sum())
    n_drift = max(int(p_real * DRIFT), 1)
    windows = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    agg_op.LAUNCHES = 0
    for i in range(WARM_UP + WARM_WINDOWS):
        loads = rungs.drift_metrics(loads, rng, p_real, n_drift)
        snap = applied.replace(**{f: torch.from_numpy(a).to(b5.device) for f, a in loads.items()})
        before = agg_op.LAUNCHES
        t = time.monotonic()
        res = optimize(snap, cfg, goal_names, wopts, warm_start=inc.STORE.get(session))
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launches = agg_op.LAUNCHES - before
        inc.remember(session, i + 2, res.model, cfg, pressure=res.warm_pressure)
        info = res.incremental or {}
        bytes_pp = snap.leader_load[Resource.DISK]
        t = time.monotonic()
        oracle = plan_movement(res.diff, bytes_pp, snap.B, plan_options(wopts, "numpy"))
        numpy_s = time.monotonic() - t
        t = time.monotonic()
        forced = plan_movement(res.diff, bytes_pp, snap.B, plan_options(wopts, "device"))
        device_s = time.monotonic() - t
        hard = float(res.stack_after.hard_violations)
        worse = inc._significantly_lex_worse(res.stack_after, res.stack_before)
        windows.append({
            "window": i + 1, "measured": i >= WARM_UP, "wall_seconds": wall,
            "optimize_wall_seconds": res.wall_seconds, "phase_seconds": res.phase_seconds,
            "warm_start": bool(info.get("warmStart")), "touched_brokers": info.get("touchedBrokers"),
            "diff_rows": res.diff.n, "reverted": info.get("reverted"),
            "swap_polish_moves": res.n_polish_moves,
            "plan": {"waves": res.plan.n_waves, "backend": res.plan.backend,
                     "equals_oracle": same_plan(res.plan, oracle),
                     "forced_device_equals_oracle": same_plan(forced, oracle),
                     "forced_device_backend": forced.backend,
                     "numpy_seconds": numpy_s, "forced_device_seconds": device_s},
            "verified": res.verification.ok, "hard_violations": hard,
            "lex_worse_than_base": worse, "launches": launches,
        })
        if not info.get("warmStart"):
            fail(f"warm-path window {i + 1} was not warm-started: {info}")
        if not res.verification.ok:
            fail(f"warm-path window {i + 1}: verification failed: {res.verification.failures}")
        if hard > 0:
            fail(f"warm-path window {i + 1}: {hard} hard violations")
        if worse:
            fail(f"warm-path window {i + 1} ships a stack lex-worse than its base")
        if forced.backend != "device" or not same_plan(forced, oracle) or not same_plan(res.plan, oracle):
            fail(f"warm-path window {i + 1}: the plan differs from the numpy oracle")
        del res
    total = agg_op.LAUNCHES
    measured = [w for w in windows if w["measured"]]
    walls = sorted(w["wall_seconds"] for w in measured)
    p99 = walls[min(int(round(0.99 * (len(walls) - 1))), len(walls) - 1)]
    line = {
        "phase": "warm-path", "config": "B5", "rung": "target", "drift": DRIFT,
        "drift_partitions": n_drift, "seed": DRIFT_SEED, "warm_up": WARM_UP,
        "windows_measured": len(measured),
        "steady_options": dataclasses.asdict(rungs.steady_options()),
        "wall_p50_seconds": float(np.median(walls)), "wall_p99_seconds": p99,
        "phase_p50_seconds": {
            k: float(np.median([w["phase_seconds"].get(k, 0.0) for w in measured]))
            for k in measured[0]["phase_seconds"]
        },
        "launches": {"broker_aggregates": total},
        "launches_per_window": total / len(windows),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "store": inc.STORE.stats(),
        "windows": windows,
    }
    if total == 0:
        fail("warm-path never launched the broker_aggregates kernel")
    return line, snap, session


def structural_window(snap, cfg, goal_names, opts, session, agg_op) -> dict:
    """Phase 7: one window with live brokers marked dead."""
    import torch
    from ccx_torch import rungs
    from ccx_torch.optimizer import optimize
    from ccx_torch.search import incremental as inc

    wopts = dataclasses.replace(opts, incremental=rungs.steady_options(), plan_enabled=True)
    live = torch.nonzero(snap.broker_ok)[:, 0]
    dead = live[:DEAD_IN_WINDOW]
    alive = snap.broker_alive.clone()
    alive[dead] = False
    m = snap.replace(broker_alive=alive)
    agg_op.LAUNCHES = 0
    t = time.monotonic()
    res = optimize(m, cfg, goal_names, wopts, warm_start=inc.STORE.get(session))
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    launches = agg_op.LAUNCHES
    info = res.incremental or {}
    on_dead = int(((res.model.assignment[:, :, None] == dead[None, None, :]).any(2)
                   & res.model.partition_valid[:, None]).sum())
    hard = float(res.stack_after.hard_violations)
    line = {
        "phase": "structural-window", "config": "B5", "dead_brokers": dead.tolist(),
        "wall_seconds": wall, "phase_seconds": res.phase_seconds,
        "warm_start": bool(info.get("warmStart")),
        "structural_offenders": info.get("structuralOffenders"),
        "drift_partitions": info.get("driftPartitions"), "plateau": info.get("plateau"),
        "reverted": info.get("reverted"), "diff_rows": res.diff.n,
        "verified": res.verification.ok, "hard_violations": hard,
        "replicas_on_dead_brokers": on_dead, "launches": {"broker_aggregates": launches},
        "sa_accepted": res.n_sa_accepted, "polish_moves": res.n_polish_moves,
    }
    if not info.get("warmStart") or not info.get("structuralOffenders"):
        fail(f"structural-window did not take the structural path: {info}")
    if not {"repair", "anneal", "swap-polish"} <= set(res.phase_seconds):
        fail(f"structural-window phases: {sorted(res.phase_seconds)}")
    if info.get("plateau") is None:
        fail("structural-window: no plateau report")
    if not res.verification.ok:
        fail(f"structural-window: verification failed: {res.verification.failures}")
    if hard > 0 or on_dead:
        fail(f"structural-window: {hard} hard violations, {on_dead} replicas on dead brokers")
    if launches == 0:
        fail("structural-window never launched the broker_aggregates kernel")
    return line


def ladder_run(repaired, cfg, goal_names, opts, agg_op) -> dict:
    """Phase 8: the target rung's SA budget on the repaired B5, chunked,
    with and without the replica-exchange ladder."""
    import torch
    from ccx_torch.search.annealer import anneal

    runs = {}
    agg_op.LAUNCHES = 0
    for n_temps in (LADDER_TEMPS, 1):
        aopts = dataclasses.replace(opts.anneal, chunk_steps=LADDER_CHUNK, n_temps=n_temps)
        t = time.monotonic()
        sa = anneal(repaired, cfg, goal_names, aopts)
        torch.cuda.synchronize()
        ex = (sa.convergence or {}).get("exchange") or {}
        runs[f"n_temps={n_temps}"] = {
            "wall_seconds": time.monotonic() - t, "chains": sa.n_chains,
            "chunks": (sa.convergence or {}).get("chunks"),
            "exchange_attempted": sum(ex.get("attempted", [])),
            "exchange_accepted": sum(ex.get("accepted", [])),
            "accepted": sa.n_accepted, "after": stack_line(sa.stack_after),
            "costs": sa.stack_after.costs.tolist(),
        }
    launches = agg_op.LAUNCHES
    if runs[f"n_temps={LADDER_TEMPS}"]["exchange_attempted"] == 0:
        fail("ladder: no exchange was attempted")
    if launches == 0:
        fail("ladder never launched the broker_aggregates kernel")
    return {"phase": "ladder", "config": "B5 after hard_repair", "steps": opts.anneal.n_steps,
            "chains": opts.anneal.n_chains, "moves": opts.anneal.moves_per_step,
            "chunk_steps": LADDER_CHUNK, "launches": {"broker_aggregates": launches}, **runs}


def percentile(values, q: float) -> float:
    v = sorted(values)
    return v[min(int(round(q * (len(v) - 1))), len(v) - 1)]


def violations(res: dict) -> dict:
    """A wire result's violations after, per goal that has any."""
    return {g["goal"]: g["violationsAfter"] for g in res["goalSummary"] if g["violationsAfter"]}


def check_result(res: dict, what: str) -> None:
    """A wire result: verified, no hard goal left violated."""
    if not res["verified"]:
        fail(f"{what}: verification failed: {res['verificationFailures']}")
    hard = [g["goal"] for g in res["goalSummary"] if g["hard"] and g["violationsAfter"] > 0]
    if hard:
        fail(f"{what}: hard violations remain in {hard}")


class InProcessClient:
    """The client's calls on an ``OptimizerSidecar`` through the
    byte-identity handlers, for a card machine without ``grpc``."""

    def __init__(self, sidecar) -> None:
        self.sidecar = sidecar

    def put_snapshot(self, model, session, generation, is_delta=False, base_generation=None,
                     packed=None):
        from ccx_torch.sidecar import wire

        return wire.decode_response(self.sidecar.put_snapshot(wire.put_snapshot_request(
            session, generation, packed, is_delta=is_delta, base_generation=base_generation)))

    def propose(self, session=None, goals=(), columnar=False, warm_start=False,
                base_generation=None, stream_result=None, timings=None, **options):
        from ccx_torch.model.snapshot import decode_msgpack
        from ccx_torch.sidecar import wire

        req = wire.propose_request(goals=goals, options=options, session=session,
                                   columnar=columnar, warm_start=warm_start,
                                   base_generation=base_generation,
                                   stream_result=bool(stream_result and columnar))
        frames = [wire.decode_frame(wire.pack_frame(f)) for f in self.sidecar.propose(req)]
        res = frames[-1]["result"]
        segs = [f["data"] for f in frames if wire.FIELD_RESULT_SEGMENT in f]
        if segs:
            res["proposalsColumnar"] = b"".join(segs)
        if isinstance(res.get("proposalsColumnar"), bytes):
            res["proposalsColumnar"] = decode_msgpack(res["proposalsColumnar"])
        if "goalSummaryColumnar" in res:
            gs = decode_msgpack(res.pop("goalSummaryColumnar"))
            res["goalSummary"] = [
                {"goal": g, "hard": bool(h), "violationsAfter": float(va)}
                for g, h, va in zip(gs["goal"], gs["hard"], gs["violationsAfter"])]
        if timings is not None:
            timings.update(frames=len(frames), segments=len(segs))
        return res

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


def sidecar_serve(b5, agg_op, have_grpc: bool) -> tuple[dict, object, dict]:
    """Phase 9 (module docstring). Returns (its line, the sidecar's resident
    B5 model, launches per Propose)."""
    import numpy as np
    import torch
    from ccx_torch import rungs
    from ccx_torch.common.devmem import DEVMEM
    from ccx_torch.common.tracing import TRACER, summarize
    from ccx_torch.model.snapshot import delta_encode, model_to_arrays, pack_arrays
    from ccx_torch.search import incremental as inc
    from ccx_torch.sidecar import server as sserver

    goal_names, opts, _ = rungs.build_opts("B5", "target")
    cold_opts = rungs.wire_options(opts)
    warm_opts = rungs.wire_options(dataclasses.replace(opts, incremental=rungs.steady_options()))
    recording = LOG.parent / "sidecar_flight.jsonl"
    recording.parent.mkdir(exist_ok=True)
    recording.unlink(missing_ok=True)
    sidecar = sserver.OptimizerSidecar()
    # the columns the server packs for a columnar result, to hold the
    # client's reassembly of the streamed segments against
    packed_cols: list = []
    real_pack = sserver.pack_arrays

    def recording_pack(d):
        if "newReplicas" in d:
            packed_cols.append(d)
        return real_pack(d)

    sserver.pack_arrays = recording_pack
    server = None
    if have_grpc:
        from ccx_torch.sidecar.client import SidecarClient

        server, port = sserver.make_grpc_server(sidecar, "127.0.0.1:0")
        server.start()
        client = SidecarClient(f"127.0.0.1:{port}", retries=0)
    else:
        client = InProcessClient(sidecar)
    session, launches = "chip-smoke-B5-sidecar", {}
    TRACER.arm(str(recording))
    try:
        with client:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            agg_op.LAUNCHES = 0
            t = time.monotonic()
            arrays = model_to_arrays(b5)
            packed = pack_arrays(arrays)
            pack_s = time.monotonic() - t
            t = time.monotonic()
            client.put_snapshot(None, session, 1, packed=packed)
            put_full_s = time.monotonic() - t

            def propose(name, **kw):
                before = agg_op.LAUNCHES
                timings: dict = {}
                t0 = time.monotonic()
                res = client.propose(session=session, goals=goal_names, columnar=True,
                                     timings=timings, **kw)
                rt = time.monotonic() - t0
                launches[name] = agg_op.LAUNCHES - before
                check_result(res, f"sidecar-serve {name}")
                if launches[name] == 0:
                    fail(f"sidecar-serve {name} never launched the broker_aggregates kernel")
                return res, rt, timings

            cold, cold_rt, cold_t = propose("cold", stream_result=True, **cold_opts)
            got, want = cold["proposalsColumnar"], packed_cols[-1]
            if sorted(got) != sorted(want) or not all(np.array_equal(got[k], want[k]) for k in want):
                fail("sidecar-serve: the streamed segments do not reassemble to the packed columns")
            if cold["numProposals"] != len(want["partition"]):
                fail("sidecar-serve: numProposals disagrees with the columns")
            hits = sidecar.stats_memo_hits
            repeat, repeat_rt, _ = propose("repeat", stream_result=False, **cold_opts)
            if sidecar.stats_memo_hits != hits + 1:
                fail("sidecar-serve: the repeat Propose missed the input-stats memo")
            if repeat["clusterModelStats"]["before"] != cold["clusterModelStats"]["before"]:
                fail("sidecar-serve: the memo's input stats differ from the cold Propose's")
            rng = np.random.default_rng(DRIFT_SEED)
            p_real = int(b5.partition_valid.sum())
            n_drift = max(int(p_real * DRIFT), 1)
            loads = {f: arrays[f] for f in ("leader_load", "follower_load")}
            windows = []
            for gen in range(1, SERVE_WINDOWS + 1):
                new = rungs.drift_metrics(loads, rng, p_real, n_drift)
                t = time.monotonic()
                client.put_snapshot(None, session, gen + 1, is_delta=True, base_generation=gen,
                                    packed=pack_arrays(delta_encode(loads, new)))
                put_s = time.monotonic() - t
                loads = new
                res, rt, tm = propose(f"warm-{gen}", warm_start=True, base_generation=gen,
                                      stream_result=True, **warm_opts)
                info = res.get("incremental") or {}
                if not info.get("warmStart"):
                    fail(f"sidecar-serve window {gen} was not warm-started: {info}")
                windows.append({"window": gen, "put_delta_seconds": put_s, "round_trip_seconds": rt,
                                "wall_seconds": res["wallSeconds"], "wire_seconds": res["wireSeconds"],
                                "diff_rows": res["numProposals"], "segments": tm["segments"],
                                "segment_bytes": res["proposalsColumnarBytes"],
                                "touched_brokers": info.get("touchedBrokers"),
                                "reverted": info.get("reverted"), "launches": launches[f"warm-{gen}"]})
            path_launches = agg_op.LAUNCHES
    finally:
        TRACER.disarm()
        sserver.pack_arrays = real_pack
        if server is not None:
            server.stop(0)
    reg = sidecar.registry.stats()
    if reg["deltaGrafts"] != SERVE_WINDOWS or reg["misses"] != 1 or reg["graftFailures"]:
        fail(f"sidecar-serve: a metric delta was not grafted: {reg}")
    summary = summarize(str(recording))
    unnamed = [p for p in cold["phaseSeconds"] if f"optimize/{p}" not in summary["spanWalls"]]
    if unnamed or summary["openSpans"]:
        fail(f"sidecar-serve: the recording misses phases {unnamed} "
             f"or leaves spans open {summary['openSpans']}")
    rts = [w["round_trip_seconds"] for w in windows]
    over = [w["round_trip_seconds"] - w["wall_seconds"] for w in windows]
    line = {
        "phase": "sidecar-serve", "config": "B5", "rung": "target", "transport":
        "grpc" if have_grpc else "in-process", "packed_bytes": len(packed),
        "pack_seconds": pack_s, "put_full_seconds": put_full_s,
        "put_delta_seconds_p50": float(np.median([w["put_delta_seconds"] for w in windows])),
        "cold": {"round_trip_seconds": cold_rt, "wall_seconds": cold["wallSeconds"],
                 "overhead_seconds": cold_rt - cold["wallSeconds"],
                 "phase_seconds": cold["phaseSeconds"], "wire_seconds": cold["wireSeconds"],
                 "move_counters": cold["moveCounters"], "violations_after": violations(cold),
                 "proposals": cold["numProposals"], "segments": cold_t["segments"],
                 "segment_bytes": cold["proposalsColumnarBytes"], "frames": cold_t["frames"],
                 "launches": launches["cold"]},
        "repeat": {"round_trip_seconds": repeat_rt, "wall_seconds": repeat["wallSeconds"],
                   "stats_memo_hit": True, "launches": launches["repeat"]},
        "warm_round_trip_p50_seconds": float(np.median(rts)),
        "warm_round_trip_p99_seconds": percentile(rts, 0.99),
        "warm_overhead_p50_seconds": float(np.median(over)),
        "warm_overhead_p99_seconds": percentile(over, 0.99),
        "windows": windows, "registry": reg, "devmem": DEVMEM.stats(),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "flight_recorder": {"records": summary["records"], "spans": len(summary["spanWalls"])},
        "launches": {"broker_aggregates": path_launches},
    }
    model = sidecar.registry.model(session)
    inc.STORE.drop(session)
    return line, model, launches


def sidecar_options(b5, agg_op, have_grpc: bool, serve_cold: dict, kind: str) -> dict:
    """Phase 10 (module docstring). ``serve_cold`` is ``sidecar-serve``'s
    default cold Propose, printed beside this one."""
    import numpy as np
    from ccx_torch import rungs
    from ccx_torch.common import compilestats, costmodel
    from ccx_torch.common.metrics import REGISTRY
    from ccx_torch.model.snapshot import delta_encode, model_to_arrays, pack_arrays
    from ccx_torch.search import incremental as inc
    from ccx_torch.sidecar import server as sserver

    goal_names, opts, _ = rungs.build_opts("B5", "target")
    cold_opts = {**rungs.wire_options(opts), **OPTION_VALUES, "chunk_steps": OPTION_CHUNK_STEPS}
    warm_opts = rungs.wire_options(dataclasses.replace(opts, incremental=rungs.steady_options()))
    sidecar = sserver.OptimizerSidecar()
    server = None
    if have_grpc:
        from ccx_torch.sidecar.client import SidecarClient

        server, port = sserver.make_grpc_server(sidecar, "127.0.0.1:0")
        server.start()
        client = SidecarClient(f"127.0.0.1:{port}", retries=0)
    else:
        sserver.export_gauges()
        client = InProcessClient(sidecar)
    session = "chip-smoke-B5-options"
    launches: dict = {}
    costmodel.set_capture(True)
    try:
        with client:
            arrays = model_to_arrays(b5)
            client.put_snapshot(None, session, 1, packed=pack_arrays(arrays))
            agg_op.LAUNCHES = 0

            def propose(name, **kw):
                before, records = agg_op.LAUNCHES, len(costmodel.records())
                t0 = time.monotonic()
                res = client.propose(session=session, goals=goal_names, columnar=True, **kw)
                rt = time.monotonic() - t0
                launches[name] = agg_op.LAUNCHES - before
                check_result(res, f"sidecar-options {name}")
                if launches[name] == 0:
                    fail(f"sidecar-options {name} never launched the broker_aggregates kernel")
                if "costModel" not in res:
                    fail(f"sidecar-options {name}: the result carries no costModel")
                return res, rt, len(costmodel.records()) - records

            cold, cold_rt, captured = propose("cold", stream_result=True, **cold_opts)
            repeat, repeat_rt, captured_repeat = propose("repeat", stream_result=False, **cold_opts)
            rng = np.random.default_rng(DRIFT_SEED)
            p_real = int(b5.partition_valid.sum())
            loads = {f: arrays[f] for f in ("leader_load", "follower_load")}
            new = rungs.drift_metrics(loads, rng, p_real, max(int(p_real * DRIFT), 1))
            client.put_snapshot(None, session, 2, is_delta=True, base_generation=1,
                                packed=pack_arrays(delta_encode(loads, new)))
            warm, warm_rt, captured_warm = propose("warm", warm_start=True, base_generation=1,
                                                   stream_result=True, **warm_opts)
            path_launches = agg_op.LAUNCHES
    finally:
        costmodel.set_capture(False)
        if server is not None:
            server.stop(0)
        inc.STORE.drop(session)
    phases = cold["phaseSeconds"]
    missing = [ph for ph in ("repair", "repair-join", "repair-concurrent", "anneal", "polish",
                             "cost-capture") if ph not in phases]
    if missing:
        fail(f"sidecar-options: the cold Propose lacks the phases {missing}")
    cm = cold["costModel"]
    if cm["device"]["deviceKind"] != kind:
        fail(f"sidecar-options: costModel names {cm['device']['deviceKind']!r}, not {kind!r}")
    rows = {k: cm["programs"].get(k) for k in ("broker-aggregates", "sa-chunk", "polish-chunk")}
    if not all(rows.values()):
        fail(f"sidecar-options: costModel lacks program rows: {sorted(cm['programs'])}")
    if not any("costModel" in c for c in cold["spanTree"]["children"]):
        fail("sidecar-options: no phase span carries the cost rollup")
    if captured == 0 or captured_repeat or captured_warm:
        fail(f"sidecar-options: records added cold {captured}, repeat {captured_repeat}, "
             f"warm {captured_warm} (the cold Propose alone must capture)")
    for name, res in (("repeat", repeat), ("warm", warm)):
        if "cost-capture" in res["phaseSeconds"]:
            fail(f"sidecar-options: the {name} Propose ran a cost-capture phase")
    if not warm.get("incremental", {}).get("warmStart"):
        fail(f"sidecar-options: the window was not warm-started: {warm.get('incremental')}")
    text = REGISTRY.render_prometheus()
    gauges = {}
    for name in ("compile_backend_compiles", "compile_backend_compile_secs",
                 "compile_persistent_hits", "compile_persistent_misses",
                 "cost_programs_captured", "cost_programs_pending",
                 "cost_projected_device_seconds"):
        line = next((ln for ln in text.splitlines() if ln.startswith(f"ccx_{name} ")), None)
        if line is None:
            fail(f"sidecar-options: /metrics lacks ccx_{name}")
        gauges[name] = float(line.split()[1])
    if gauges["compile_backend_compiles"] + gauges["compile_persistent_hits"] < 1:
        fail(f"sidecar-options: the compile gauges show no kernel build: {gauges}")
    polish = [0, 0, 0]
    for seg in (cold.get("convergence") or {}).get("phases", {}).get("polish", ()):
        polish = [a + b for a, b in zip(polish, seg["accepted"][-1])]
    return {
        "phase": "sidecar-options", "config": "B5", "rung": "target",
        "options": {**OPTION_VALUES, "chunk_steps": OPTION_CHUNK_STEPS},
        "transport": "grpc" if have_grpc else "in-process",
        "cold": {"round_trip_seconds": cold_rt, "wall_seconds": cold["wallSeconds"],
                 "phase_seconds": phases, "move_counters": cold["moveCounters"],
                 "violations_after": violations(cold),
                 "polish_accepted": dict(zip(("single", "replicaSwap", "leadershipSwap"), polish)),
                 "launches": launches["cold"], "records_added": captured},
        "default_cold": {"wall_seconds": serve_cold["wall_seconds"],
                         "phase_seconds": serve_cold["phase_seconds"],
                         "move_counters": serve_cold["move_counters"],
                         "violations_after": serve_cold["violations_after"]},
        "repeat": {"round_trip_seconds": repeat_rt, "wall_seconds": repeat["wallSeconds"],
                   "launches": launches["repeat"], "records_added": captured_repeat},
        "warm": {"round_trip_seconds": warm_rt, "wall_seconds": warm["wallSeconds"],
                 "launches": launches["warm"], "records_added": captured_warm},
        "cost_model": {"device": cm["device"], "coverage": cm["coverage"],
                       "projected": cm["projected"], "programs": cm["programs"],
                       "records": len(costmodel.records())},
        "broker_aggregates_bound_ms": rows["broker-aggregates"].get("boundMsPerCall"),
        "gauges": gauges, "compile": compilestats.snapshot(),
        "launches": {"broker_aggregates": path_launches},
    }


def fleet_phase(dev, agg_op) -> dict:
    """Phase 11 (module docstring)."""
    import threading

    from ccx_torch import rungs
    from ccx_torch.common import devmem
    from ccx_torch.model.fixtures import bench_spec, random_cluster
    from ccx_torch.model.snapshot import model_to_arrays, pack_arrays
    from ccx_torch.search import incremental as inc
    from ccx_torch.search import scheduler
    from ccx_torch.search.scheduler import FLEET, JobCancelled
    from ccx_torch.sidecar import wire
    from ccx_torch.sidecar.server import OptimizerSidecar, model_device_bytes

    goal_names, opts, _ = rungs.build_opts("B3", "target")
    opts = dataclasses.replace(
        opts, anneal=dataclasses.replace(opts.anneal, **FLEET_ANNEAL),
        polish=dataclasses.replace(opts.polish, **FLEET_POLISH),
        leader_pass_max_iters=FLEET_LEADER_ITERS)
    b3 = random_cluster(bench_spec("B3"), device=dev)
    arrays = model_to_arrays(b3)
    one = model_device_bytes(b3)
    # the registry's own ledger: the budget binds its models only, and the
    # earlier phases' entries on the process-wide ledger stay
    sidecar = OptimizerSidecar(snapshot_hbm_budget_bytes=int(FLEET_BUDGET_MODELS * one))
    jobs = {p: f"fleet-p{p}" for p in FLEET_PRIORITIES}
    for name in jobs.values():
        sidecar.put_snapshot(wire.put_snapshot_request(name, 1, pack_arrays(arrays)))

    def request(name, prio, **over):
        return wire.propose_request(goal_names, rungs.wire_options(opts) | over, session=name,
                                    cluster_id=name, priority=prio)

    def run(name, prio, box):
        box[name] = [wire.decode_frame(wire.pack_frame(f))
                     for f in sidecar.propose(request(name, prio))][-1]["result"]

    def active():
        return {j["job"]: j["chunks"] for j in FLEET.stats()["activeJobs"]}

    def concurrent_pair(width: int) -> dict:
        """Both jobs at once, the urgent one started once the other is
        registered: seconds, results and the chunk counts of each job at
        the first and last moment both were registered."""
        scheduler.configure(dispatch_width=width)
        results: dict = {}
        samples: list = []
        done = threading.Event()

        def monitor():
            while not done.is_set():
                a = active()
                if all(n in a for n in jobs.values()):
                    samples.append(a)
                time.sleep(0.01)

        watcher = threading.Thread(target=monitor)
        low, high = (threading.Thread(target=run, args=(jobs[p], p, results))
                     for p in FLEET_PRIORITIES)
        t = time.monotonic()
        watcher.start()
        try:
            low.start()
            deadline = time.monotonic() + 120
            while jobs[0] not in active() and low.is_alive() and time.monotonic() < deadline:
                time.sleep(0.002)
            high.start()
            low.join(timeout=300)
            high.join(timeout=300)
        finally:
            done.set()
            watcher.join(timeout=30)
            scheduler.configure(dispatch_width=0)
        if low.is_alive() or high.is_alive() or len(results) != 2:
            fail(f"fleet: a Propose did not finish at dispatch width {width}")
        for name, res in results.items():
            check_result(res, f"fleet {name} (width {width})")
        grants = {n: (samples[0][n], samples[-1][n]) for n in jobs.values()} if samples else {}
        return {"seconds": time.monotonic() - t, "grants_during_overlap": grants,
                "overlap_samples": len(samples),
                "walls": {n: r["wallSeconds"] for n, r in results.items()}}

    agg_op.LAUNCHES = 0
    pairs = {scheduler.DEFAULT_DISPATCH_WIDTH: concurrent_pair(scheduler.DEFAULT_DISPATCH_WIDTH)}
    grants = pairs[scheduler.DEFAULT_DISPATCH_WIDTH]["grants_during_overlap"]
    if not grants or any(b <= a for a, b in grants.values()):
        fail(f"fleet: the grants did not interleave: {pairs}")
    reg = sidecar.registry.stats()
    if reg["evictions"] < 1:
        fail(f"fleet: the budget forced no eviction: {reg}")
    misses = reg["misses"]
    box: dict = {}
    t = time.monotonic()
    run(jobs[0], 0, box)
    alone_s = time.monotonic() - t
    check_result(box[jobs[0]], "fleet rebuild")
    if sidecar.registry.stats()["misses"] != misses + 1:
        fail("fleet: the evicted session's next Propose did not rebuild")
    for width in FLEET_WIDTHS:
        if width not in pairs:
            pairs[width] = concurrent_pair(width)
    # a job cancelled mid-anneal
    cancel = threading.Event()
    gen = sidecar.propose(request(jobs[0], 0, steps=100 * opts.anneal.n_steps), cancel=cancel)
    cancelled = False
    try:
        for frame in gen:
            if frame.get("progress") == "anneal" and not cancel.is_set():
                time.sleep(0.5)
                cancel.set()
                FLEET.kick()
    except JobCancelled:
        cancelled = True
    if not cancelled:
        fail("fleet: the cancelled job did not raise JobCancelled")
    if jobs[0] in active():
        fail("fleet: the cancelled job still holds its slot")
    line = {
        "phase": "fleet", "config": "B3", "rung": "target", "anneal": FLEET_ANNEAL,
        "polish": FLEET_POLISH, "leader_iters": FLEET_LEADER_ITERS,
        "model_bytes": one, "budget_bytes": sidecar.registry.budget_bytes(),
        "concurrent_by_dispatch_width": pairs, "alone_seconds": alone_s,
        "registry": sidecar.registry.stats(), "devmem": devmem.DEVMEM.stats(),
        "rebuild_verified": True, "cancelled": True,
        "launches": {"broker_aggregates": agg_op.LAUNCHES},
    }
    for name in jobs.values():
        inc.STORE.drop(name)
    if line["launches"]["broker_aggregates"] == 0:
        fail("fleet never launched the broker_aggregates kernel")
    return line


class B5Sampler:
    """The service phase's metric sampler (``metric.sampler.class``
    ``__main__.B5Sampler``): replays the B5 fixture's per-partition leader
    loads (``LOADS``, float64[P, 4] in ``Resource`` order) once per
    window, and per-broker health metrics summed from the leaders. The
    test recipe's synthetic sampler draws 1–5 % CPU a partition, which at
    about 100 leaders a broker exceeds the static resolver's 100 % CPU on
    every broker, so no B5 run could verify."""

    LOADS = None

    def __init__(self, config=None) -> None:
        self.interval_ms = SERVICE_WINDOW_MS

    def configure(self, config) -> None:
        self.interval_ms = config["metric.sampling.interval.ms"]

    def get_samples(self, metadata, assigned_partitions, start_ms, end_ms):
        import numpy as np

        from ccx_torch.monitor.metricdef import BROKER_METRIC_DEF
        from ccx_torch.monitor.sampling.holders import (
            BrokerMetricSample, PartitionMetricSample, metric_vector)
        from ccx_torch.monitor.sampling.sampler import Samples

        rows = self.LOADS.tolist()
        times = range(int(start_ms), int(end_ms), int(self.interval_ms))
        parts = metadata.partitions
        psamples = [PartitionMetricSample(parts[p].leader, p, t, tuple(rows[p]))
                    for p in assigned_partitions if parts[p].leader >= 0 for t in times]
        bidx = metadata.broker_index()
        leader = np.array([bidx.get(p.leader, -1) for p in parts])
        led = leader >= 0
        per_broker = [np.bincount(leader[led], weights=self.LOADS[led, r],
                                  minlength=len(metadata.brokers)) for r in range(3)]
        bsamples = []
        for b in metadata.brokers:
            if not b.alive:
                continue
            i = bidx[b.broker_id]
            vec = metric_vector({
                "ALL_TOPIC_BYTES_IN": per_broker[1][i], "ALL_TOPIC_BYTES_OUT": per_broker[2][i],
                "BROKER_CPU_UTIL": min(per_broker[0][i] / 100.0, 1.0),
                "BROKER_LOG_FLUSH_TIME_MS_MEAN": 5.0, "BROKER_LOG_FLUSH_TIME_MS_MAX": 10.0,
                "UNDER_REPLICATED_PARTITIONS": 0.0,
                "OFFLINE_LOG_DIRS": float(len(b.offline_disks)),
            }, BROKER_METRIC_DEF)
            bsamples.extend(BrokerMetricSample(b.broker_id, t, vec) for t in times)
        return Samples(psamples, bsamples)

    def close(self) -> None:
        pass


def b5_cluster(arrays: dict, n_partitions: int, n_brokers: int):
    """A ``SimulatedCluster`` holding the fixture's brokers (racks, hosts,
    liveness) and placement: topic ``t{k:03d}``'s partitions in fixture
    order, which the metadata's (topic, partition) sort keeps, so the
    monitor's partition axis is the fixture's."""
    import numpy as np

    from ccx_torch.common.metadata import TopicPartition
    from ccx_torch.executor.admin import SimulatedCluster

    sim = SimulatedCluster()
    for b in range(n_brokers):
        sim.add_broker(b, rack=f"rack-{int(arrays['broker_rack'][b]):02d}",
                       host=f"host-{int(arrays['broker_host'][b])}")
    topics = arrays["partition_topic"][:n_partitions]
    for t, count in enumerate(np.bincount(topics)):
        sim.create_topic(f"t{t:03d}", int(count), 1)
    seen: dict[int, int] = {}
    for p in range(n_partitions):
        t = int(topics[p])
        k = seen[t] = seen.get(t, -1) + 1
        part = sim.partition(TopicPartition(f"t{t:03d}", k))
        part.replicas = [int(b) for b in arrays["assignment"][p] if b >= 0]
        part.leader = part.replicas[int(arrays["leader_slot"][p])]
        part.dirs = [0] * len(part.replicas)
    for b in range(n_brokers):
        if not arrays["broker_alive"][b]:
            sim.kill_broker(b)
    sim._generation += 1
    return sim


def rest(client, method: str, endpoint: str, params: dict | None = None) -> tuple[list, dict, float]:
    """``client.call`` with its HTTP statuses kept: (the first and the last
    status and the number of polls, body, round-trip seconds); fails on a
    status of 400 or more."""
    t = time.monotonic()
    status, body, headers = client._request(method, endpoint, params)
    statuses = [status]
    task = headers.get("User-Task-ID")
    while status == 202:
        if time.monotonic() - t > client.timeout_s:
            fail(f"service: {method} {endpoint} still running after {client.timeout_s} s")
        time.sleep(client.poll_interval_s)
        status, body, headers = client._request(method, endpoint, None, task_id=task)
        statuses.append(status)
    if status >= 400:
        fail(f"service: {method} {endpoint} answered {status}: {body}")
    return ({"first": statuses[0], "last": status, "polls": len(statuses) - 1}, body,
            time.monotonic() - t)


def service_phase(dev, agg_op, name: str, spec, main_wall: float) -> dict:
    """Phase 12 (module docstring). ``spec`` is config ``name``'s fixture
    (B5 on the card); ``main_wall`` the main path's wall, printed beside
    the REST rebalance's."""
    import collections
    import shutil

    import numpy as np
    import torch

    from ccx_torch import native, rungs
    from ccx_torch.client import CruiseControlClient
    from ccx_torch.config import CruiseControlConfig
    from ccx_torch.executor.admin import SimulatedAdminClient
    from ccx_torch.main import build_demo_admin
    from ccx_torch.model.aggregates import broker_aggregates
    from ccx_torch.model.fixtures import random_cluster
    from ccx_torch.model.tensor_model import model_arrays
    from ccx_torch.monitor.aggregator import ModelCompletenessRequirements
    from ccx_torch.service.facade import CruiseControl
    from ccx_torch.servlet.server import CruiseControlApp

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    fixture = random_cluster(spec, device=dev)
    arrays = model_arrays(fixture)
    P, B = spec.n_partitions, spec.n_brokers
    want = agg_op.broker_aggregates_plain(fixture)
    want_counts = {"replicas": want.replica_count[:B].cpu().numpy(),
                   "leaders": want.leader_count[:B].cpu().numpy()}
    B5Sampler.LOADS = np.asarray(arrays["leader_load"][:, :P], np.float64).T.copy()
    sim = b5_cluster(arrays, P, B)
    out_dir = ROOT / "smoke_out" / "service"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cap = arrays["broker_capacity"]
    entry = lambda b, c: {"brokerId": str(b), "capacity": {  # noqa: E731
        "CPU": str(c[0]), "NW_IN": str(c[1]), "NW_OUT": str(c[2]), "DISK": str(c[3])}}
    (out_dir / "capacity.json").write_text(json.dumps({"brokerCapacities": [
        entry(-1, cap[:, 0].tolist()), *(entry(b, cap[:, b].tolist()) for b in range(B))]}))
    setup_s = time.monotonic() - t
    props = {
        "metric.sampler.class": "__main__.B5Sampler",
        # a JAX package's class path, as an operator's properties file has
        # it: it resolves under ccx_torch
        "broker.capacity.config.resolver.class": "ccx.monitor.capacity.FileCapacityResolver",
        "capacity.config.file": str(out_dir / "capacity.json"),
        "sample.store.dir": str(out_dir / "samples"),
        "partition.metrics.window.ms": SERVICE_WINDOW_MS, "num.partition.metrics.windows": 3,
        "broker.metrics.window.ms": SERVICE_WINDOW_MS, "num.broker.metrics.windows": 3,
        "metric.sampling.interval.ms": SERVICE_WINDOW_MS,
        "webserver.http.address": "127.0.0.1", "webserver.http.port": 0,
        "optimizer.incremental.enabled": True, **SERVICE_TARGET_KEYS,
    }
    cfg = CruiseControlConfig(props)
    clock = {"now": 10 * SERVICE_WINDOW_MS}
    cc = CruiseControl(cfg, admin=SimulatedAdminClient(sim), clock=lambda: clock["now"],
                       executor_waiter=lambda ms: sim.tick(int(ms)), device=dev)
    opts = cc._optimize_options()
    _, rung_opts, _ = rungs.build_opts("B5", "target")
    if dataclasses.replace(opts, incremental=rung_opts.incremental) != rung_opts:
        fail("service: the façade's options from the config keys are not the target rung's")
    cc.start_up(run_background_threads=False)
    app = CruiseControlApp(cfg, cc, clock=lambda: clock["now"])
    host, port = app.start()
    client = CruiseControlClient(f"http://{host}:{port}", poll_interval_s=0.05, timeout_s=900)
    try:
        window_s = []
        for _ in range(SERVICE_WINDOWS):
            clock["now"] += SERVICE_WINDOW_MS
            t = time.monotonic()
            cc.load_monitor.sample_once()
            window_s.append(time.monotonic() - t)
        t = time.monotonic()
        model, _, _ = cc.load_monitor.cluster_model(ModelCompletenessRequirements(1, 0.5))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        model_s = time.monotonic() - t
        got = broker_aggregates(model)
        counts = {"replicas": got.replica_count[:B].cpu().numpy(),
                  "leaders": got.leader_count[:B].cpu().numpy()}
        for k in counts:
            if not np.array_equal(counts[k], want_counts[k]):
                fail(f"service: the monitor's model has other per-broker {k} than the fixture")
        del got, model

        reads = {}
        for endpoint in ("state", "load", "kafka_cluster_state"):
            statuses, body, rt = rest(client, "GET", endpoint)
            reads[endpoint] = {"statuses": statuses, "round_trip_s": rt}
            if statuses["last"] != 200:
                fail(f"service: {endpoint} answered {statuses}")
            if endpoint == "state":
                missing = {"MonitorState", "ExecutorState", "AnalyzerState",
                           "AnomalyDetectorState"} - set(body)
                if missing:
                    fail(f"service: state lacks {missing}")
            if endpoint == "load":
                by_id = {b["Broker"]: b for b in body["brokers"]}
                for k, field in (("replicas", "Replicas"), ("leaders", "Leaders")):
                    if [by_id[b][field] for b in range(B)] != counts[k].tolist():
                        fail(f"service: load's per-broker {k} differ from the model's")

        agg_op.LAUNCHES = 0
        statuses, dry, rt = rest(client, "POST", "rebalance", {"dryrun": True,
                                                                  "reason": "chip smoke"})
        dry_launches = agg_op.LAUNCHES
        check_result(dry, "service dry-run rebalance")
        if not dry["dryRun"] or not dry.get("incremental", {}).get("coldStart"):
            fail(f"service: the dry run was not a cold dry run: {dry.get('incremental')}")

        agg_op.LAUNCHES = 0
        t = time.monotonic()
        decisions = cc.anomaly_detector.run_once()
        detect = {"seconds": time.monotonic() - t, "launches": agg_op.LAUNCHES,
                  "anomalies": dict(collections.Counter(d["anomaly"]["type"] for d in decisions)),
                  "actions": dict(collections.Counter(d["action"] for d in decisions))}

        clock["now"] += SERVICE_WINDOW_MS
        cc.load_monitor.sample_once()
        agg_op.LAUNCHES = 0
        w_statuses, warm, w_rt = rest(client, "GET", "proposals", {"ignore_proposal_cache": True})
        warm_launches = agg_op.LAUNCHES
        check_result(warm, "service warm proposal")
        if not warm.get("incremental", {}).get("warmStart"):
            fail(f"service: the proposal did not warm-start: {warm.get('incremental')}")
    finally:
        app.stop()
        cc.shutdown()

    # an executed rebalance on the demo cluster, skewed onto two brokers
    demo = build_demo_admin()
    for tp, part in demo.cluster._partitions.items():
        if tp.topic == "demo-a":
            part.replicas, part.leader, part.dirs = [0, 1], 0, [0, 0]
    demo.cluster._generation += 1
    dclock = {"now": 0}
    dcfg = CruiseControlConfig({
        "metric.sampler.class": "ccx_torch.monitor.sampling.sampler.SyntheticMetricSampler",
        "broker.capacity.config.resolver.class": "ccx_torch.monitor.capacity.StaticCapacityResolver",
        "sample.store.dir": str(out_dir / "demo_samples"),
        "partition.metrics.window.ms": 1000, "num.partition.metrics.windows": 3,
        "broker.metrics.window.ms": 1000, "num.broker.metrics.windows": 3,
        "metric.sampling.interval.ms": 1000, "execution.progress.check.interval.ms": 50,
        **DEMO_KEYS,
    })
    dcc = CruiseControl(dcfg, admin=demo, clock=lambda: dclock["now"],
                        executor_waiter=lambda ms: demo.cluster.tick(int(ms)), device=dev)
    dcc.start_up(run_background_threads=False)
    try:
        for _ in range(5):
            dclock["now"] += 1000
            dcc.load_monitor.sample_once()
        agg_op.LAUNCHES = 0
        t = time.monotonic()
        wet = dcc.rebalance(dryrun=False, reason="chip smoke")
        dcc.executor.await_completion(timeout_s=300)
        exec_s = time.monotonic() - t
        exec_launches = agg_op.LAUNCHES
        check_result(wet, "service demo execution")
        if not wet.get("executionStarted") or dcc.executor._thread.is_alive():
            fail("service: the demo execution did not start or did not drain")
        placed = {(p.tp.topic, p.tp.partition): list(p.replicas)
                  for p in demo.describe_cluster().partitions}
        per_broker = collections.Counter(b for r in placed.values() for b in r)
        state = dcc.executor.state_json()["state"]
        if state != "NO_TASK_IN_PROGRESS":
            fail(f"service: the executor is {state} after the drain")
    finally:
        dcc.shutdown()

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ccx"))
    if bad:
        fail(f"service: the port's service loaded {bad[:5]}")
    return {
        "phase": "service", "config": name, "brokers": B, "partitions": P,
        "setup_seconds": setup_s, "sample_seconds_per_window": window_s,
        "cluster_model_seconds": model_s, "counts_equal_fixture": True,
        "reads": reads, "options_equal_target_rung": True,
        "dry_run": {"statuses": statuses, "round_trip_s": rt, "wall_seconds": dry["wallSeconds"],
                    "main_path_wall_seconds": main_wall, "phase_seconds": dry["phaseSeconds"],
                    "replica_moves": dry["numReplicaMovements"],
                    "leadership_moves": dry["numLeadershipMovements"],
                    "violations_after": violations(dry), "launches": dry_launches},
        "detection": detect,
        "warm_proposal": {"statuses": w_statuses, "round_trip_s": w_rt,
                          "wall_seconds": warm["wallSeconds"],
                          "phase_seconds": warm["phaseSeconds"],
                          "incremental": warm["incremental"], "launches": warm_launches},
        "demo_execution": {"seconds": exec_s, "wall_seconds": wet["wallSeconds"],
                           "phase_seconds": wet["phaseSeconds"],
                           "replica_moves": wet["numReplicaMovements"],
                           "replicas_per_broker": dict(sorted(per_broker.items())),
                           "launches": exec_launches},
        "native": native.state(),
        "peak_device_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
        "launches": {"broker_aggregates": dry_launches + detect["launches"] + warm_launches
                     + exec_launches},
    }


def exchange_on_card(dev) -> dict:
    """One exchange sweep on the card and on the CPU from the same cost
    vectors, temperatures and uniforms: the same permutation and counts."""
    import torch
    from ccx_torch.goals.base import GOAL_REGISTRY
    from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, soft_weights
    from ccx_torch.search.annealer import draw_exchange, exchange_permutation, ladder_fracs

    gen = torch.Generator().manual_seed(9)
    n, K = 16, LADDER_TEMPS
    G = len(DEFAULT_GOAL_ORDER)
    hard = tuple(GOAL_REGISTRY[g].hard for g in DEFAULT_GOAL_ORDER)
    cost = torch.rand(n, G, generator=gen) * 10
    cost[:, :8] = (cost[:, :8] > 9.5).float()
    temps = 0.3 * torch.pow(torch.full((n,), 1e-3), torch.from_numpy(ladder_fracs(K, n)))
    out = {}
    for parity in (0, 1):
        u = draw_exchange(gen, n, "cpu")
        got = []
        for where in ("cpu", dev):
            perm, att, acc = exchange_permutation(
                cost.to(where), temps.to(where), u.to(where), n_temps=K,
                hard_arr=torch.tensor(hard, device=where), weights=soft_weights(hard, where),
                parity=parity)
            got.append((perm.cpu().tolist(), int(att), int(acc)))
        if got[0] != got[1]:
            fail(f"exchange_permutation differs between the CPU and the card: {got}")
        out[f"parity={parity}"] = {"attempted": got[0][1], "accepted": got[0][2]}
    return out


def warm_window_on_card(dev) -> dict:
    """A warm window on the 64-broker cluster on the card against the CPU:
    the same merged placement, touched mask and hot list, the pressure stack
    within rtol 1e-5 / atol 1e-3; the CPU window's diff planned by the
    device loop on both gives the same waves."""
    import numpy as np
    import torch
    from ccx_torch import rungs
    from ccx_torch.common.resources import Resource
    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
    from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
    from ccx_torch.model.tensor_model import model_arrays, model_from_arrays
    from ccx_torch.optimizer import OptimizeOptions, optimize
    from ccx_torch.search import incremental as inc
    from ccx_torch.search.annealer import AnnealOptions
    from ccx_torch.search.greedy import GreedyOptions
    from ccx_torch.search.movement import plan_movement

    cfg, goals = GoalConfig(), DEFAULT_GOAL_ORDER
    host = random_cluster(RandomClusterSpec(**STEP_SPEC), device="cpu")
    opts = OptimizeOptions(
        anneal=AnnealOptions(n_chains=2, n_steps=20, moves_per_step=4, seed=1),
        polish=GreedyOptions(n_candidates=64, max_iters=20), run_cold_greedy=False,
        topic_rebalance_rounds=0, leader_pass_max_iters=10,
        incremental=rungs.steady_options(), plan_enabled=True)
    cold = optimize(host, cfg, goals, opts)
    base = model_arrays(cold.model)
    p_real = int(host.partition_valid.sum())
    drifted = rungs.drift_metrics(base, np.random.default_rng(DRIFT_SEED), p_real, max(p_real // 10, 1))
    got = []
    for where in ("cpu", dev):
        mb = model_from_arrays(base, host.num_topics, host.num_racks, where)
        warm = inc.WarmStart(session="card-vs-cpu", generation=1, assignment=mb.assignment,
                             leader_slot=mb.leader_slot, replica_disk=mb.replica_disk,
                             pressure=inc._pressure_stack(mb, cfg))
        # the snapshot keeps the input placement; the warm base is the cold result
        snap = model_from_arrays({**model_arrays(host), **{k: drifted[k] for k in (
            "leader_load", "follower_load")}}, host.num_topics, host.num_racks, where)
        wm = inc.warm_model(snap, warm)
        _, _, press, mask, count = inc.warm_init(wm, warm.pressure, cfg, goals)
        evac, n_evac, n_struct = inc.drift_hot_list(wm, mask, goals, cfg)
        got.append((wm, press.cpu(), mask.cpu(), evac.cpu(), n_evac, n_struct))
    (wm_c, p_c, mk_c, ev_c, n_c, s_c), (wm_d, p_d, mk_d, ev_d, n_d, s_d) = got
    for f in ("assignment", "leader_slot", "replica_disk"):
        if not torch.equal(getattr(wm_c, f), getattr(wm_d, f).cpu()):
            fail(f"warm window: merged {f} differs between the card and the CPU")
    if not torch.equal(mk_c, mk_d) or not torch.equal(ev_c, ev_d) or (n_c, s_c) != (n_d, s_d):
        fail("warm window: touched mask or hot list differs between the card and the CPU")
    if not torch.allclose(p_c, p_d, rtol=RTOL, atol=ATOL):
        fail("warm window: pressure stacks differ between the card and the CPU")
    # the window itself on the CPU; its diff planned by the device loop on both
    snap_c = model_from_arrays({**model_arrays(host), **{k: drifted[k] for k in (
        "leader_load", "follower_load")}}, host.num_topics, host.num_racks, "cpu")
    warm_c = inc.WarmStart(session="card-vs-cpu", generation=1, assignment=wm_c.assignment,
                           leader_slot=wm_c.leader_slot, replica_disk=wm_c.replica_disk,
                           pressure=None)
    res = optimize(snap_c, cfg, goals, opts, warm_start=warm_c)
    bpp = snap_c.leader_load[Resource.DISK]
    plans = [plan_movement(res.diff, bpp.to(where), host.B, plan_options(opts, "device"))
             for where in ("cpu", dev)]
    oracle = plan_movement(res.diff, bpp, host.B, plan_options(opts, "numpy"))
    if not (same_plan(plans[0], plans[1]) and same_plan(plans[0], oracle)):
        fail("warm window: the plan's waves differ between the card, the CPU and the oracle")
    return {"touched_brokers": int(mk_c.sum()), "hot_list": n_c, "structural": s_c,
            "pressure_max_abs_err": float((p_c - p_d).abs().max()),
            "window_verified": res.verification.ok, "diff_rows": res.diff.n,
            "plan_waves": plans[0].n_waves}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    sys.path.insert(0, str(ROOT))
    from ccx_torch.device import ensure_responsive_backend
    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, evaluate_stack
    from ccx_torch.model import fixtures
    from ccx_torch.model.fixtures import bench_spec, random_cluster, shuffled_partitions
    from ccx_torch.model.tensor_model import model_arrays, model_from_arrays
    from ccx_torch.ops import broker_aggregates as agg_op
    from ccx_torch.optimizer import optimize
    from ccx_torch.rungs import build_opts, steady_options
    from ccx_torch.search.annealer import anneal
    from ccx_torch.search.incremental import STORE
    from ccx_torch.search.greedy import SwapPolishOptions, greedy_optimize, swap_polish
    from ccx_torch.search.repair import hard_repair

    # --- 1. device -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    packages = {}
    for name in ("grpc", "msgpack"):
        try:
            mod = __import__(name)
        except ImportError:
            packages[name] = None
        else:
            version = getattr(mod, "__version__", None) or getattr(mod, "version", None)
            packages[name] = ".".join(map(str, version)) if isinstance(version, tuple) else version
    t = time.monotonic()
    ensure_responsive_backend()
    probe_s = time.monotonic() - t
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "packages": packages, "probe_seconds": probe_s})

    # --- 2. build ------------------------------------------------------------
    t = time.monotonic()
    log = agg_op.build(verbose=True)
    emit({"phase": "build", "kernel": "broker_aggregates", "seconds": time.monotonic() - t,
          "ptxas": [ln for ln in log.splitlines() if "registers" in ln or "smem" in ln]})

    # --- 3. kernel against its plain version ---------------------------------
    t = time.monotonic()
    b5 = random_cluster(bench_spec("B5"), device=dev)
    fixture_s = time.monotonic() - t
    checks = {}

    def check(name, m, same_as=None):
        """``m``'s kernel results, as chosen and each way forced, against
        the plain version (and on the integers against ``same_as``);
        returns the chosen one."""
        ref = agg_op.broker_aggregates_plain(m)
        checks[name] = {"P": m.P, "B": m.B, "T": m.num_topics, "D": m.D}
        for rows in ("auto", *ROW_WAYS):
            got = agg_op.broker_aggregates_cuda(m, rows)
            torch.cuda.synchronize()
            checks[name][rows] = {"plan": agg_op.plan(m, rows),
                                  "max_abs_err": compare_aggregates(got, ref)}
            for f in INT_FIELDS if same_as is not None else ():
                if not torch.equal(getattr(got, f), getattr(same_as, f)):
                    fail(f"{name} ({rows}) disagrees on {f}")
            if rows == "auto":
                chosen = got
        return chosen

    got_b5 = check("B5", b5)
    check("B5-shuffled", shuffled_partitions(b5, seed=5), same_as=got_b5)
    del got_b5
    check("B4-jbod", random_cluster(bench_spec("B4"), device=dev))
    check("B3-dead-brokers", random_cluster(bench_spec("B3"), device=dev))
    for name in ("4000-brokers", "8000-brokers"):
        check(name, random_cluster(fixture_spec(name, fixtures), device=dev))
    # two calls in a row on two models of one shape: the second call gets
    # the first's freed buffer, filled with a non-zero pattern in between,
    # so an output cell the kernel neither zeroes nor writes shows
    relabel = torch.randperm(b5.B, generator=torch.Generator().manual_seed(5)).int().to(dev)
    other = b5.replace(assignment=torch.where(
        b5.assignment >= 0, relabel[b5.assignment.clamp(min=0).long()], -1).int())
    words = agg_op.output_layout(b5.B, b5.num_topics, b5.D)[1]
    for rows in ("auto", *ROW_WAYS):
        first = agg_op.broker_aggregates_cuda(b5, rows)
        compare_aggregates(first, agg_op.broker_aggregates_plain(b5))
        first_ptr = first.topic_replica_count.data_ptr()
        del first
        junk = torch.full((words,), -7, dtype=torch.int32, device=dev)
        junk_ptr = junk.data_ptr()
        del junk
        second = agg_op.broker_aggregates_cuda(other, rows)
        ref = agg_op.broker_aggregates_plain(other)
        torch.cuda.synchronize()
        if not second.topic_replica_count.data_ptr() == junk_ptr == first_ptr:
            fail(f"two-in-a-row ({rows}): the second call did not get the first's buffer")
        checks.setdefault("two-in-a-row", {})[rows] = {
            "max_abs_err": compare_aggregates(second, ref), "same_buffer": True}
        del second, ref
    max_err = max(c[rows]["max_abs_err"] for c in checks.values()
                  for rows in ("auto", *ROW_WAYS))
    emit({"phase": "kernel-check", "kernel": "broker_aggregates", "fixtures": checks,
          "B5_fixture_seconds": fixture_s})

    # --- 4, 5. the two paths ----------------------------------------------
    cfg = GoalConfig()
    launches, walls = {}, {}
    for phase, rung in PATHS:
        goal_names, opts, effort = build_opts("B5", rung)
        torch.cuda.reset_peak_memory_stats()
        agg_op.LAUNCHES = 0
        res = optimize(b5, cfg, goal_names, opts)
        torch.cuda.synchronize()
        launches[rung] = agg_op.LAUNCHES
        walls[rung] = res.wall_seconds
        before, after = res.stack_before.by_name(), res.stack_after.by_name()
        hard_after = float(res.stack_after.hard_violations)
        emit({
            "phase": phase, "config": "B5", "rung": rung, "goals": len(goal_names),
            "effort": {**effort, "polish_patience": opts.polish.patience,
                       "leader_iters": opts.leader_pass_max_iters,
                       "topic_rebalance_polish_iters": opts.topic_rebalance_polish_iters,
                       "run_polish": opts.run_polish},
            "sa_engine": res.sa_engine,
            "wall_seconds": res.wall_seconds, "phase_seconds": res.phase_seconds,
            "hard_violations_before": float(res.stack_before.hard_violations),
            "hard_violations_after": hard_after,
            "violations": {n: [before[n][0], after[n][0]] for n in res.stack_after.names},
            "verified": res.verification.ok, "failures": res.verification.failures,
            "replica_moves": res.num_replica_movements,
            "leadership_moves": res.num_leadership_movements,
            "move_counters": res.move_counters, "sa_accepted": res.n_sa_accepted,
            "polish_moves": res.n_polish_moves,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"broker_aggregates": launches[rung]},
        })
        if launches[rung] == 0:
            fail(f"{phase} never launched the broker_aggregates kernel")
        if not res.verification.ok:
            fail(f"{phase}: verification failed: {res.verification.failures}")
        if hard_after > 0:
            fail(f"{phase}: {hard_after} hard violations remain")
        if rung == "target":
            if res.sa_engine != "batched":
                fail(f"{phase}: the SA ran the {res.sa_engine} engine, not the batched one")
            for move_kind in ("replicaSwap", "leadershipSwap"):
                if res.move_counters[move_kind]["proposed"] == 0:
                    fail(f"{phase}: no {move_kind} was proposed")
        # the result's stack, re-scored with the plain aggregates
        replain = evaluate_stack(res.model, cfg, goal_names,
                                 agg=agg_op.broker_aggregates_plain(res.model))
        if not torch.equal(replain.violations, res.stack_after.violations):
            fail(f"{phase}: stack of the result disagrees between kernel and plain aggregates")
        if not torch.allclose(replain.costs, res.stack_after.costs, rtol=RTOL, atol=1e-6):
            fail(f"{phase}: stack costs of the result disagree between kernel and plain aggregates")
        if rung == "target":
            # the warm path's cold base
            base = res
        del res, replain

    # --- 6, 7, 8. the warm path, a structural window and the ladder -----------
    goal_names, opts, _ = build_opts("B5", "target")
    line, snap, session = warm_path(b5, base, cfg, goal_names, opts, agg_op)
    launches["warm"] = line["launches"]["broker_aggregates"]
    warm_per_window = line["launches_per_window"]
    emit(line)
    del base
    line = structural_window(snap, cfg, goal_names, opts, session, agg_op)
    launches["structural"] = line["launches"]["broker_aggregates"]
    emit(line)
    repaired, _ = hard_repair(b5, cfg, goal_names)
    line = ladder_run(repaired, cfg, goal_names, opts, agg_op)
    launches["ladder"] = line["launches"]["broker_aggregates"]
    emit(line)

    # --- 9, 10, 11. the sidecar serving path, every option, the fleet ----------
    line, served, per_propose = sidecar_serve(b5, agg_op, packages["grpc"] is not None)
    launches["sidecar-serve"] = line["launches"]["broker_aggregates"]
    emit(line)
    line = sidecar_options(b5, agg_op, packages["grpc"] is not None, line["cold"], kind)
    launches["sidecar-options"] = line["launches"]["broker_aggregates"]
    options_bound_ms = line["broker_aggregates_bound_ms"]
    per_options_propose = {k: line[k]["launches"] for k in ("cold", "repeat", "warm")}
    emit(line)
    line = fleet_phase(dev, agg_op)
    launches["fleet"] = line["launches"]["broker_aggregates"]
    emit(line)

    # --- 12. the service layer: B5 behind the REST API -------------------------
    line = service_phase(dev, agg_op, "B5", bench_spec("B5"), walls["target"])
    launches["service"] = line["launches"]["broker_aggregates"]
    per_service = {"dry_run": line["dry_run"]["launches"],
                   "detection": line["detection"]["launches"],
                   "warm_proposal": line["warm_proposal"]["launches"],
                   "demo_execution": line["demo_execution"]["launches"]}
    emit(line)
    for what in ("dry_run", "detection", "warm_proposal", "demo_execution"):
        if per_service[what] == 0:
            fail(f"service: the {what} never launched the broker_aggregates kernel")

    # --- 13. result check: the card against the CPU ---------------------------
    small = random_cluster(bench_spec("B3"), device=dev)
    host = model_from_arrays(model_arrays(small), small.num_topics, small.num_racks, "cpu")
    s_dev = evaluate_stack(small, cfg, DEFAULT_GOAL_ORDER)
    s_cpu = evaluate_stack(host, cfg, DEFAULT_GOAL_ORDER)
    if not torch.equal(s_dev.violations.cpu(), s_cpu.violations):
        fail("small-cluster stack violations differ between the card and the CPU")
    if not torch.allclose(s_dev.costs.cpu(), s_cpu.costs, rtol=RTOL, atol=1e-6):
        fail("small-cluster stack costs differ between the card and the CPU")
    emit({"phase": "result-check", "replain_violations_equal": True, "small_cpu_equal": True,
          "cpu_equal": card_against_cpu(dev), "exchange_equal": exchange_on_card(dev),
          "warm_window_equal": warm_window_on_card(dev)})

    # --- 14. B6's check and the kernel times, after the paths; the times
    # last of the two (once torch.profiler has traced the card, every later
    # launch in the process pays for the tracing) ------------------------------
    t = time.monotonic()
    b6 = random_cluster(bench_spec("B6"), device=dev)
    b6_fixture_s = time.monotonic() - t
    checks.clear()
    check("B6", b6)
    emit({"phase": "kernel-check", "kernel": "broker_aggregates", "fixtures": checks,
          "B6_fixture_seconds": b6_fixture_s})
    max_err = max(max_err, *(checks["B6"][rows]["max_abs_err"] for rows in ("auto", *ROW_WAYS)))
    wide = random_cluster(fixture_spec("4000-brokers", fixtures), device=dev)
    for name, m in zip(TIME_FIXTURES, (b5, wide, b6)):
        line = {"phase": "kernel-time", "kernel": "broker_aggregates", "model": name,
                "plan": agg_op.plan(m), **time_kernel(agg_op, m),
                "forced": {rows: time_kernel(agg_op, m, rows) for rows in ROW_WAYS}}
        if name == "B5":
            times = line
            plain_ms = cuda_ms(lambda: agg_op.broker_aggregates_plain(b5), TIMING_ITERS)
            line.update(plain_ms=plain_ms, library_ms=None)
        emit(line)
    del wide, b6
    # the model the sidecar built from the wire (B5's arrays, packed and
    # decoded): the kernel as the serving path launches it
    serve_times = time_kernel(agg_op, served)
    emit({"phase": "kernel-time", "kernel": "broker_aggregates", "model": "B5 via the sidecar",
          "plan": agg_op.plan(served), **serve_times})
    del served

    # --- 15. profile -----------------------------------------------------------
    k = PROFILE_STEPS
    single = dataclasses.replace(opts.anneal, n_steps=k, p_swap=0.0)
    batched = dataclasses.replace(opts.anneal, n_steps=k)
    polish = dataclasses.replace(opts.polish, max_iters=k, patience=k)
    swap = SwapPolishOptions(n_swap_candidates=64, n_lead_candidates=64, max_iters=k, patience=k)
    for warm in (single, batched):
        anneal(repaired, cfg, goal_names, dataclasses.replace(warm, n_steps=1))
    warm_opts = dataclasses.replace(opts, incremental=steady_options(), plan_enabled=True)
    if STORE.get(session) is None:
        fail("profile: the warm path's base is gone; its window would run cold")
    syncs = {
        "anneal_batched": host_syncs(lambda: anneal(repaired, cfg, goal_names, batched)),
        "polish": host_syncs(lambda: greedy_optimize(repaired, cfg, goal_names, polish)),
        "swap_polish": host_syncs(lambda: swap_polish(repaired, cfg, goal_names, swap)),
        "warm_window": host_syncs(lambda: optimize(snap, cfg, goal_names, warm_opts,
                                                   warm_start=STORE.get(session))),
    }
    emit({"phase": "profile", "model": "B5 after hard_repair", "host_syncs_per_call": syncs,
          "anneal": {"steps": k, "moves_per_step": single.moves_per_step, "p_swap": 0.0,
                     **device_busy(lambda: anneal(repaired, cfg, goal_names, single))},
          "polish": {"iters": k, **device_busy(
              lambda: greedy_optimize(repaired, cfg, goal_names, polish))},
          "anneal_batched": {"steps": k, "moves_per_step": batched.moves_per_step,
                             "p_swap": batched.p_swap, **device_busy(
                                 lambda: anneal(repaired, cfg, goal_names, batched))},
          "swap_polish": {"iters": k, "candidates": 128, **device_busy(
              lambda: swap_polish(repaired, cfg, goal_names, swap))},
          "warm_window": {"model": "the warm path's last snapshot", **device_busy(
              lambda: optimize(snap, cfg, goal_names, warm_opts,
                               warm_start=STORE.get(session)))}})

    # --- 16. summary lines -----------------------------------------------------
    if options_bound_ms != times["bound_ms"]:
        fail(f"the costModel's broker-aggregates bound {options_bound_ms} ms differs from the "
             f"kernel line's {times['bound_ms']} ms")
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "broker_aggregates", "route": "cuda",
        "source": "ccx_torch/csrc/broker_aggregates.cu",
        "replaces": "ccx/ops/mxu_aggregates.py:210",
        "launches": launches["target"], "launches_by_path": launches,
        "launches_per_warm_window": warm_per_window,
        "launches_per_sidecar_propose": per_propose,
        "launches_per_options_propose": per_options_propose,
        "launches_per_service_rebalance": per_service["dry_run"],
        "launches_per_service_verb": per_service,
        "sidecar_path": {k: serve_times[k] for k in ("device_ms", "call_ms", "host_us")},
        "max_abs_err": max_err,
        "ms": times["call_ms"], "device_ms": times["device_ms"],
        "call_ms": times["call_ms"], "host_us": times["host_us"],
        "plain_ms": plain_ms, "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
