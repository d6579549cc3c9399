#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ccx_torch``) on one NVIDIA GPU.

Phases, one JSON line each:

1. device — the card's name, count and ``nvidia-smi`` name/power limit;
   TF32 off for matrix products and convolutions;
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
   default goal stack at the bench's "target" rung (16 chains x 250 steps x
   8 moves, polish 150 iterations patience 8, leader pass 100) with
   ``p_swap=0``: wall and phase seconds, violations before and after,
   ``verified`` and the kernel launch counts of this run; the final stack is
   re-scored with the plain aggregates, and a small cluster's stack on the
   card is held against the same stack on the CPU;
5. after the main path, which so runs as it would alone: the same kernel
   check on B6 (10k brokers / 1M partitions, whose shared rows need broker
   tiles), then the kernel times at B5, 4000 brokers and B6 (last, since
   torch.profiler's tracing slows every later launch of the process):
   ``device_ms`` (every device op of a call, from torch.profiler, each named
   in ``device_ops``), ``call_ms`` (CUDA events around back-to-back calls),
   ``host_us`` (host enqueue time per call) and the byte bound, for the
   kernel's own choice and for each forced way; at B5 also the plain
   version's time. The ``kernels`` line gives B5's: its ``ms`` is the call
   time ``call_ms``, beside ``device_ms`` and ``host_us``;
6. profile — the device busy share of 10 SA steps and 10 polish
   iterations on the repaired B5 model, under torch.profiler;
7. the card's ``nvidia-smi`` line, then the ``kernels`` line, then the
   contract line ``{"ok": true, "device": {...}}`` last.

Any failed check, an unverified result, remaining hard violations or a
kernel of the main path launched zero times exits non-zero. Needs one CUDA
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

#: H100 SXM data-sheet peaks (dense): memory rate and float32 rate outside
#: the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
RTOL, ATOL = 1e-5, 1e-3
FLOAT_FIELDS = ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load")
INT_FIELDS = ("replica_count", "leader_count", "topic_replica_count", "topic_leader_count")
#: the bench's "target" rung (bench.py:223), with swaps off
CHAINS, STEPS, MOVES = 16, 250, 8
POLISH_ITERS, POLISH_PATIENCE, LEADER_ITERS = 150, 8, 100
#: CUDA-event timing launches per kernel; SA steps and polish iterations
#: under the profiler
TIMING_ITERS, PROFILE_STEPS = 200, 10
#: sparse wide clusters, two partitions per broker: B pads to 4096, then to
#: 8192, where the kernel's rows in shared memory need broker tiles
WIDE_SPEC = dict(n_brokers=4000, n_racks=40, n_topics=64, n_partitions=8000,
                 n_dead_brokers=3, seed=7)
WIDER_SPEC = dict(n_brokers=8000, n_racks=40, n_topics=64, n_partitions=16000,
                  n_dead_brokers=3, seed=8)
#: fixtures of the kernel-time phase: B5, a sparse wide cluster, and B6,
#: whose 16384 brokers need broker tiles for rows in shared memory
TIME_FIXTURES = ("B5", "4000-brokers", "B6")
#: the kernel's ways of summing the per-broker rows, forced in the checks
ROW_WAYS = ("shared", "global")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def time_kernel(agg_op, m, rows: str | None = None) -> dict:
    """``kernel_times`` of one ``agg_op.broker_aggregates_cuda`` call on
    ``m`` (``rows`` forced where given), beside the byte bound."""
    if rows is None:
        call = lambda: agg_op.broker_aggregates_cuda(m)  # noqa: E731
    else:
        call = lambda: agg_op.broker_aggregates_cuda(m, rows)  # noqa: E731
    bound_ms, bound_by = aggregates_bound_ms(m)
    return {**kernel_times(call, TIMING_ITERS), "bound_ms": bound_ms, "bound_by": bound_by}


def aggregates_bound_ms(m) -> tuple[float, str]:
    """Least time for the aggregate pass on this model and what sets it:
    every input it needs read once and every output written once over the
    memory rate, against at most 12 additions per replica (7 float, 5
    int32), all charged at the float32 rate. A padding partition costs only
    its ``partition_valid`` byte."""
    P, R, B, T, D = m.P, m.R, m.B, m.num_topics, m.D
    n_valid = int(m.partition_valid.sum())
    # assignment and replica_disk rows, leader_slot, partition_topic, and the
    # leader and follower loads of a live partition
    per_valid = R * 4 * 2 + 4 * 2 + 2 * 4 * 4
    read = P * 1 + n_valid * per_valid
    written = 4 * B * 4 + 4 * B * 4 + 2 * T * B * 4 + B * D * 4
    n_replicas = int(m.replica_valid.sum())
    t_bytes = (read + written) / PEAK_BYTES_PER_S
    t_ops = 12 * n_replicas / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    from ccx_torch.goals.base import GoalConfig
    from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER, evaluate_stack
    from ccx_torch.model import fixtures
    from ccx_torch.model.fixtures import bench_spec, random_cluster, shuffled_partitions
    from ccx_torch.model.tensor_model import model_arrays, model_from_arrays
    from ccx_torch.ops import broker_aggregates as agg_op
    from ccx_torch.optimizer import OptimizeOptions, optimize
    from ccx_torch.search.annealer import AnnealOptions, anneal
    from ccx_torch.search.greedy import GreedyOptions, greedy_optimize
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
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

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

    # --- 4. main path ----------------------------------------------------------
    cfg = GoalConfig()
    opts = OptimizeOptions(
        anneal=AnnealOptions(
            n_chains=CHAINS, n_steps=STEPS, moves_per_step=MOVES, seed=42, p_swap=0.0,
        ),
        polish=GreedyOptions(n_candidates=256, max_iters=POLISH_ITERS, patience=POLISH_PATIENCE),
        leader_pass_max_iters=LEADER_ITERS,
    )
    torch.cuda.reset_peak_memory_stats()
    agg_op.LAUNCHES = 0
    res = optimize(b5, cfg, DEFAULT_GOAL_ORDER, opts)
    torch.cuda.synchronize()
    launches = agg_op.LAUNCHES
    before, after = res.stack_before.by_name(), res.stack_after.by_name()
    hard_after = float(res.stack_after.hard_violations)
    emit({
        "phase": "main-path", "config": "B5", "goals": len(DEFAULT_GOAL_ORDER),
        "effort": {"chains": CHAINS, "steps": STEPS, "moves": MOVES,
                   "polish_iters": POLISH_ITERS, "polish_patience": POLISH_PATIENCE,
                   "leader_iters": LEADER_ITERS, "p_swap": 0.0},
        "wall_seconds": res.wall_seconds, "phase_seconds": res.phase_seconds,
        "hard_violations_before": float(res.stack_before.hard_violations),
        "hard_violations_after": hard_after,
        "violations": {n: [before[n][0], after[n][0]] for n in res.stack_after.names},
        "verified": res.verification.ok, "failures": res.verification.failures,
        "replica_moves": res.num_replica_movements,
        "leadership_moves": res.num_leadership_movements,
        "move_counters": res.move_counters, "sa_accepted": res.n_sa_accepted,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": {"broker_aggregates": launches},
    })
    if launches == 0:
        fail("the main path never launched the broker_aggregates kernel")
    if not res.verification.ok:
        fail(f"verification failed: {res.verification.failures}")
    if hard_after > 0:
        fail(f"{hard_after} hard violations remain")

    # the result's stack, re-scored with the plain aggregates
    replain = evaluate_stack(res.model, cfg, DEFAULT_GOAL_ORDER,
                             agg=agg_op.broker_aggregates_plain(res.model))
    if not torch.equal(replain.violations, res.stack_after.violations):
        fail("stack of the result disagrees between kernel and plain aggregates")
    if not torch.allclose(replain.costs, res.stack_after.costs, rtol=RTOL, atol=1e-6):
        fail("stack costs of the result disagree between kernel and plain aggregates")
    # a small cluster's stack on the card against the same stack on the CPU
    small = random_cluster(bench_spec("B3"), device=dev)
    host = model_from_arrays(model_arrays(small), small.num_topics, small.num_racks, "cpu")
    s_dev = evaluate_stack(small, cfg, DEFAULT_GOAL_ORDER)
    s_cpu = evaluate_stack(host, cfg, DEFAULT_GOAL_ORDER)
    if not torch.equal(s_dev.violations.cpu(), s_cpu.violations):
        fail("small-cluster stack violations differ between the card and the CPU")
    if not torch.allclose(s_dev.costs.cpu(), s_cpu.costs, rtol=RTOL, atol=1e-6):
        fail("small-cluster stack costs differ between the card and the CPU")
    emit({"phase": "result-check", "replain_violations_equal": True, "small_cpu_equal": True})

    # --- 5. B6's check and the kernel times, after the main path; the times
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

    # --- 6. profile ------------------------------------------------------------
    repaired, _ = hard_repair(b5, cfg, DEFAULT_GOAL_ORDER)
    k = PROFILE_STEPS
    sa_opts = dataclasses.replace(opts.anneal, n_steps=k)
    polish = dataclasses.replace(opts.polish, max_iters=k, patience=k)
    anneal(repaired, cfg, DEFAULT_GOAL_ORDER, dataclasses.replace(sa_opts, n_steps=1))
    emit({"phase": "profile", "model": "B5 after hard_repair",
          "anneal": {"steps": k, "moves_per_step": MOVES, **device_busy(
              lambda: anneal(repaired, cfg, DEFAULT_GOAL_ORDER, sa_opts))},
          "polish": {"iters": k, **device_busy(
              lambda: greedy_optimize(repaired, cfg, DEFAULT_GOAL_ORDER, polish))}})

    # --- 7. summary lines ------------------------------------------------------
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "broker_aggregates", "route": "cuda",
        "source": "ccx_torch/csrc/broker_aggregates.cu",
        "replaces": "ccx/ops/mxu_aggregates.py:210",
        "launches": launches, "max_abs_err": max_err,
        "ms": times["call_ms"], "device_ms": times["device_ms"],
        "call_ms": times["call_ms"], "host_us": times["host_us"],
        "plain_ms": plain_ms, "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
