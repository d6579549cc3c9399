"""The port's chunked drives: chunked runs equal one-loop runs, the taps record
the states, and the plateau exit decides on the current chunk.

* SA: a chunked run (chunks that do not divide the budget) equals the
  one-loop run exactly, for the batched and the sequential engine.
* Descents: ``greedy_optimize`` and ``swap_polish`` chunked equal their
  one-loop runs exactly, with the host's early look at the stop flag on and
  off (off, every chunk runs its inert tail after the stop); so do their
  graphed drives (a stand-in graph whose replay re-runs the captured
  iteration), whose span counters count one capture and a replay for every
  call after the first, and nothing at a budget of one.
* SA graphs: a run whose steps replay a stand-in that freezes what a CUDA
  graph's capture freezes (the recorded ops, each Python number as at the
  capture) equals the run whose stand-in re-runs the step, for every engine,
  one-loop and chunked, and under the ladder: no per-step value is a host
  number the capture would keep. The span counts one capture and n - 1
  replays, nothing at a budget of one or off a card, and a batched run's
  counted syncs do not grow with its steps.
* Taps: ``record``/``lex_best_row``/``decode`` equal the JAX package's on the
  same values; a descent's tap rows equal the states of runs cut at each
  chunk's end.
* ``drive_chunks``/``PlateauExit``: the pins of the JAX package's
  ``tests/test_incremental.py`` (current row, window, ``min_chunks``, a
  malformed row degrading to the fixed budget), and an error raised by the
  row read propagates.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from ccx.search import telemetry as jtel
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.search import annealer as tann
from ccx_torch.search import greedy as tgreedy
from ccx_torch.search import telemetry as ttel
from ccx_torch.search.annealer import PlateauExit, drive_chunks

CFG = GoalConfig()
GOALS = DEFAULT_GOAL_ORDER
WIDE = RandomClusterSpec(n_brokers=64, n_racks=8, n_topics=16, n_partitions=400,
                         n_dead_brokers=2, seed=11)
SMALL = RandomClusterSpec(n_brokers=14, n_racks=4, n_topics=10, n_partitions=300, seed=31)
#: a cluster on which a small swap polish stops on its patience
SPARSE = RandomClusterSpec(n_brokers=32, n_racks=4, n_topics=8, n_partitions=120, seed=3)


@pytest.fixture(scope="module")
def wide():
    return random_cluster(WIDE, device="cpu")


@pytest.fixture(scope="module")
def small():
    return random_cluster(SMALL, device="cpu")


def _same_model(a, b) -> None:
    for f in ("assignment", "leader_slot", "replica_disk"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_chunked_sa_equals_one_loop(wide, small, engine):
    m, opts = (wide, tann.AnnealOptions(n_chains=3, n_steps=11, moves_per_step=4, seed=5)) \
        if engine == "batched" else (small, tann.AnnealOptions(n_chains=3, n_steps=30, seed=5))
    flat = tann.anneal(m, CFG, GOALS, opts)
    chunked = tann.anneal(m, CFG, GOALS, dataclasses.replace(opts, chunk_steps=4))
    assert flat.engine == chunked.engine == engine
    _same_model(flat.model, chunked.model)
    assert torch.equal(flat.stack_after.costs, chunked.stack_after.costs)
    assert (flat.best_chain, flat.n_accepted, flat.n_prop_kind, flat.n_acc_kind) == (
        chunked.best_chain, chunked.n_accepted, chunked.n_prop_kind, chunked.n_acc_kind)
    conv = chunked.convergence
    assert conv["chunks"] == -(-opts.n_steps // 4) and conv["budget"] == opts.n_steps
    n = opts.n_steps
    decay = (opts.t1 / opts.t0) ** (1.0 / (n - 1))
    ends = [min((i + 1) * 4, n) - 1 for i in range(conv["chunks"])]
    assert conv["temperature"] == [round(float(np.float32(opts.t0 * decay**t)), 6) for t in ends]


def _result_tuple(r):
    return (r.n_iters, r.n_moves, r.n_prop_kind, r.n_acc_kind)


class _Replayed:
    """A stand-in for a descent's CUDA graph: ``capture`` records the
    iteration's closure and ``replay`` runs it again."""

    def __init__(self, dev, gen) -> None:
        self.fn = None
        self.released = False

    def capture(self, fn) -> None:
        assert self.fn is None
        self.fn = fn

    def replay(self) -> None:
        self.fn()

    def release(self) -> None:
        self.released = True


def _use_graphs(monkeypatch) -> list:
    """Drive every descent through stand-in graphs; returns those made."""
    made = []

    def make(dev, gen):
        made.append(_Replayed(dev, gen))
        return made[-1]

    monkeypatch.setattr(tgreedy, "_iteration_graph", make)
    return made


def _counted(fn, m, opts):
    """(the descent's result, its span's graph counters)."""
    with TRACER.span("descent") as s:
        res = fn(m, CFG, GOALS, opts)
    return res, (s.attrs["graphCaptures"], s.attrs["graphReplays"])


def _check_counts(counted, res, opts, poll, graph) -> None:
    """One capture, and a replay for every call of the iteration after the
    first: the iterations where the host sees the stop at once, every
    chunk's whole length up to the budget where it does not look."""
    calls = res.n_iters
    if opts.chunk_iters and not poll:
        calls = min(opts.chunk_iters * math.ceil(res.n_iters / opts.chunk_iters), opts.max_iters)
    assert counted == ((int(calls > 1), calls - 1) if graph else (0, 0))


def _drives(*extra: str) -> list:
    """(host poll, graphed, *extra flags) cases; the eager cases without a
    flag keep the ids ``True`` and ``False``."""
    flags = ("graph",) + extra
    out = []
    for mask in range(1 << len(flags)):
        on = [bool(mask >> i & 1) for i in range(len(flags))]
        for poll in (True, False):
            name = "-".join([str(poll)] + [f for f, o in zip(flags, on) if o])
            out.append(pytest.param(poll, *on, id=name))
    return out


@pytest.mark.parametrize("poll, graph, lead", _drives("lead"))
def test_chunked_greedy_equals_one_loop(small, poll, graph, lead, monkeypatch):
    opts = tgreedy.GreedyOptions(n_candidates=4, max_iters=30, patience=1, seed=4,
                                 leadership_only=lead)
    eager = tgreedy.greedy_optimize(small, CFG, GOALS, dataclasses.replace(opts, chunk_iters=0))
    if not poll:
        monkeypatch.setattr(tgreedy, "_poll_stop", lambda *a: False)
    made = _use_graphs(monkeypatch) if graph else []
    runs = [dataclasses.replace(opts, chunk_iters=c) for c in (0, 7, 50)]
    for o in runs:
        ch, counted = _counted(tgreedy.greedy_optimize, small, o)
        _same_model(eager.model, ch.model)
        assert _result_tuple(eager) == _result_tuple(ch)
        assert torch.equal(eager.stack_after.costs, ch.stack_after.costs)
        _check_counts(counted, ch, o, poll, graph)
    assert len(made) == (len(runs) if graph else 0) and all(g.released for g in made)
    # the stop fired inside a chunk: its later iterations were inert
    assert 0 < eager.n_moves and eager.n_iters < opts.max_iters and eager.convergence is None


@pytest.mark.parametrize("poll, graph", _drives())
def test_chunked_swap_polish_equals_one_loop(poll, graph, monkeypatch):
    m = random_cluster(SPARSE, device="cpu")
    opts = tgreedy.SwapPolishOptions(n_swap_candidates=2, n_lead_candidates=2, max_iters=20,
                                     patience=1, seed=2)
    eager = tgreedy.swap_polish(m, CFG, GOALS, dataclasses.replace(opts, chunk_iters=0))
    if not poll:
        monkeypatch.setattr(tgreedy, "_poll_stop", lambda *a: False)
    made = _use_graphs(monkeypatch) if graph else []
    for o in (dataclasses.replace(opts, chunk_iters=c) for c in (0, 6)):
        ch, counted = _counted(tgreedy.swap_polish, m, o)
        _same_model(eager.model, ch.model)
        assert _result_tuple(eager) == _result_tuple(ch)
        _check_counts(counted, ch, o, poll, graph)
    assert len(made) == (2 if graph else 0) and all(g.released for g in made)
    assert 0 < eager.n_moves and eager.n_iters < opts.max_iters


@pytest.mark.parametrize("chunk", [0, 7])
def test_a_budget_of_one_captures_no_graph(small, chunk, monkeypatch):
    monkeypatch.setattr(tgreedy, "_poll_stop", lambda *a: False)
    made = _use_graphs(monkeypatch)
    opts = tgreedy.GreedyOptions(n_candidates=4, max_iters=1, seed=4, chunk_iters=chunk)
    res, counted = _counted(tgreedy.greedy_optimize, small, opts)
    assert res.n_iters == 1 and counted == (0, 0) and not made


class _Recorded:
    """A stand-in for an SA run's CUDA graph that freezes what a capture
    freezes: its first replay runs the captured step under a dispatch mode
    that records every aten op with its arguments, and every later replay
    runs the recorded ops again, each Python number as it was at the
    capture, on the tensors the step reads and writes (the ops' own outputs
    made afresh). A host read inside the step raises, as on a card."""

    def __init__(self, dev, gen) -> None:
        self.fn = None
        self.ops = None
        self.released = False

    def capture(self, fn) -> None:
        assert self.fn is None
        self.fn = fn

    def replay(self) -> None:
        if self.ops is None:
            rec = _OpRecorder()
            with rec:
                self.fn()
            self.ops = rec.ops
            return
        fresh = {}

        def sub(x):
            return fresh.get(id(x), x) if torch.is_tensor(x) else x

        for func, args, kwargs, out in self.ops:
            res = func(*tree_map(sub, args), **tree_map(sub, kwargs))
            for o, r in zip(tree_leaves(out), tree_leaves(res)):
                if torch.is_tensor(o):
                    fresh[id(o)] = r

    def release(self) -> None:
        self.released = True


class _OpRecorder(TorchDispatchMode):
    """Runs and records each aten op (its outputs kept alive, so no id is
    reused while the record lives)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a host read inside a captured SA step")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _use_step_graphs(monkeypatch, kind) -> list:
    """Drive every SA run through stand-in graphs of ``kind``; returns those
    made."""
    made = []

    def make(dev, gen):
        made.append(kind(dev, gen))
        return made[-1]

    monkeypatch.setattr(tann, "_step_graph", make)
    return made


#: (engine, chunk_steps): every engine one-loop and chunked, and a ladder
SA_GRAPH_CASES = [(e, c) for e in ("batched", "sequential", "single") for c in (0, 4)] + [
    ("ladder", 4)]


def _sa_case(engine: str, chunk: int, wide, small):
    """(model, options) of a graph case. The swap share ramps where swaps
    run and the temperature decays, so a frozen per-step value changes the
    run; the batched case uses coupled swaps (``usage_weights``)."""
    if engine == "batched":
        return wide, tann.AnnealOptions(n_chains=3, n_steps=9, moves_per_step=4, seed=5,
                                        p_swap_end=0.6, chunk_steps=chunk)
    if engine == "sequential":
        return small, tann.AnnealOptions(n_chains=3, n_steps=14, moves_per_step=2, seed=5,
                                         p_swap_end=0.7, chunk_steps=chunk)
    if engine == "single":
        return small, tann.AnnealOptions(n_chains=3, n_steps=14, moves_per_step=2, seed=5,
                                         p_swap=0.0, chunk_steps=chunk)
    return wide, tann.AnnealOptions(n_chains=4, n_steps=9, moves_per_step=4, seed=5,
                                    p_swap_end=0.6, chunk_steps=chunk, n_temps=2)


def _sa_counted(m, opts):
    """(the SA result, its span's graph counters)."""
    with TRACER.span("anneal") as s:
        res = tann.anneal(m, CFG, GOALS, opts)
    return res, (s.attrs["graphCaptures"], s.attrs["graphReplays"])


@pytest.mark.parametrize("engine, chunk", SA_GRAPH_CASES)
def test_graphed_sa_equals_the_eager_stand_in(wide, small, engine, chunk, monkeypatch):
    m, opts = _sa_case(engine, chunk, wide, small)
    runs = []
    for kind in (_Recorded, _Replayed):
        made = _use_step_graphs(monkeypatch, kind)
        res, counted = _sa_counted(m, opts)
        assert counted == (1, opts.n_steps - 1)
        assert len(made) == 1 and made[0].released
        runs.append(res)
    got, ref = runs
    assert got.engine == ref.engine == ("batched" if engine == "ladder" else engine)
    _same_model(got.model, ref.model)
    assert torch.equal(got.stack_after.costs, ref.stack_after.costs)
    assert (got.best_chain, got.n_accepted, got.n_prop_kind, got.n_acc_kind) == (
        ref.best_chain, ref.n_accepted, ref.n_prop_kind, ref.n_acc_kind)
    assert ref.n_accepted > 0
    if chunk:
        assert got.convergence == ref.convergence


@pytest.mark.parametrize("chunk", [0, 4])
def test_an_sa_budget_of_one_captures_no_graph(small, chunk, monkeypatch):
    made = _use_step_graphs(monkeypatch, _Replayed)
    opts = tann.AnnealOptions(n_chains=2, n_steps=1, seed=5, chunk_steps=chunk)
    res, counted = _sa_counted(small, opts)
    assert res.n_steps == 1 and counted == (0, 0) and not made


def test_sa_graph_counters_read_zero_off_a_card(small):
    res, counted = _sa_counted(small, tann.AnnealOptions(n_chains=2, n_steps=6, seed=5))
    assert counted == (0, 0) and res.n_steps == 6


def test_batched_sa_syncs_do_not_grow_with_the_steps(wide):
    syncs = []
    for n in (2, 8):
        opts = tann.AnnealOptions(n_chains=2, n_steps=n, moves_per_step=4, seed=5)
        with TRACER.span("anneal") as s:
            assert tann.anneal(wide, CFG, GOALS, opts).engine == "batched"
        syncs.append(s.to_json()["syncs"]["total"])
    assert syncs[0] == syncs[1], syncs


def test_descent_tap_rows_equal_the_cut_runs(small):
    opts = tgreedy.GreedyOptions(n_candidates=32, max_iters=9, patience=9, chunk_iters=3, seed=6)
    res = tgreedy.greedy_optimize(small, CFG, GOALS, opts)
    conv = res.convergence
    assert conv["chunks"] == 3 and conv["chunk"] == 3 and conv["budget"] == 9
    for i in range(3):
        cut = tgreedy.greedy_optimize(small, CFG, GOALS, dataclasses.replace(opts, max_iters=3 * (i + 1)))
        assert conv["proposed"][i] == list(cut.n_prop_kind)
        assert conv["accepted"][i] == list(cut.n_acc_kind)
        np.testing.assert_allclose(conv["series"][i], cut.stack_after.costs.numpy(), rtol=1e-5, atol=1e-3)
    assert conv["temperature"] == [0.0] * 3


def test_tap_record_and_decode_equal_jax():
    rng = np.random.default_rng(3)
    goals = ("a", "b", "c")
    with ttel.taps(True):
        ttel.set_max_chunks(3)
        try:
            ttap = ttel.make_tap(3, "cpu")
            jtap = (jnp.zeros((3, 3 + jtel.EXTRA), jnp.float32), jnp.zeros((), jnp.int32))
            for i in range(5):
                vecs = rng.uniform(0, 5, size=(4, 3)).astype(np.float32)
                vecs[1] = vecs[0]
                prop, acc = rng.integers(0, 100, 3), rng.integers(0, 10, 3)
                ex = (int(rng.integers(0, 4)), 1) if i % 2 else (None, None)
                np.testing.assert_array_equal(
                    ttel.lex_best_row(torch.from_numpy(vecs)).numpy(),
                    np.asarray(jtel.lex_best_row(jnp.asarray(vecs))))
                ttel.record(ttap, ttel.lex_best_row(torch.from_numpy(vecs)), torch.from_numpy(prop),
                            torch.from_numpy(acc), 0.25 / (i + 1), *ex)
                jtap = jtel.record(jtap, jtel.lex_best_row(jnp.asarray(vecs)), prop, acc,
                                   0.25 / (i + 1), *ex)
            np.testing.assert_array_equal(ttap[0].numpy(), np.asarray(jtap[0]))
            assert int(ttap[1]) == int(jtap[1]) == 5
            got = ttel.decode(ttap, goals, chunk_size=4, budget=20, ladder={"nTemps": 2})
            assert got == jtel.decode(jtap, goals, chunk_size=4, budget=20, ladder={"nTemps": 2})
            assert got["truncated"] and len(got["series"]) == 3
        finally:
            ttel.set_max_chunks(256)
    assert ttel.decode(None, goals) is None


def _count(carry, off):
    return carry + 1, None


def test_plateau_exit_reads_the_current_row():
    energies = [10.0, 9.0, 9.0, 8.0, 7.0]
    plateau = PlateauExit(row=lambda c: torch.tensor([energies[c - 1]]), window=1)
    assert drive_chunks(_count, 0, total=5, chunk=1, plateau=plateau) == 3
    assert plateau.exited and plateau.chunks_run == 3 and plateau.last_improved_chunk == 2
    assert plateau.to_json(budget_chunks=5) == {
        "exited": True, "chunksRun": 3, "window": 1, "lastImprovedChunk": 2, "chunksBudget": 5}


def test_plateau_window_and_min_chunks():
    flat = lambda c: [10.0]  # noqa: E731
    assert drive_chunks(_count, 0, total=5, chunk=1, plateau=PlateauExit(row=flat, window=2)) == 3
    assert drive_chunks(_count, 0, total=5, chunk=1,
                        plateau=PlateauExit(row=flat, window=1, min_chunks=4)) == 4
    p = PlateauExit(row=lambda c: [10.0 - c], window=1)
    assert drive_chunks(_count, 0, total=3, chunk=1, plateau=p) == 3
    assert not p.exited


def test_malformed_tap_row_degrades_to_the_fixed_budget():
    p = PlateauExit(row=lambda c: ["tap", "unavailable"], window=1)
    assert drive_chunks(_count, 0, total=4, chunk=1, plateau=p) == 4
    assert not p.exited
    p = PlateauExit(row=lambda c: None, window=1)
    assert drive_chunks(_count, 0, total=4, chunk=1, plateau=p) == 4


def test_a_failing_row_read_propagates():
    def failing(carry):
        raise RuntimeError("device error")

    with pytest.raises(RuntimeError, match="device error"):
        drive_chunks(_count, 0, total=4, chunk=1, plateau=PlateauExit(row=failing))


def test_done_flag_ends_the_drive():
    assert drive_chunks(lambda c, off: (c + 1, torch.tensor(c + 1 >= 2)), 0, total=10, chunk=3) == 2


def test_anneal_plateau_report(small):
    opts = tann.AnnealOptions(n_chains=2, n_steps=16, chunk_steps=4, seed=1, plateau_window=1)
    with ttel.taps(True):
        res = tann.anneal(small, CFG, GOALS, opts)
        res2 = tann.anneal(small, CFG, GOALS, dataclasses.replace(opts, plateau_window=2, seed=2))
        res3 = tann.anneal(small, CFG, GOALS, dataclasses.replace(opts, plateau_window=0))
    assert res.plateau["chunksBudget"] == 4 and 1 <= res.plateau["chunksRun"] <= 4
    assert res2.plateau["window"] == 2
    assert res3.plateau is None
    with ttel.taps(False):
        off = tann.anneal(small, CFG, GOALS, opts)
    assert off.plateau is None and off.convergence is None
