"""The SA steps' CUDA graphs on the card.

* ``DeviceTemperature`` holds the number CUDA multiplies by where it
  divides a tensor by a host float, so a captured step's Metropolis test
  has the eager step's bits.
* An SA run whose steps replay one captured CUDA graph gives the same
  placement, winner, acceptances and move-kind counters as the same run
  through a stand-in graph whose replay re-runs the captured step, and as
  the run with no graph (every step eager, the schedule as host floats):
  every engine, and the batched engine under the replica-exchange ladder,
  at the same seed.
* Every run captures its own graph and retires it, and the card's reserved
  memory after ten rounds of an anneal and a polish (their graphs share
  one free list of retired pools) is what it was after two.
* Captures and another thread's device-wide synchronize
  (``ccx_torch.device.synchronize``, as a fleet job's phase ends) take
  turns: neither fails. A capture that fails raises, is not retired, and
  the next capture on the card works.

This file imports only torch and ``ccx_torch``, so on a machine with a card
(where JAX is not installed) its tests run with
``python -m pytest --noconftest tests/test_torch_sa_graph.py -m gpu``.
"""

from __future__ import annotations

import threading

import pytest
import torch

from ccx_torch import device
from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.search import annealer, graphs, greedy

CFG = GoalConfig()
GOALS = DEFAULT_GOAL_ORDER
#: wide enough for the batched engine at 4 moves a step (64 >= 4 * R * moves)
WIDE = RandomClusterSpec(n_brokers=64, n_racks=8, n_topics=16, n_partitions=2000,
                         n_dead_brokers=0, seed=11)
#: a B3-like heal: the sequential engine, two dead brokers
NARROW = RandomClusterSpec(n_brokers=20, n_racks=4, n_topics=20, n_partitions=2000,
                           n_dead_brokers=2, seed=3)
CASES = {
    "batched": (WIDE, annealer.AnnealOptions(n_chains=8, n_steps=12, moves_per_step=4,
                                             chunk_steps=5, seed=3)),
    "sequential": (NARROW, annealer.AnnealOptions(n_chains=8, n_steps=12, moves_per_step=2,
                                                  chunk_steps=5, seed=3)),
    "ladder": (WIDE, annealer.AnnealOptions(n_chains=8, n_steps=12, moves_per_step=4,
                                            chunk_steps=4, n_temps=2, seed=3)),
    "single": (NARROW, annealer.AnnealOptions(n_chains=8, n_steps=12, moves_per_step=2,
                                              p_swap=0.0, seed=3)),
}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


class _Eager:
    """A stand-in graph: ``capture`` records the step's closure and
    ``replay`` runs it again, eagerly."""

    def __init__(self, dev, gen) -> None:
        self.fn = None

    def capture(self, fn) -> None:
        self.fn = fn

    def replay(self) -> None:
        self.fn()

    def release(self) -> None:
        self.fn = None


def _run(m, opts):
    """One SA run under a span: (result, graph counters)."""
    with TRACER.span("anneal") as s:
        res = annealer.anneal(m, CFG, GOALS, opts)
    return res, (s.attrs["graphCaptures"], s.attrs["graphReplays"])


def _key(res) -> tuple:
    return (res.engine, res.best_chain, res.n_accepted, res.n_prop_kind, res.n_acc_kind)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_anneal_equals_eager_on_card(case, monkeypatch):
    spec, opts = CASES[case]
    m = random_cluster(spec, device=_card())
    got, counted = _run(m, opts)
    assert counted == (1, opts.n_steps - 1)
    assert got.engine == {"ladder": "batched"}.get(case, case)
    for stand_in in (_Eager, lambda d, g: None):
        monkeypatch.setattr(annealer, "_step_graph", stand_in)
        ref, _ = _run(m, opts)
        assert ref.n_accepted > 0
        for f in ("assignment", "leader_slot", "replica_disk"):
            assert torch.equal(getattr(got.model, f), getattr(ref.model, f)), f
        assert _key(got) == _key(ref)
        assert torch.equal(got.stack_after.costs, ref.stack_after.costs)


@pytest.mark.gpu
def test_device_temperature_multiplies_as_cuda_divides():
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(1 << 18, device=dev, generator=gen)
    x = x * torch.exp(2.0 * torch.randn(1 << 18, device=dev, generator=gen))
    flat = annealer.DeviceTemperature(torch.zeros((), device=dev))
    for i in range(100):
        t = 0.3 * (1e-4 / 0.3) ** (i / 99)
        flat.set(t)
        assert torch.equal(-x / max(t, 1e-30), -x * flat.inv), t


@pytest.mark.gpu
def test_anneal_graphs_do_not_outlive_their_runs(monkeypatch):
    dev = _card()
    spec, opts = CASES["sequential"]
    m = random_cluster(spec, device=dev)
    made = []

    def spy(d, gen):
        made.append(graphs.CudaStepGraph(d, gen))
        return made[-1]

    monkeypatch.setattr(annealer, "_step_graph", spy)
    for _ in range(20):
        assert _run(m, opts)[1][0] == 1
    assert len(made) == 20 and all(g.graph is None for g in made)


@pytest.mark.gpu
def test_anneal_and_descent_graphs_share_one_free_list():
    dev = _card()
    spec, opts = CASES["batched"]
    m = random_cluster(spec, device=dev)
    polish = greedy.GreedyOptions(n_candidates=128, max_iters=12, patience=12, chunk_iters=5,
                                  seed=3)
    reserved = []
    for _ in range(10):
        assert _run(m, opts)[1][0] == 1
        with TRACER.span("polish") as s:
            greedy.greedy_optimize(m, CFG, GOALS, polish)
        assert s.attrs["graphCaptures"] == 1
        torch.cuda.synchronize(dev)
        reserved.append(torch.cuda.memory_reserved(dev))
    assert reserved[-1] == reserved[1], reserved


@pytest.mark.gpu
def test_captures_and_another_threads_synchronize_take_turns():
    dev = _card()
    spec, opts = CASES["sequential"]
    m = random_cluster(spec, device=dev)
    stop = threading.Event()
    errors = []

    def drain() -> None:
        try:
            while not stop.is_set():
                device.synchronize(dev)
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    t = threading.Thread(target=drain)
    t.start()
    try:
        for _ in range(6):
            assert _run(m, opts)[1][0] == 1
    finally:
        stop.set()
        t.join()
    assert not errors, errors


@pytest.mark.gpu
def test_a_failed_capture_raises_and_is_not_retired():
    # last in the file: it leaves a capture's error behind in the allocator
    dev = _card()
    gen = torch.Generator(device=dev)
    x = torch.zeros((), device=dev)
    free = graphs._RETIRED.setdefault(dev.index, [])
    before = len(free)
    failed = graphs.CudaStepGraph(dev, gen)
    with pytest.raises(RuntimeError):
        failed.capture(lambda: float(x + 1))  # a host read cannot be captured
    failed.release()
    # the retired pool it took is gone with it
    assert failed.graph is None and len(free) == max(before - 1, 0)
    ok = graphs.CudaStepGraph(dev, gen)
    ok.capture(lambda: x.add_(1))
    ok.replay()
    ok.release()
    torch.cuda.synchronize(dev)
    assert float(x) == 1.0 and len(free) == max(before - 1, 0) + 1
