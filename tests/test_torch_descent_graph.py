"""The descents' CUDA graphs on the card.

* A polish, a leader pass and a swap polish whose iterations replay one
  captured CUDA graph give the same model, iterations, moves and move-kind
  counters as the same descent with every iteration run eagerly (a stand-in
  graph whose replay re-runs the captured closure), at the same seed.
* Every run captures its own graph and retires it, and the card's reserved
  memory after ten cold-proposal-like runs (a polish and a leader pass) is
  what it was after two.

This file imports only torch and ``ccx_torch``, so on a machine with a card
(where JAX is not installed) its tests run with
``python -m pytest --noconftest tests/test_torch_descent_graph.py -m gpu``.
"""

from __future__ import annotations

import pytest
import torch

from ccx_torch.common.tracing import TRACER
from ccx_torch.goals.base import GoalConfig
from ccx_torch.goals.stack import DEFAULT_GOAL_ORDER
from ccx_torch.model.fixtures import RandomClusterSpec, random_cluster
from ccx_torch.search import graphs, greedy

CFG = GoalConfig()
GOALS = DEFAULT_GOAL_ORDER
SPEC = RandomClusterSpec(n_brokers=64, n_racks=8, n_topics=16, n_partitions=2000,
                         n_dead_brokers=0, seed=11)
KINDS = ("polish", "leader-pass", "swap-polish")


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


class _Eager:
    """A stand-in graph: ``capture`` records the iteration's closure and
    ``replay`` runs it again, eagerly."""

    def __init__(self, dev, gen) -> None:
        self.fn = None

    def capture(self, fn) -> None:
        self.fn = fn

    def replay(self) -> None:
        self.fn()

    def release(self) -> None:
        self.fn = None


def _run(kind: str, m):
    """One descent of ``kind`` under a span: (result, graph counters)."""
    with TRACER.span(kind) as s:
        if kind == "swap-polish":
            res = greedy.swap_polish(m, CFG, GOALS, greedy.SwapPolishOptions(
                n_swap_candidates=32, n_lead_candidates=32, max_iters=12, patience=12,
                chunk_iters=5, seed=3))
        else:
            res = greedy.greedy_optimize(m, CFG, GOALS, greedy.GreedyOptions(
                n_candidates=128, max_iters=12, patience=12, chunk_iters=5, seed=3,
                leadership_only=kind == "leader-pass"))
    return res, (s.attrs["graphCaptures"], s.attrs["graphReplays"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_graphed_descent_equals_eager_on_card(kind, monkeypatch):
    m = random_cluster(SPEC, device=_card())
    got, (captures, replays) = _run(kind, m)
    # the host sees the stop late on a card: the inert calls replay too
    assert captures == 1 and replays >= got.n_iters - 1
    monkeypatch.setattr(greedy, "_iteration_graph", _Eager)
    ref, _ = _run(kind, m)
    assert ref.n_moves > 0
    for f in ("assignment", "leader_slot", "replica_disk"):
        assert torch.equal(getattr(got.model, f), getattr(ref.model, f)), f
    assert (got.n_iters, got.n_moves, got.n_prop_kind, got.n_acc_kind) == (
        ref.n_iters, ref.n_moves, ref.n_prop_kind, ref.n_acc_kind)


@pytest.mark.gpu
def test_descent_graphs_do_not_outlive_their_runs(monkeypatch):
    dev = _card()
    m = random_cluster(SPEC, device=dev)
    made = []

    def spy(d, gen):
        made.append(graphs.CudaStepGraph(d, gen))
        return made[-1]

    monkeypatch.setattr(greedy, "_iteration_graph", spy)
    reserved = []
    for _ in range(10):
        for kind in ("polish", "leader-pass"):
            assert _run(kind, m)[1][0] == 1
        torch.cuda.synchronize(dev)
        reserved.append(torch.cuda.memory_reserved(dev))
    assert len(made) == 20 and all(g.graph is None for g in made)
    assert reserved[-1] == reserved[1], reserved
