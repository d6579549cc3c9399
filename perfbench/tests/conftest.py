"""Shared helpers of the benchmark's CPU tests: a cell cut to B1's size (10
brokers, 1000 partitions) and a search
budget the CPU runs in seconds; the goal stack and every code path stay."""

from __future__ import annotations

import pytest

from perfbench import harness

#: the sizes and the search budget of a test-sized cell
TINY_SPEC = {"n_brokers": 10, "n_racks": 3, "n_topics": 10, "n_partitions": 1000, "seed": 1}
TINY_OPTIONS = {"chains": 4, "steps": 10, "chunk_steps": 5, "polish_max_iters": 6,
                "polish_chunk_iters": 3, "leader_pass_max_iters": 3, "polish_candidates": 32}
TINY_WARM = {"warm_swap_iters": 2, "warm_swap_candidates": 8}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell.load(name)
    spec = {**cell.config["spec"], **TINY_SPEC}
    cell.config = {**cell.config, "spec": spec}
    t = dict(cell.traffic)
    for key in ("options", "cold_options"):
        if key in t:
            t[key] = {**t[key], **TINY_OPTIONS}
    if "warm_options" in t:
        t["warm_options"] = {**t["warm_options"], **TINY_WARM}
    cell.traffic = t
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
