"""What surrounds the broker-aggregates kernel, on the CPU: the topic index
the kernel walks, its cache, and the carve of the one output buffer into the
eight fields.

This file imports only torch, numpy and ``ccx_torch``, so on a machine with a
card (where JAX is not installed) it also runs with
``python -m pytest --noconftest tests/test_torch_kernel_layout.py``.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from ccx_torch.model import fixtures
from ccx_torch.model.tensor_model import model_arrays, model_from_arrays
from ccx_torch.ops import broker_aggregates as agg_op

SPEC = fixtures.RandomClusterSpec(n_brokers=12, n_racks=3, n_topics=9, n_partitions=300, seed=2)
#: topic 4 loses its partitions to topic 5; these partitions become padding
EMPTY_TOPIC, DEAD_PARTITIONS = 4, (3, 70, 150)


def _unsorted_model():
    """A small cluster with its partitions (padding included) in random
    order, one empty topic and three more padding partitions."""
    m = fixtures.shuffled_partitions(fixtures.random_cluster(SPEC, device="cpu"), seed=1)
    arrays = model_arrays(m)
    arrays["partition_topic"][arrays["partition_topic"] == EMPTY_TOPIC] = EMPTY_TOPIC + 1
    arrays["partition_valid"][list(DEAD_PARTITIONS)] = False
    return model_from_arrays(arrays, m.num_topics, m.num_racks, "cpu")


def _expected_groups(topic: np.ndarray, valid: np.ndarray, T: int) -> list[np.ndarray]:
    """Live partitions of each topic in ascending order, then those whose
    topic is out of range."""
    live = np.flatnonzero(valid)
    groups = [live[topic[live] == t] for t in range(T)]
    return groups + [live[(topic[live] < 0) | (topic[live] >= T)]]


def _index_groups(index: agg_op.TopicIndex) -> list[np.ndarray]:
    order, offsets = index.order.numpy(), index.offsets.numpy()
    bounds = list(offsets) + [len(order)]
    return [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def test_index_groups_every_live_partition_once_under_its_topic():
    m = _unsorted_model()
    topic, valid = m.partition_topic.numpy(), m.partition_valid.numpy()
    assert not np.all(np.diff(topic[valid]) >= 0), "the fixture must be unsorted"
    index = agg_op.topic_index(m)
    assert index.order.dtype == torch.int32 and index.offsets.dtype == torch.int32
    assert index.offsets.shape == (m.num_topics + 1,)
    got = _index_groups(index)
    for t, (g, want) in enumerate(zip(got, _expected_groups(topic, valid, m.num_topics))):
        np.testing.assert_array_equal(g, want, err_msg=f"topic {t}")
    assert len(got[EMPTY_TOPIC]) == 0
    order = index.order.numpy()
    assert sorted(order) == sorted(np.flatnonzero(valid))
    assert not set(order) & set(np.flatnonzero(~valid)), "a padding partition is in the index"


@pytest.mark.parametrize("bad_topic", [-1, "T"])
def test_index_puts_out_of_range_topics_after_the_last_topic(bad_topic):
    m = _unsorted_model()
    T = m.num_topics
    live = np.flatnonzero(m.partition_valid.numpy())[:5]
    topic = m.partition_topic.clone()
    topic[torch.from_numpy(live)] = T if bad_topic == "T" else -1
    index = agg_op.build_topic_index(topic, m.partition_valid, T)
    got = _index_groups(index)
    want = _expected_groups(topic.numpy(), m.partition_valid.numpy(), T)
    np.testing.assert_array_equal(got[-1], live)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_index_of_a_model_without_live_partitions_is_empty():
    m = _unsorted_model()
    index = agg_op.build_topic_index(m.partition_topic, torch.zeros_like(m.partition_valid),
                                     m.num_topics)
    assert index.order.numel() == 0
    assert not index.offsets.any()


def test_cache_reuses_the_index_of_the_same_tensors():
    m = _unsorted_model()
    first = agg_op.topic_index(m)
    assert agg_op.topic_index(m) is first
    # a search step's model shares the partition tensors
    moved = m.replace(assignment=m.assignment.roll(1, dims=1))
    assert agg_op.topic_index(moved) is first


@pytest.mark.parametrize("change", ["new-topic-tensor", "new-valid-tensor", "topic-in-place",
                                    "valid-in-place", "num-topics"])
def test_cache_rebuilds_for_other_or_changed_tensors(change):
    m = _unsorted_model()
    stale = agg_op.topic_index(m)
    live = int(np.flatnonzero(m.partition_valid.numpy())[0])
    if change == "new-topic-tensor":
        topic = m.partition_topic.clone()
        topic[live] = (int(topic[live]) + 1) % SPEC.n_topics
        m = m.replace(partition_topic=topic)
    elif change == "new-valid-tensor":
        valid = m.partition_valid.clone()
        valid[live] = False
        m = m.replace(partition_valid=valid)
    elif change == "topic-in-place":
        m.partition_topic[live] = (int(m.partition_topic[live]) + 1) % SPEC.n_topics
    elif change == "valid-in-place":
        m.partition_valid[live] = False
    else:
        m = m.replace(num_topics=m.num_topics * 2)
    index = agg_op.topic_index(m)
    assert index is not stale
    want = _expected_groups(m.partition_topic.numpy(), m.partition_valid.numpy(), m.num_topics)
    for g, w in zip(_index_groups(index), want):
        np.testing.assert_array_equal(g, w)


def test_cache_drops_the_index_with_its_tensors():
    m = _unsorted_model()
    agg_op.topic_index(m)
    key = (id(m.partition_topic), id(m.partition_valid))
    assert key in agg_op._TOPIC_INDEX
    del m
    gc.collect()
    assert key not in agg_op._TOPIC_INDEX


#: (B, T, D) of B5, B4 (JBOD) and the 4000-broker fixture after padding
SHAPES = {"B5": (1024, 512, 1), "B4": (16, 16, 4), "4000-brokers": (4096, 64, 1)}
FIELD_SHAPES = {
    "topic_replica_count": lambda B, T, D: ((T, B), torch.int32),
    "topic_leader_count": lambda B, T, D: ((T, B), torch.int32),
    "broker_load": lambda B, T, D: ((4, B), torch.float32),
    "replica_count": lambda B, T, D: ((B,), torch.int32),
    "leader_count": lambda B, T, D: ((B,), torch.int32),
    "potential_nw_out": lambda B, T, D: ((B,), torch.float32),
    "leader_bytes_in": lambda B, T, D: ((B,), torch.float32),
    "disk_load": lambda B, T, D: ((B, D), torch.float32),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_carve_gives_eight_fields_of_the_right_shape_and_place(name):
    B, T, D = SHAPES[name]
    layout, words = agg_op.output_layout(B, T, D)
    assert words == 2 * T * B + 8 * B + B * D
    buf = torch.arange(words, dtype=torch.int32)
    agg = agg_op.carve(buf, B, T, D)
    at = 0
    for field, offset, shape, dtype in layout:
        want_shape, want_dtype = FIELD_SHAPES[field](B, T, D)
        t = getattr(agg, field)
        assert (tuple(t.shape), t.dtype) == (want_shape, want_dtype), field
        assert (offset, shape, dtype) == (at, want_shape, want_dtype), field
        assert t.is_contiguous() and t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        assert t.storage_offset() == offset, field
        # the field's words are the buffer's words at its offset
        n = int(np.prod(want_shape))
        assert torch.equal(t.reshape(-1).view(torch.int32), buf[offset:offset + n]), field
        at += n
    assert at == words
    # the topic matrices first (written whole), then the 8 * B + B * D words
    # the kernel zeroes and adds into
    assert [f for f, *_ in layout[:2]] == ["topic_replica_count", "topic_leader_count"]
    assert layout[2][1] == 2 * T * B
