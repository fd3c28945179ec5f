"""The frozen copies in `benchmark/frozen/`, pinned to golden values, so
that neither they nor (through the equality tests) their sources move
unseen."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.frozen import dropout_hash as dh
from benchmark.frozen import roofline, synthetic

# (seed, stream, row, col) -> bits, the values `ops/dropout.py` pins
GOLDEN_BITS = (
    ((0, 0, 0, 0), 894628709),
    ((1, 0, 0, 0), 1957787082),
    ((0, 1, 0, 0), 351695598),
    ((0, 0, 1, 0), 3406888775),
    ((0, 0, 0, 1), 2122888683),
    ((123456789, 7, 262143, 249), 2899358386),
    ((2 ** 31 - 1, 12, 4095, 49), 1640409158),
    ((42, 0, 2 ** 32 - 1, 2 ** 32 - 1), 2423138199),
)


@pytest.mark.parametrize("key,bits", GOLDEN_BITS)
def test_hash_golden_bits(key, bits):
    assert dh.bits_int(*key) == bits
    seed, stream, row, col = key
    if row < 2 ** 31 and col < 2 ** 31:
        got = dh.bits(seed, stream, torch.tensor([row]), torch.tensor([col]))
        assert int(got[0]) == bits


def test_hash_masks_match_the_program():
    from taxoexpan_torch.ops import dropout
    ours = dh.slot_mask(77, dh.STREAM_FEAT, 5, 7, 33, 0.1, "cpu")
    theirs = dropout.slot_mask(77, dropout.STREAM_FEAT, 5, 7, 33, 0.1,
                               "cpu")
    assert torch.equal(ours, theirs)
    att = dropout.attention_masks(9, 6, 2, 4, 3, 0.1, "cpu")
    for kind, width in enumerate((2, 1, 4, 4, 2)):
        for h in range(3):
            assert torch.equal(dh.attention_mask(9, h, kind, 6, width, 0.1,
                                                 "cpu"), att[kind][..., h])


def test_layer_seeds_match_the_trainer():
    from taxoexpan_torch.models.propagation import _layer_seed
    from taxoexpan_torch.training.trainer import step_generator
    gen = step_generator(2 ** 31 - 5, 1_000_003 * 2 + 17)
    theirs = [_layer_seed(gen, True) for _ in range(3)]
    assert dh.layer_seeds(2 ** 31 - 5, 1_000_003 * 2 + 17, 3) == theirs


def test_generator_golden():
    tax = synthetic.synthetic_taxonomy_v2(num_nodes=300, dim=8,
                                          max_children=6, noise=1.0, seed=3)
    assert tax.edges.shape == (299, 2)
    assert int(tax.edges.sum()) == 66925
    assert (len(tax.train_node_ids), len(tax.validation_node_ids),
            len(tax.test_node_ids)) == (272, 14, 14)
    assert tax.test_node_ids[:3] == [275, 152, 222]
    assert float(np.abs(tax.features).sum()) == pytest.approx(
        1101.6069, abs=1e-3)


def test_generator_matches_the_program():
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy_v2
    ours = synthetic.synthetic_taxonomy_v2(num_nodes=500, dim=16, seed=11,
                                           max_children=7)
    theirs = synthetic_taxonomy_v2(num_nodes=500, dim=16, seed=11,
                                   max_children=7)
    assert np.array_equal(ours.features, theirs.features)
    assert np.array_equal(ours.edges, theirs.edges)
    assert ours.test_node_ids == theirs.test_node_ids
    assert ours.train_node_ids == theirs.train_node_ids


def test_bound_golden():
    b = roofline.bound(3.35e9, 165e9, tensor_cores=True)
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "bytes"
    b = roofline.bound(1e6, 495e12 / 3 * 2e-3, tensor_cores=True)
    assert b["bound_ms"] == pytest.approx(2.0)
    assert b["bound_by"] == "operations"
    assert b["bound_fma_ms"] == pytest.approx(495e12 / 3 * 2 / 67e12)
    assert roofline.bound(0, 67e9)["bound_ms"] == pytest.approx(1.0)


def test_trace_split_golden():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60, "dur": 10}]
    s = roofline.trace_split(ev)
    assert s["wall_ms"] == pytest.approx(0.1)
    assert s["device_busy_ms"] == pytest.approx(0.04)
    assert s["device_idle_share"] == pytest.approx(0.6)
    assert s["kernel_launches"] == 3
    assert s["top_device_ops"][0] == {"name": "k1", "calls": 2,
                                      "ms": pytest.approx(0.03)}
    assert roofline.trace_split(ev[:1]) is None
