"""The yardstick's operation and byte counts on shapes worked by hand."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import work


def _arch(kind, pos=2):
    return {"args": {"propagation_method": kind, "in_dim": 3,
                     "hidden_dim": 4, "out_dim": 5, "pos_dim": pos,
                     "num_layers": 1, "heads": [2, 1]}}


def test_rows_edges():
    r, e, b = work.rows_edges([1, 0, 1], [2, 0, 5], mask=[1, 1, 0])
    assert (r, e, b) == (1 + 1 + 2 + 0 + 1 + 0, 1 + 2 + 0, 2)


def test_gat_forward_by_hand():
    # layer 0: din 3, pos 2 (K 5), 2 heads x 4 (width 8); final: din 8,
    # pos 2 (K 10), 1 head x 5. R = 10, E = 4, B = 3, N = 6.
    r, e, b, n = 10.0, 4.0, 3, 6
    ops, nbytes = work.propagation(_arch("PGAT"), r, e, b, n=n,
                                   backward=False)
    l0 = 2 * r * 3 * 8 + 2 * r * 2 * 8 + 4 * r * 8 + 2 * (r + e) * 8
    l1 = 2 * r * 8 * 5 + 2 * r * 2 * 5 + 4 * r * 5 + 2 * (r + e) * 5
    assert ops == l0 + l1
    b0 = (r * 3 + n * 2 + 2 * b) * 4 + 5 * (8 + 4) * 4 + r * 8 * 4
    b1 = (r * 8 + n * 2 + 2 * b) * 4 + 10 * (5 + 2) * 4 + b * 3 * 5 * 4
    assert nbytes == b0 + b1
    # without dropout the pe product is taken once a slot
    ops_eval, _ = work.propagation(_arch("PGAT"), r, e, b, n=n,
                                   backward=False, train=False)
    assert ops - ops_eval == 2 * (r - n) * 2 * 8 + 2 * (r - n) * 2 * 5


def test_gat_backward_by_hand():
    r, e, b, n = 10.0, 4.0, 3, 6
    ops, _ = work.propagation(_arch("PGAT"), r, e, b, n=n, backward=True)
    l0 = 2 * r * 5 * 8 + 2 * (4 * r * 8 + 2 * (r + e) * 8)
    l1 = 2 * r * 10 * 5 + 2 * r * 8 * 5 + 2 * (4 * r * 5 + 2 * (r + e) * 5)
    assert ops == l0 + l1


def test_gcn_forward_by_hand():
    r, e, b, n = 10.0, 4.0, 3, 6
    ops, _ = work.propagation(_arch("PGCN"), r, e, b, n=n, backward=False)
    l0 = 2 * r * 5 * 4 + 2 * (r + e) * 4 + 2 * r * 4
    l1 = 2 * r * 6 * 5 + 2 * (r + e) * 5 + 2 * r * 5
    assert ops == l0 + l1


def test_match_and_mfu():
    arch = _arch("PGAT")
    assert work.match_ops(arch, 7, 11, 2) == 2 * 2 * 7 * 5 * 3 + \
        2 * 11 * 7 * 3
    assert work.mfu_pct(495e12 / 3, 1.0) == pytest.approx(100.0)
    assert work.mfu_pct(0, 1.0) is None


def test_bound_is_the_larger_time():
    arch = _arch("PGAT")
    ms = work.propagation_bound_ms(arch, 1e6, 5e5, 1e5, n=52,
                                   backward=False)
    ops, nbytes = work.propagation(arch, 1e6, 5e5, 1e5, n=52,
                                   backward=False)
    assert ms == pytest.approx(max(ops / (495e12 / 3), nbytes / 3.35e12)
                               * 1e3)
    assert np.isfinite(ms)
