"""The benchmark's taxonomy generator: a frozen copy of
`synthetic_taxonomy_v2` from `taxoexpan_torch/data/synthetic.py` at commit
c6a9a8c, so that no later change of the program moves the yardstick.

It returns plain numpy arrays (`SyntheticTaxonomy`) instead of the
program's `Taxonomy`; the harness builds the program's object from them
and the plain reference reads them directly. The random stream, the
topology, the features and the split are the source's, call for call
(`tests/test_bench_frozen.py` pins them to golden values).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticTaxonomy:
    features: np.ndarray          # [V, dim] float32, not normalised
    edges: np.ndarray             # [E, 2] int32 (parent, child)
    train_node_ids: list
    validation_node_ids: list
    test_node_ids: list

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]


def synthetic_taxonomy_v2(num_nodes: int = 2000,
                          dim: int = 64,
                          max_children: int = 10,
                          w_parent: float = 1.0,
                          w_gp: float = 0.6,
                          w_own: float = 0.5,
                          noise: float = 0.5,
                          dag_extra_parent_prob: float = 0.0,
                          holdout_frac: float = 0.1,
                          seed: int = 0) -> SyntheticTaxonomy:
    """Random bushy rooted tree whose node features are rotated copies of
    the parent's, grandparent's and own latent cores plus noise; held-out
    validation and test leaves only under parents that keep >= 2 other
    children (see the source's docstring)."""
    rng = np.random.default_rng(seed)

    parent = np.zeros(num_nodes, dtype=np.int64)
    edges: list[tuple[int, int]] = []
    child_count = np.zeros(num_nodes, dtype=np.int64)
    for v in range(1, num_nodes):
        for _ in range(10):
            p = int(rng.integers(0, v))
            if child_count[p] < max_children:
                break
        parent[v] = p
        edges.append((p, v))
        child_count[p] += 1
        if v > 2 and rng.random() < dag_extra_parent_prob:
            p2 = int(rng.integers(0, v))
            if p2 != p and child_count[p2] < max_children:
                edges.append((p2, v))
                child_count[p2] += 1
    gparent = parent[parent]

    cores = rng.normal(size=(num_nodes, dim)).astype(np.float32)
    cores /= np.maximum(np.linalg.norm(cores, axis=1, keepdims=True), 1e-12)

    def _orthogonal() -> np.ndarray:
        q, r = np.linalg.qr(rng.normal(size=(dim, dim)))
        return (q * np.sign(np.diag(r))).astype(np.float32)

    r_p, r_g, r_o = _orthogonal(), _orthogonal(), _orthogonal()
    features = (w_parent * cores[parent] @ r_p.T
                + w_gp * cores[gparent] @ r_g.T
                + w_own * cores @ r_o.T
                + noise * rng.normal(size=(num_nodes, dim)) / np.sqrt(dim)
                ).astype(np.float32)

    edges_arr = np.asarray(edges, dtype=np.int32)

    out_deg = np.bincount(edges_arr[:, 0], minlength=num_nodes)
    leaves = np.flatnonzero(out_deg == 0)
    rng.shuffle(leaves)
    n_hold = max(2, int(len(leaves) * holdout_frac) * 2)
    remaining = child_count.copy()
    held: list[int] = []
    for leaf in leaves:
        if len(held) >= n_hold:
            break
        p = parent[leaf]
        if remaining[p] >= 3:
            held.append(int(leaf))
            remaining[p] -= 1
    val_ids = held[:len(held) // 2]
    test_ids = held[len(held) // 2:]
    held_set = set(held)
    train_ids = [i for i in range(num_nodes) if i not in held_set]

    return SyntheticTaxonomy(features=features, edges=edges_arr,
                             train_node_ids=train_ids,
                             validation_node_ids=val_ids,
                             test_node_ids=test_ids)
