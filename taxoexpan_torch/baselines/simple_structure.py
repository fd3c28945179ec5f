#!/usr/bin/env python
"""Structure-aware distance baseline: score a candidate parent by the query's
distance to it plus an aggregate of the query's distances to its would-be
siblings.

Re-implementation of baselines/simple_structure.py:35-116 (a numpy copy of
`taxoexpan_tpu/baselines/simple_structure.py` on the port's own data
modules, since that one imports `taxoexpan_tpu.data`, which imports JAX).
The reference runs
a python loop over every (query, position) pair across a Pool(10); here the
whole thing is dense linear algebra: the query x candidate distance matrix is
one matmul, and per-position sibling aggregates are computed once over the
children CSR (sum/mean via a sparse indicator matmul; min/max via a single
pass over positions).

score(position) = parent_dist + beta * agg(sibling_dists), or the
(parent_dist + sum_sib) / (1 + n_sib) normalized form when beta == 0
(simple_structure.py:59-63).

    python -m taxoexpan_torch.baselines.simple_structure --data ... \
        --agg sum --beta 0.1
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.taxonomy import Taxonomy
from ..metrics import (combined_metrics, hit_at_1, hit_at_3, hit_at_5,
                       macro_mr, micro_mr, mrr_scaled_10, ranks_from_scores)


def evaluate(taxonomy: Taxonomy, agg: str = "sum", beta: float = 0.0) -> dict:
    if agg not in ("sum", "mean", "min", "max"):
        raise ValueError(f"unknown agg {agg!r}")
    feats = np.asarray(taxonomy.features, dtype=np.float32)
    unit = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                              1e-12)
    train_ids = np.asarray(taxonomy.train_node_ids)
    train_set = set(int(t) for t in train_ids)
    pos_of_train = {int(t): i for i, t in enumerate(train_ids)}
    test_ids = list(taxonomy.test_node_ids)
    children = taxonomy.children
    parents = taxonomy.parents

    dist = 1.0 - unit[np.asarray(test_ids)] @ unit[train_ids].T  # [Q, T]
    q_n, t_n = dist.shape

    # per-position sibling lists (children that are themselves candidates,
    # simple_structure.py:53)
    sib_cols: list[np.ndarray] = []
    for t in train_ids:
        sibs = [pos_of_train[int(c)] for c in children.neighbors(int(t))
                if int(c) in train_set]
        sib_cols.append(np.asarray(sibs, dtype=np.int64))
    n_sib = np.asarray([len(s) for s in sib_cols], dtype=np.float32)

    if agg in ("sum", "mean"):
        sib_agg = np.zeros_like(dist)
        for ti, cols in enumerate(sib_cols):
            if len(cols):
                s = dist[:, cols].sum(axis=1)
                sib_agg[:, ti] = s / len(cols) if agg == "mean" else s
    else:
        op = np.min if agg == "min" else np.max
        sib_agg = np.zeros_like(dist)
        for ti, cols in enumerate(sib_cols):
            if len(cols):
                sib_agg[:, ti] = op(dist[:, cols], axis=1)

    if beta == 0.0:
        scores = (dist + sib_agg) / (1.0 + n_sib)[None, :]
    else:
        scores = dist + beta * sib_agg

    all_ranks = []
    for qi, q in enumerate(test_ids):
        pos_idx = [pos_of_train[p] for p in parents.neighbors(q).tolist()
                   if int(p) in pos_of_train]
        if not pos_idx:
            continue
        all_ranks.append(ranks_from_scores(scores[qi], pos_idx, mode=0))
    return {
        "num_queries": len(all_ranks),
        "num_candidates": int(t_n),
        "agg": agg, "beta": beta,
        "macro_mr": macro_mr(all_ranks),
        "micro_mr": micro_mr(all_ranks),
        "hit_at_1": hit_at_1(all_ranks),
        "hit_at_3": hit_at_3(all_ranks),
        "hit_at_5": hit_at_5(all_ranks),
        "mrr_scaled_10": mrr_scaled_10(all_ranks),
        "combined_metrics": combined_metrics(all_ranks),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--agg", default="sum",
                   choices=["sum", "mean", "min", "max"])
    p.add_argument("--beta", type=float, default=0.0,
                   help="sibling weight; 0 = normalized mean form")
    args = p.parse_args(argv)
    result = evaluate(Taxonomy.load(args.data), agg=args.agg, beta=args.beta)
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
