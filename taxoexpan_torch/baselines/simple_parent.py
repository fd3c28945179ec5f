#!/usr/bin/env python
"""Closest-parent baseline: rank candidate parents purely by cosine distance
between query and candidate embeddings (a numpy copy of
`taxoexpan_tpu/baselines/simple_parent.py` on the port's own data modules,
since that one imports `taxoexpan_tpu.data`, which imports JAX).

The query x candidate distances are one matmul a chunk of QUERY_CHUNK
queries, so the host holds [QUERY_CHUNK, C] of them at a time (the whole
matrix at MAG-Full scale, 17,777 x 319,446 float32, is 22.7 GB); each row
is the same dot products as in the one-matmul form, so the ranks are too.

    python -m taxoexpan_torch.baselines.simple_parent --data data/synth.pickle.bin
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.taxonomy import Taxonomy
from ..metrics import (combined_metrics, hit_at_1, hit_at_3, hit_at_5,
                       macro_mr, micro_mr, mrr_scaled_10, ranks_from_scores)


QUERY_CHUNK = 1024


def evaluate(taxonomy: Taxonomy) -> dict:
    feats = np.asarray(taxonomy.features, dtype=np.float32)
    unit = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                              1e-12)
    train_ids = np.asarray(taxonomy.train_node_ids)
    test_ids = list(taxonomy.test_node_ids)
    parents = taxonomy.parents

    cand = unit[train_ids].T
    pos_of_train = {int(t): i for i, t in enumerate(train_ids)}
    all_ranks = []
    for start in range(0, len(test_ids), QUERY_CHUNK):
        chunk = test_ids[start:start + QUERY_CHUNK]
        # cosine distances of this chunk's queries to every candidate
        dist = 1.0 - unit[np.asarray(chunk)] @ cand
        for qi, q in enumerate(chunk):
            pos_idx = [pos_of_train[p] for p in parents.neighbors(q).tolist()
                       if int(p) in pos_of_train]
            if not pos_idx:
                continue
            all_ranks.append(ranks_from_scores(dist[qi], pos_idx, mode=0))
    return {
        "num_queries": len(all_ranks),
        "num_candidates": len(train_ids),
        "macro_mr": macro_mr(all_ranks),
        "micro_mr": micro_mr(all_ranks),
        "hit_at_1": hit_at_1(all_ranks),
        "hit_at_3": hit_at_3(all_ranks),
        "hit_at_5": hit_at_5(all_ranks),
        "mrr_scaled_10": mrr_scaled_10(all_ranks),
        "combined_metrics": combined_metrics(all_ranks),
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="dataset pickle path")
    args = p.parse_args()
    result = evaluate(Taxonomy.load(args.data))
    for k, v in result.items():
        print(f"{k}: {v}")
