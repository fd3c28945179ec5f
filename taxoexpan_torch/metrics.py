"""Ranking metrics: mean rank, Hit@k, scaled MRR.

Re-implements model/metric.py. The reference reconstructs query groups from
flat label arrays with a byte-regex scan (metric.py:48-53); our batches carry
the [G, C] group structure explicitly, so rank extraction is one vectorized
comparison. Metric functions keep the reference's names and list-of-lists
`all_ranks` interface so configs ("metrics": [...]) and logs line up 1:1.

Rank semantics (metric.py:7-31): the rank of each positive is
1 + (number of NEGATIVES strictly better than it); other positives are
excluded from the comparison (masked array), and ties favor the positive.
mode=0 ranks by distance/energy (smaller better), mode=1 by similarity
(larger better) — chosen by loss type (train.py:29-32).

Port copy of `taxoexpan_tpu/metrics.py` (numpy only).
"""
from __future__ import annotations

import itertools

import numpy as np


def ranks_from_groups(scores: np.ndarray, labels: np.ndarray,
                      cand_mask: np.ndarray, mode: int = 1) -> list[list[int]]:
    """[G, C] arrays -> per-valid-group list of positive ranks.

    Groups whose cand_mask is all-False (batch padding) are skipped.
    """
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    cand_mask = np.asarray(cand_mask, dtype=bool)
    pos_mask = cand_mask & (labels == 1)
    neg_mask = cand_mask & (labels == 0)

    # better[g, i, j] = negative j beats positive i
    if mode == 1:
        better = scores[:, None, :] > scores[:, :, None]
    else:
        better = scores[:, None, :] < scores[:, :, None]
    better = better & neg_mask[:, None, :]
    rank_mat = 1 + better.sum(axis=2)                      # [G, C]

    all_ranks: list[list[int]] = []
    for g in range(scores.shape[0]):
        if not cand_mask[g].any():
            continue
        all_ranks.append([int(r) for r in rank_mat[g][pos_mask[g]]])
    return all_ranks


def ranks_from_scores(all_scores: np.ndarray, positive_idx,
                      mode: int = 1, neg_mask=None) -> list[int]:
    """Rank positives among a flat candidate score vector
    (calculate_ranks_from_{similarities,distance}, metric.py:7-31).

    `neg_mask` (bool [C], optional): which entries count as negatives. The
    evaluation engine passes the complement of the query's node2masks set
    (descendants ∪ parents ∪ self ∪ roots are never negatives,
    dataset.py:247-259,319-320), optionally shrunk to the test_topk
    retrieval pool (dataset.py:321-325). Default: everything but the
    positives, as before."""
    all_scores = np.asarray(all_scores).reshape(-1)
    positive_idx = np.asarray(positive_idx, dtype=np.int64)
    if neg_mask is None:
        neg_mask = np.ones(all_scores.shape[0], dtype=bool)
    else:
        neg_mask = np.asarray(neg_mask, dtype=bool).copy()
    neg_mask[positive_idx] = False
    pos_scores = all_scores[positive_idx]
    if mode == 1:
        better = all_scores[None, :] > pos_scores[:, None]
    else:
        better = all_scores[None, :] < pos_scores[:, None]
    return list((better & neg_mask[None, :]).sum(axis=1) + 1)


# ----------------------------------------------------------- metric functions

def macro_mr(all_ranks) -> float:
    """Mean over queries of each query's mean positive rank (metric.py:62-64)."""
    return float(np.mean([np.mean(r) for r in all_ranks]))


def micro_mr(all_ranks) -> float:
    return float(np.mean(list(itertools.chain(*all_ranks))))


def _hit_at(all_ranks, k: int) -> float:
    ranks = np.asarray(list(itertools.chain(*all_ranks)))
    return float(np.sum(ranks <= k) / len(ranks))


def hit_at_1(all_ranks) -> float:
    return _hit_at(all_ranks, 1)


def hit_at_3(all_ranks) -> float:
    return _hit_at(all_ranks, 3)


def hit_at_5(all_ranks) -> float:
    return _hit_at(all_ranks, 5)


def mrr_scaled_10(all_ranks) -> float:
    """mean(1 / ceil(rank / 10)) — PinSAGE-style scaled MRR (metric.py:85-90)."""
    ranks = np.asarray(list(itertools.chain(*all_ranks)), dtype=np.float64)
    return float((1.0 / np.ceil(ranks / 10)).mean())


def combined_metrics(all_ranks) -> float:
    """Early-stop composite (metric.py:92-97)."""
    return (macro_mr(all_ranks)
            * (1.0 / max(mrr_scaled_10(all_ranks), 1e-4))
            * (1.0 / max(hit_at_3(all_ranks), 1e-4))
            * (1.0 / max(hit_at_1(all_ranks), 1e-4)))


METRICS = {
    "macro_mr": macro_mr,
    "micro_mr": micro_mr,
    "hit_at_1": hit_at_1,
    "hit_at_3": hit_at_3,
    "hit_at_5": hit_at_5,
    "mrr_scaled_10": mrr_scaled_10,
    "combined_metrics": combined_metrics,
}


def get_metric(name: str):
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; available: {list(METRICS)}")
    return METRICS[name]
