#!/usr/bin/env python
"""Hand-crafted feature extractor + gradient-boosting baseline.

Re-implements baselines/XGBoost/feature_extractor.py (a numpy copy of
`taxoexpan_tpu/baselines/xgb_features.py` on the port's own data modules,
since that one imports `taxoexpan_tpu.data`, which imports JAX): the
NegativeQueue
(:11-40) and the 39-dimensional feature vector for a <query, candidate-parent>
pair (:57-155) built from cosine-distance statistics of the candidate's local
subgraph (parent itself, grandparents, siblings): count/min/max/median/mean/
std/ptp/relative-rank blocks plus global stats. The training/prediction
pipeline (self_supervision_generation.py, model_training.py,
model_prediction.py) is reproduced by `train_booster` / `evaluate`, gated on
xgboost availability (not in this image -> raises a clear error; feature
extraction itself is dependency-free).

    python -m taxoexpan_torch.baselines.xgb_features --data ... [--train]
"""
from __future__ import annotations

import argparse
import random

import numpy as np

from ..data.taxonomy import Taxonomy
from ..metrics import (hit_at_1, hit_at_3, hit_at_5, macro_mr, micro_mr,
                       mrr_scaled_10, ranks_from_scores)

NUM_FEATURES = 39
_SENTINEL = [0, -999, -999, -999, -999, -999, -999, -999]


class NegativeQueue:
    """Shuffled queue with walking pointer (feature_extractor.py:11-40)."""

    def __init__(self, queue: list[int], seed: int = 0):
        self.pointer = 0
        self.queue = list(queue)
        self.rng = random.Random(seed)
        self.rng.shuffle(self.queue)

    def sample(self, query: int, negative_size: int) -> list[int]:
        if self.pointer == 0:
            self.rng.shuffle(self.queue)
        negatives = [x for x in self.queue[self.pointer:
                                           self.pointer + negative_size]
                     if x != query]
        self.pointer += negative_size
        if self.pointer >= len(self.queue):
            self.pointer = 0
        return negatives

    def sample_avoid_positive_set(self, positive_set, negative_size):
        if self.pointer == 0:
            self.rng.shuffle(self.queue)
        negatives = [x for x in self.queue[self.pointer:
                                           self.pointer + negative_size]
                     if x not in positive_set]
        self.pointer += negative_size
        if self.pointer >= len(self.queue):
            self.pointer = 0
        return negatives


def _stats_block(d: np.ndarray, parent_distance: float) -> list[float]:
    if len(d) == 0:
        return list(_SENTINEL)
    return [len(d), float(np.min(d)), float(np.max(d)), float(np.median(d)),
            float(np.mean(d)), float(np.std(d)),
            float(np.max(d) - np.min(d)),
            float((d < parent_distance).sum() / len(d))]


def _stats_block_batch(vals: np.ndarray, valid: np.ndarray,
                       pdist: np.ndarray) -> np.ndarray:
    """_stats_block over the candidate axis: vals/valid [C, M], pdist [C]
    -> [C, 8] (sentinel rows where a candidate has no valid entries)."""
    import warnings
    cnt = valid.sum(axis=1)
    x = np.where(valid, vals, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # all-NaN rows -> sentinel below
        mn = np.nanmin(x, axis=1)
        mx = np.nanmax(x, axis=1)
        med = np.nanmedian(x, axis=1)
        mean = np.nanmean(x, axis=1)
        std = np.nanstd(x, axis=1)
    below = np.where(valid, vals < pdist[:, None], False).sum(axis=1)
    frac = below / np.maximum(cnt, 1)
    block = np.stack([cnt.astype(np.float64), mn, mx, med, mean, std,
                      mx - mn, frac], axis=1)
    return np.where((cnt == 0)[:, None],
                    np.asarray(_SENTINEL, np.float64), block)


def _pad_csr(csr, num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> padded [V, M] neighbor-id matrix + validity mask."""
    deg = np.diff(csr.indptr)
    m = max(int(deg.max()) if len(deg) else 0, 1)
    cols = np.arange(m, dtype=np.int64)[None, :]
    valid = cols < deg[:, None]
    if len(csr.indices) == 0:
        return np.zeros((num_nodes, m), np.int64), valid
    idx = np.minimum(csr.indptr[:-1, None] + cols, len(csr.indices) - 1)
    return np.where(valid, csr.indices[idx], 0).astype(np.int64), valid


class FeatureExtractor:
    """39 features from distance statistics (feature_extractor.py:57-155)."""

    def __init__(self, taxonomy: Taxonomy, restrict_to_train: bool = True):
        self.taxo = taxonomy
        feats = np.asarray(taxonomy.features, np.float32)
        self.unit = feats / np.maximum(
            np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
        self.children = taxonomy.children
        self.parents = taxonomy.parents

    def _dist(self, a: int, nodes: np.ndarray) -> np.ndarray:
        return 1.0 - self.unit[nodes] @ self.unit[a]

    def extract_features(self, query_node: int, parent_node: int
                         ) -> list[float]:
        gps = self.parents.neighbors(parent_node)
        sibs = np.asarray([c for c in self.children.neighbors(parent_node)
                           if c != query_node], dtype=np.int32)
        neighbor = np.concatenate([[parent_node], gps, sibs]).astype(np.int64)
        d = self._dist(query_node, neighbor)       # query -> local subgraph
        pd = self._dist(parent_node, neighbor)     # parent -> local subgraph
        ngp = len(gps)
        parent_distance = float(d[0])

        feat = [parent_distance]
        feat += _stats_block(d[1:1 + ngp], parent_distance)     # 2-9 gp
        feat += _stats_block(d[1 + ngp:], parent_distance)      # 10-17 sib
        feat += _stats_block(pd[1:1 + ngp], parent_distance)    # 18-25 p-gp
        feat += _stats_block(pd[1 + ngp:], parent_distance)     # 26-33 p-sib
        feat += [float(np.min(d)), float(np.max(d)), float(np.median(d)),
                 float(np.mean(d)), float(np.std(d)),
                 float(np.max(d) - np.min(d))]                  # 34-39 global
        assert len(feat) == NUM_FEATURES
        return feat

    # ------------------------------------------------- batched fast path
    def _ensure_padded(self) -> None:
        """One-time padded adjacency + parent-side distance tables.

        The candidate-side distance statistics (features 18-33 minus their
        relative-rank entries) are QUERY-INDEPENDENT, so the per-edge
        cosine distances are computed once for the whole taxonomy and laid
        out as padded [V, deg_max] rows — the batched extractor then only
        computes one query->all-nodes distance vector per query. This is
        the intent of the reference's cached fast path
        (baselines/XGBoost/feature_extractor.py:157-261,
        model_prediction.py:33-136), which exists because per-pair Python
        extraction is unusable at ranking time."""
        if getattr(self, "_gp_ids", None) is not None:
            return
        v = len(self.unit)
        self._gp_ids, self._gp_valid = _pad_csr(self.parents, v)
        self._ch_ids, self._ch_valid = _pad_csr(self.children, v)
        rows_p = np.repeat(np.arange(v, dtype=np.int64),
                           np.diff(self.parents.indptr))
        self._gp_pd = np.zeros(self._gp_ids.shape, np.float64)
        self._gp_pd[self._gp_valid] = \
            1.0 - np.einsum("ed,ed->e", self.unit[self.parents.indices],
                            self.unit[rows_p])
        rows_c = np.repeat(np.arange(v, dtype=np.int64),
                           np.diff(self.children.indptr))
        self._ch_pd = np.zeros(self._ch_ids.shape, np.float64)
        self._ch_pd[self._ch_valid] = \
            1.0 - np.einsum("ed,ed->e", self.unit[self.children.indices],
                            self.unit[rows_c])

    def extract_features_batch(self, query_node: int, cands) -> np.ndarray:
        """Vectorized extract_features for one query against many candidate
        parents -> [C, 39] float32. Memory scales with C * max-degree."""
        self._ensure_padded()
        c = np.asarray(cands, dtype=np.int64)
        dq = 1.0 - self.unit @ self.unit[int(query_node)]        # [V]
        pdist = dq[c].astype(np.float64)                         # feature 1

        gp_valid = self._gp_valid[c]
        gp_d = np.where(gp_valid, dq[self._gp_ids[c]], np.nan)
        sib_valid = self._ch_valid[c] & (self._ch_ids[c] != int(query_node))
        sib_d = np.where(sib_valid, dq[self._ch_ids[c]], np.nan)

        blocks = [
            pdist[:, None],
            _stats_block_batch(gp_d, gp_valid, pdist),           # 2-9
            _stats_block_batch(sib_d, sib_valid, pdist),         # 10-17
            _stats_block_batch(self._gp_pd[c], gp_valid, pdist),  # 18-25
            _stats_block_batch(self._ch_pd[c], sib_valid, pdist),  # 26-33
        ]
        # global stats over d = [parent, gps, sibs] (features 34-39)
        full = np.concatenate([pdist[:, None], gp_d, sib_d], axis=1)
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mn = np.nanmin(full, axis=1)
            mx = np.nanmax(full, axis=1)
            blocks.append(np.stack(
                [mn, mx, np.nanmedian(full, axis=1),
                 np.nanmean(full, axis=1), np.nanstd(full, axis=1),
                 mx - mn], axis=1))
        out = np.concatenate(blocks, axis=1).astype(np.float32)
        assert out.shape == (len(c), NUM_FEATURES)
        return out


def generate_supervision(taxonomy: Taxonomy, negative_size: int = 30,
                         seed: int = 0):
    """(X, y) training matrix from existing edges + queue negatives
    (self_supervision_generation.py:37-79)."""
    fe = FeatureExtractor(taxonomy)
    train_set = set(int(t) for t in taxonomy.train_node_ids)
    queue = NegativeQueue(list(train_set) * 2, seed=seed)
    rows, labels = [], []
    for q in train_set:
        parents = [p for p in taxonomy.parents.neighbors(q).tolist()
                   if p in train_set]
        if not parents:
            continue
        for p in parents:
            rows.append(fe.extract_features(q, p))
            labels.append(1)
        for n in queue.sample_avoid_positive_set(set(parents) | {q},
                                                 negative_size):
            rows.append(fe.extract_features(q, n))
            labels.append(0)
    return np.asarray(rows, np.float32), np.asarray(labels, np.float32)


# Hill-climb tuning grid + starting point (model_tuning.py:14-44). The
# objective stays 'binary:logistic'; sweep order IS the reference's dict
# order and is part of the algorithm (later sweeps see earlier winners).
TUNE_DEFAULT_PARAM = {
    "objective": "binary:logistic",
    "max_depth": 6,
    "min_child_weight": 5,
    "gamma": 0.0,
    "subsample": 0.5,
    "colsample_bytree": 0.8,
    "reg_alpha": 1.0,
    "reg_lambda": 0.1,
    "eta": 0.1,
    "importance_type": "weight",
    "random_state": 0,
    "tree_method": "hist",
    "eval_metric": ["error", "auc"],
}
TUNE_PARAM_GRID = {
    "max_depth": [3, 4, 5, 6, 7, 8],
    "min_child_weight": [0, 3, 5, 10, 15, 20, 50],
    "gamma": [0.0, 0.1, 0.2, 0.3, 0.4, 0.5],
    "subsample": [0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
    "colsample_bytree": [0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
    "reg_alpha": [1e-5, 1e-2, 0.1, 1, 10],
    "reg_lambda": [1e-5, 1e-2, 0.1, 1, 10],
    "eta": [0.01, 0.03, 0.1, 0.3, 1.0, 3.0],
    "random_state": [0, 7, 19, 47, 147, 940622],
    "importance_type": ["gain", "weight", "cover", "total_gain",
                        "total_cover"],
}


def tune_booster(x_train=None, y_train=None, x_val=None, y_val=None, *,
                 grid: dict | None = None, defaults: dict | None = None,
                 num_rounds: int = 100, early_stopping_rounds: int = 10,
                 train_fn=None, verbose: bool = False):
    """Coordinate-wise hill-climb over the hyper-parameter grid
    (model_tuning.py:46-67): sweep each parameter in grid order, keep the
    value with the best early-stopped validation score (ties break toward
    the LAST tied value, matching the reference's `>=`), and carry the
    winner into every later sweep. Returns (best_params, best_metric).

    `train_fn(params) -> score` overrides the xgboost objective — used by
    unit tests to exercise the loop without xgboost (absent in this image).
    """
    params = dict(defaults if defaults is not None else TUNE_DEFAULT_PARAM)
    grid = dict(grid if grid is not None else TUNE_PARAM_GRID)
    if train_fn is None:
        try:
            import xgboost as xgb
        except ImportError as e:
            raise RuntimeError(
                "xgboost is not installed in this environment; pass "
                "train_fn= to tune a different objective, or install "
                "xgboost (model_tuning.py equivalent)") from e
        dtrain = xgb.DMatrix(x_train, label=y_train)
        dval = xgb.DMatrix(x_val, label=y_val)
        evallist = [(dtrain, "train"), (dval, "eval")]

        def train_fn(p):
            bst = xgb.train(p, dtrain=dtrain, num_boost_round=num_rounds,
                            evals=evallist,
                            early_stopping_rounds=early_stopping_rounds,
                            verbose_eval=False)
            return float(bst.best_score)

    best_metric = None
    for name, values in grid.items():
        if verbose:
            print(f"=== tuning {name} ===")
        best_metric = -1e10
        best_value = None
        for value in values:
            params[name] = value
            cur = train_fn(dict(params))
            if cur >= best_metric:
                best_metric = cur
                best_value = value
        params[name] = best_value
        if verbose:
            print(f"  best {name}: {best_value} (metric {best_metric})")
    return params, best_metric


def train_booster(x: np.ndarray, y: np.ndarray, num_rounds: int = 200,
                  params: dict | None = None):
    try:
        import xgboost as xgb
    except ImportError as e:
        raise RuntimeError(
            "xgboost is not installed in this environment; the feature "
            "pipeline works standalone — install xgboost to train the "
            "booster (model_training.py equivalent)") from e
    dtrain = xgb.DMatrix(x, label=y)
    default = {"max_depth": 6, "eta": 0.1, "objective": "binary:logistic",
               "eval_metric": "logloss"}
    return xgb.train({**default, **(params or {})}, dtrain, num_rounds)


def evaluate(taxonomy: Taxonomy, booster, retrieval_size: int = -1) -> dict:
    """Rank candidates per test query with booster scores
    (model_prediction.py:104-136). Features come from the vectorized
    extract_features_batch — the per-pair Python loop was O(Q*C) function
    calls and unusable at MAG scale (the reference grew its cached
    extract_features_fast for exactly this reason,
    feature_extractor.py:157-261)."""
    import xgboost as xgb
    fe = FeatureExtractor(taxonomy)
    train_ids = [int(t) for t in taxonomy.train_node_ids]
    pos_of_train = {t: i for i, t in enumerate(train_ids)}
    all_ranks = []
    for q in taxonomy.test_node_ids:
        parents = [p for p in taxonomy.parents.neighbors(int(q)).tolist()
                   if p in pos_of_train]
        if not parents:
            continue
        cands = train_ids
        if retrieval_size > 0:  # embedding retrieval pre-filter
            d = 1.0 - fe.unit[np.asarray(cands)] @ fe.unit[int(q)]
            order = np.argsort(d)[:retrieval_size]
            cands = sorted(set([train_ids[i] for i in order]) | set(parents))
        x = fe.extract_features_batch(int(q), cands)
        scores = booster.predict(xgb.DMatrix(x))
        cand_col = {cand: i for i, cand in enumerate(cands)}
        pos_idx = [cand_col[p] for p in parents]
        all_ranks.append(ranks_from_scores(scores, pos_idx, mode=1))
    return {
        "num_queries": len(all_ranks),
        "macro_mr": macro_mr(all_ranks),
        "micro_mr": micro_mr(all_ranks),
        "hit_at_1": hit_at_1(all_ranks),
        "hit_at_3": hit_at_3(all_ranks),
        "hit_at_5": hit_at_5(all_ranks),
        "mrr_scaled_10": mrr_scaled_10(all_ranks),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--train", action="store_true",
                   help="train + evaluate an xgboost booster (requires "
                        "xgboost)")
    p.add_argument("--tune", action="store_true",
                   help="hill-climb the hyper-parameter grid on an 80/20 "
                        "row split before the final fit (model_tuning.py)")
    p.add_argument("--negative_size", type=int, default=30)
    args = p.parse_args(argv)
    taxo = Taxonomy.load(args.data)
    x, y = generate_supervision(taxo, negative_size=args.negative_size)
    print(f"supervision matrix: {x.shape}, positives: {int(y.sum())}")
    params = None
    if args.tune:
        # supervision rows are ordered by node traversal — shuffle with a
        # fixed seed before the 80/20 split so the validation set is not a
        # systematically non-random node subset (ADVICE r2)
        perm = np.random.default_rng(0).permutation(len(x))
        x_s, y_s = x[perm], y[perm]
        split = int(0.8 * len(x_s))
        params, metric = tune_booster(x_s[:split], y_s[:split], x_s[split:],
                                      y_s[split:], verbose=True)
        print(f"tuned params (val metric {metric}): {params}")
    if args.train:
        booster = train_booster(x, y, params=params)
        for k, v in evaluate(taxo, booster).items():
            print(f"{k}: {v}")


if __name__ == "__main__":
    main()
