"""Two-phase candidate ranking engine, the core of test_fast and infer
(port of `taxoexpan_tpu/evaluation/ranker.py`).

Phase 1 (encode): build every candidate anchor's egonet once and encode them
through propagate + readout in chunks of `encode_chunk` egonets; on CUDA
each chunk runs the model's eval kernels: the two star-GAT forwards of
`ops/gat_kernels.py` (GAT/PGAT) or the star-GCN forward of
`ops/gcn_kernels.py` once a layer (GCN/PGCN).

Phase 2 (score): score all queries against all candidates with the
matcher's all-pairs form (for BIM one (hg @ W) @ qf^T product), then count
ranks on the device, in query chunks. The dense work here (the matcher
product, the cosine prefilter, rank counting) stays plain torch, run in full
float32 (TF32 off, `device.resolve_device`).

Multi-process (`layout`, parallel/mesh.py: the trainer's full-catalog
validation, `test_fast -m` and `infer -m`; ranker.py:33-64): the candidate
egonets are padded to a multiple of the dp size with empty egonets, each
dp rank encodes its contiguous share in chunks (with mp > 1 the mp ranks of
one dp index encode the same share, the GAT heads split between them,
models/propagation.py), and the dp ranks all-gather hg, so every rank
scores and ranks the whole catalog as a single process would, to the same
metrics.

Differences from the JAX engine, none of them visible in the results: the
encode loop does not pad the candidate list to a whole number of chunks
(the padding served jit's static shapes), and top-k selections use a stable
sort so that ties go to the lowest candidate index exactly as `lax.top_k`
and the sampler's stable argsort break them (`torch.topk` promises no tie
order on CUDA).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import metrics as metrics_mod
from ..data.sampler import MaskedGraphSampler
from ..device import resolve_device
from ..parallel import distributed
from ..weights import params_to

logger = logging.getLogger(__name__)


class TaxonomyRanker:
    def __init__(self, model, params: dict, sampler: MaskedGraphSampler,
                 feature_table, *, encode_chunk: int = 4096,
                 query_chunk: int = 256, anchors: list[int] | None = None,
                 device: str | torch.device = "cuda", layout=None):
        self.device = resolve_device(device)
        dp = layout.dp if layout is not None else None
        self.dp = dp if dp is not None and dp.size > 1 else None
        if layout is not None:
            model.propagate.mp = layout.mp
        self.model = model
        self.params = params_to(params, self.device)
        self.sampler = sampler
        self.feature_table = np.asarray(feature_table, dtype=np.float32)
        self.encode_chunk = encode_chunk
        self.query_chunk = query_chunk
        # candidate positions: train node ids; infer passes every node of
        # the working graph instead
        self.candidates = (sorted(anchors) if anchors is not None
                           else list(sampler.candidate_positions))
        self._hg = None
        self._anchor_cache = None
        self._query_cache = None
        self._table = torch.from_numpy(self.feature_table).to(self.device)
        # wall seconds of the last run of each stage: "anchor_arrays" (the
        # candidate egonets on the host), "encode" (their encoding, the
        # anchor arrays excluded), "query_prep" (evaluate's host prep),
        # "rank" (scoring and ranking every query)
        self.timing: dict[str, float] = {}

    def refresh(self, params: dict) -> None:
        """Re-point the ranker at fresh parameters (per-epoch full-catalog
        validation, training/trainer.py). Drops the encoded anchors (they
        depend on params) and keeps every params-independent cache: the
        anchor egonet arrays, the device feature table and the evaluate()
        host-side prep."""
        self.params = params_to(params, self.device)
        self._hg = None

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _anchor_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(node_ids, ngp, nsib) host arrays of every candidate egonet,
        built once in one vectorised CSR pass."""
        if self._anchor_cache is None:
            t0 = time.time()
            ego = self.sampler.anchor_ego_batch(
                np.asarray(self.candidates, dtype=np.int64))
            self._anchor_cache = (ego.node_ids, ego.ngp, ego.nsib)
            self.timing["anchor_arrays"] = time.time() - t0
        return self._anchor_cache

    # ------------------------------------------------------------ phase 1
    @torch.no_grad()
    def encode_all_anchors(self) -> torch.Tensor:
        """Encode every candidate egonet once -> hg [C, l_dim] on the
        ranker's device."""
        if self._hg is not None:
            return self._hg
        node_ids, ngp, nsib = self._anchor_arrays()
        t0 = time.time()
        n = len(node_ids)
        if self.dp is not None:
            # this rank's share of the candidates padded with empty egonets
            size, rank = self.dp.size, self.dp.rank
            share = -(-n // size)
            pad = share * size - n
            node_ids, ngp, nsib = (
                np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                [rank * share:(rank + 1) * share]
                for a in (node_ids, ngp, nsib))
        out = []
        for start in range(0, len(node_ids), self.encode_chunk):
            sl = slice(start, start + self.encode_chunk)
            ids_c = self._tensor(node_ids[sl]).long()
            ngp_c = self._tensor(ngp[sl])
            nsib_c = self._tensor(nsib[sl])
            feats = self.model.gather_feats(self._table, ids_c, ngp_c,
                                            nsib_c)
            out.append(self.model.encode(self.params, feats, ngp_c, nsib_c))
        self._hg = (torch.cat(out) if out else
                    torch.zeros((0, 1), device=self.device))
        if self.dp is not None:
            self._hg = distributed.all_gather_cat(self._hg, self.dp)[:n]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timing["encode"] = time.time() - t0
        logger.info("Encoded %d candidate positions in %.2fs",
                    len(self.candidates), self.timing["encode"])
        return self._hg

    # ------------------------------------------------------------ phase 2
    @torch.no_grad()
    def score(self, query_feats: np.ndarray) -> np.ndarray:
        """[Q, D] query features -> [Q, C] scores."""
        hg = self.encode_all_anchors()
        q = np.asarray(query_feats, dtype=np.float32)
        out = [self.model.match_all(self.params, hg,
                                    self._tensor(q[i:i + self.query_chunk]))
               for i in range(0, q.shape[0], self.query_chunk)]
        if not out:
            return np.zeros((0, hg.shape[0]), np.float32)
        return torch.cat(out).cpu().numpy()

    # ---------------------------------------------------------- evaluation
    def evaluate(self, metric_names: list[str], rank_mode: int,
                 case_study: bool = False,
                 prior_lambda: float | None = None
                 ) -> tuple[dict, list[list[str]]]:
        """Rank every test query against its candidate set and average the
        per-query metrics over queries (the reference's test_fast).

        A query's negatives are the candidate positions minus its
        node2masks set, optionally prefiltered to the `test_topk` nearest
        candidates by embedding cosine distance (sampler.eval_negatives).
        Positives are always ranked; other positives are excluded from the
        comparison."""
        s = self.sampler
        queries = list(s.node_list)
        metric_fns = [metrics_mod.get_metric(m) for m in metric_names]
        n_cand = len(self.candidates)
        self.encode_all_anchors()
        t0 = time.time()
        qf, mask_pairs, pos_cols, pos_lists = self._query_prep()
        t1 = time.time()
        ranks_all, top5_all = self._rank_on_device(
            qf, mask_pairs, pos_cols, rank_mode, prior_lambda=prior_lambda)
        self.timing.update(query_prep=t1 - t0, rank=time.time() - t1)

        totals = np.zeros(len(metric_fns))
        cases: list[list[str]] = []
        if case_study:
            cases.append(["Test node index", "True parents",
                          "Predicted parents"] + metric_names)
        for qi, query in enumerate(queries):
            ranks = [ranks_all[qi, :len(pos_lists[qi])].tolist()]
            row: list[str] = []
            if case_study:
                top5 = [self.candidates[i] for i in top5_all[qi]
                        if i < n_cand]
                vocab = s.taxonomy.vocab
                parents = s.node2parents[query]
                row = [vocab[query],
                       ", ".join(vocab[p] for p in parents),
                       ", ".join(vocab[p] for p in top5)]
            for mi, fn in enumerate(metric_fns):
                val = fn(ranks)
                totals[mi] += val
                if case_study:
                    row.append(str(val))
            if case_study:
                cases.append(row)
        n = max(len(queries), 1)
        result = {m: totals[i] / n for i, m in enumerate(metric_names)}
        result["test_topk"] = s.test_topk
        return result, cases

    def select_prior_lambda(self, lambdas, rank_mode: int,
                            select_metric: str = "combined_metrics"
                            ) -> tuple[float, dict]:
        """Calibrate the structure-prior blend weight on this ranker's split:
        sweep `score + lam * (qf @ raw_channel.T)` and return (best_lam,
        {lam: metric}). macro/micro_mr and combined_metrics minimise, the
        others maximise. Assumes higher-is-better scores (rank_mode 1)."""
        minimize = select_metric in ("macro_mr", "micro_mr",
                                     "combined_metrics")
        curve: dict[float, float] = {}
        best_lam, best_val = None, None
        for lam in lambdas:
            res, _ = self.evaluate([select_metric], rank_mode,
                                   prior_lambda=float(lam))
            v = float(res[select_metric])
            curve[float(lam)] = v
            if best_val is None or (v < best_val if minimize
                                    else v > best_val):
                best_lam, best_val = float(lam), v
        return best_lam, curve

    def _query_prep(self):
        """Host-side evaluate() prep, params-independent and cached: query
        features, masked (row, col) pairs, positive columns (n_cand in
        unused slots) and per-query positive lists."""
        if self._query_cache is not None:
            return self._query_cache
        s = self.sampler
        queries = list(s.node_list)
        cand_index = {c: i for i, c in enumerate(self.candidates)}
        n_cand = len(self.candidates)
        pos_lists = []
        for query in queries:
            pos_idx = [cand_index[p] for p in s.node2parents[query]
                       if p in cand_index]
            if not pos_idx:
                # the metrics average over every query; a query without a
                # candidate parent would silently change the denominator
                raise ValueError(
                    f"query {query} has no true parent among the "
                    f"{n_cand} candidate positions; evaluation would not "
                    "match the reference's denominator")
            pos_lists.append(pos_idx)
        max_pos = max((len(p) for p in pos_lists), default=1)
        pos_cols = np.full((len(queries), max_pos), n_cand, dtype=np.int64)
        for qi, p in enumerate(pos_lists):
            pos_cols[qi, :len(p)] = p
        col_of = np.full(len(s.node_features), -1, dtype=np.int64)
        col_of[np.asarray(self.candidates, dtype=np.int64)] = \
            np.arange(n_cand)
        mask_rows, mask_cols = [], []
        for qi, query in enumerate(queries):
            masked = s.node2masks.get(query)
            if masked:
                cols = col_of[np.fromiter(masked, dtype=np.int64,
                                          count=len(masked))]
                cols = cols[cols >= 0]
                mask_rows.append(np.full(cols.shape[0], qi, np.int64))
                mask_cols.append(cols)
        mask_rows = (np.concatenate(mask_rows) if mask_rows
                     else np.zeros(0, np.int64))
        mask_cols = (np.concatenate(mask_cols) if mask_cols
                     else np.zeros(0, np.int64))
        qf = s.node_features[np.asarray(queries, dtype=np.int64)].astype(
            np.float32)
        self._query_cache = (qf, (mask_rows, mask_cols), pos_cols,
                             pos_lists)
        return self._query_cache

    def _blend_lambda(self, prior_lambda: float | None) -> float | None:
        if prior_lambda is not None and \
                not getattr(self.model, "raw_channel", False):
            raise ValueError("prior_lambda requires a raw_channel model "
                             "(the prior rides the tail block of hg)")
        return prior_lambda

    def _chunk_scores(self, hg, qf_c, lam):
        """Matcher scores [q, C], plus lam * (qf @ raw_channel.T) when
        blending (the raw channel is hg's tail block)."""
        scores = self.model.match_all(self.params, hg, qf_c)
        if lam is not None:
            rc = hg[:, self.model.readout.l_dim:].float()
            scores = scores + lam * (qf_c @ rc.T)
        return scores

    @torch.no_grad()
    def _rank_on_device(self, qf: np.ndarray,
                        mask_pairs: tuple[np.ndarray, np.ndarray],
                        pos_cols: np.ndarray, rank_mode: int,
                        prior_lambda: float | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(ranks [Q, P], meaningful in each query's first len(positives)
        slots, and top5 [Q, 5] candidate columns), computed on the device
        per query chunk: rank = 1 + |{usable negatives scoring better}| per
        positive column, exactly as metrics.ranks_from_scores."""
        lam = self._blend_lambda(prior_lambda)
        s = self.sampler
        n_cand = len(self.candidates)
        q_total, max_pos = pos_cols.shape
        mode1 = rank_mode == 1
        k = min(s.test_topk, n_cand) if s.test_topk != -1 else -1
        n_top = min(5, n_cand)
        hg = self.encode_all_anchors()
        unit_cand = qunit = None
        if k != -1:
            # the exact normalised table sampler.eval_negatives ranks with
            unit_cand = self._tensor(s._unit_features[
                np.asarray(self.candidates, dtype=np.int64)])
            qunit = qf / np.maximum(
                np.linalg.norm(qf, axis=1, keepdims=True), 1e-12)
        pool = torch.ones((q_total, n_cand), dtype=torch.bool,
                          device=self.device)
        pool[self._tensor(mask_pairs[0]), self._tensor(mask_pairs[1])] = False
        pos_all = self._tensor(pos_cols)
        ranks_out, top_out = [], []
        for start in range(0, q_total, self.query_chunk):
            sl = slice(start, start + self.query_chunk)
            qf_c = self._tensor(qf[sl])
            pos_c = pos_all[sl]
            scores = self._chunk_scores(hg, qf_c, lam)
            if k != -1:
                dist = 1.0 - self._tensor(qunit[sl]) @ unit_cand.T
                dist = torch.where(pool[sl], dist,
                                   torch.full_like(dist, float("inf")))
                pool_eff = _topk_mask(dist, k)
            else:
                pool_eff = pool[sl]
            # positives never count as negatives; unused slots hold n_cand
            # and land in a scratch column that is cut off
            neg = _set_columns(pool_eff, pos_c, False)
            pos_scores = torch.gather(scores, 1,
                                      pos_c.clamp(max=n_cand - 1))  # [q, P]
            if mode1:
                better = scores[:, None, :] > pos_scores[:, :, None]
            else:
                better = scores[:, None, :] < pos_scores[:, :, None]
            ranks = 1 + (better & neg[:, None, :]).sum(dim=2,
                                                        dtype=torch.int32)
            # case-study predictions: positives + usable negatives, best
            # first, ties to the lowest candidate index
            allowed = _set_columns(pool_eff, pos_c, True)
            fill = float("-inf") if mode1 else float("inf")
            case = torch.where(allowed, scores, torch.full_like(scores, fill))
            top_out.append(_stable_top(case if mode1 else -case, n_top))
            ranks_out.append(ranks)
        if not ranks_out:
            return (np.zeros((0, max_pos), np.int32),
                    np.zeros((0, n_top), np.int64))
        return (torch.cat(ranks_out).cpu().numpy(),
                torch.cat(top_out).cpu().numpy())

    # --------------------------------------------------------------- infer
    @torch.no_grad()
    def predict_parents(self, query_feats: np.ndarray, rank_mode: int,
                        topk: int = 5,
                        prior_lambda: float | None = None
                        ) -> list[list[int]]:
        """Top-k candidate parents per novel query. With `test_topk > 0`
        on the sampler, candidates are first prefiltered to the test_topk
        nearest positions by embedding cosine distance. Ties rank
        lowest-candidate-index first."""
        lam = self._blend_lambda(prior_lambda)
        q = np.asarray(query_feats, dtype=np.float32)
        prefilter = self.sampler.test_topk
        n_cand = len(self.candidates)
        n_top = min(topk, n_cand)
        mode1 = rank_mode == 1
        k = min(prefilter, n_cand) if prefilter != -1 else -1
        if q.shape[0] == 0:
            return []
        hg = self.encode_all_anchors()
        unit_cand = qunit = None
        if k != -1:
            cand = self.feature_table[np.asarray(self.candidates)]
            unit_cand = self._tensor(cand / np.maximum(
                np.linalg.norm(cand, axis=1, keepdims=True), 1e-12))
            qunit = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                                   1e-12)
        out = []
        for start in range(0, q.shape[0], self.query_chunk):
            sl = slice(start, start + self.query_chunk)
            scores = self._chunk_scores(hg, self._tensor(q[sl]), lam)
            if k != -1:
                dist = 1.0 - self._tensor(qunit[sl]) @ unit_cand.T
                scores = torch.where(
                    _topk_mask(dist, k), scores,
                    torch.full_like(scores,
                                    float("-inf") if mode1 else float("inf")))
            out.append(_stable_top(scores if mode1 else -scores, n_top))
        idx = torch.cat(out).cpu().numpy()
        return [[self.candidates[i] for i in row] for row in idx]


def _set_columns(mask: torch.Tensor, cols: torch.Tensor,
                 value: bool) -> torch.Tensor:
    """Copy of bool `mask` [q, C] with mask[r, cols[r, j]] = value; entries
    of `cols` equal to C (unused slots) are dropped."""
    q, c = mask.shape
    out = torch.cat([mask, mask.new_zeros((q, 1))], dim=1)
    out.scatter_(1, cols, value)
    return out[:, :c]


def _stable_top(key: torch.Tensor, n: int) -> torch.Tensor:
    """Column indices of each row's n largest keys, ties lowest index first
    (the order of `lax.top_k`), in a tensor of their own: a slice of the
    sort's [q, C] int64 indices would keep all of them alive while the
    callers collect every query chunk's (45 GB over 17,777 queries x
    319,446 candidates)."""
    return torch.sort(key, dim=1, descending=True, stable=True)[1][
        :, :n].clone()


def _topk_mask(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Bool mask of each row's k smallest finite entries, ties filled
    lowest-index-first: exact parity with a stable argsort over the finite
    pool (sampler.eval_negatives). Rows with fewer than k finite entries
    keep all of them."""
    kth = torch.topk(dist, k, dim=1, largest=False).values[:, -1:]
    finite = torch.isfinite(dist)
    lt = dist < kth
    n_lt = lt.sum(dim=1, keepdim=True)
    eq = (dist == kth) & finite
    cum = torch.cumsum(eq.to(torch.int32), dim=1)
    return lt | (eq & (cum <= (k - n_lt)))
