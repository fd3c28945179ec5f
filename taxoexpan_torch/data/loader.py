"""Host-side batch loader producing fixed-shape GroupBatches (port of
`taxoexpan_tpu/data/loader.py`, the Python backend).

Group layouts (static across an epoch):
- train (sampling_mode 1): C = 1 + negative_size, positive in column 0 —
  the InfoNCE layout;
- validation (sampling_mode 0): C = max_query_parents + negative_size;
  positives occupy the leading parent slots (cand_mask-padded), negatives
  the rest ("at most k").

The final partial batch is padded with empty groups (cand_mask all False);
losses and metrics ignore them. Batches are built on a background prefetch
thread.

Backends: "native" fills each batch in one call of the C++ sampler
(`taxoexpan_torch/native`, built with g++ at first use) and raises if the
library cannot be built; "auto" (the default, as in the JAX package) takes
it wherever it builds and the Python sampler otherwise; "python" is the
Python sampler. `loader.backend` says which one the loader took.
"""
from __future__ import annotations

import logging
import queue
import random
import threading

import numpy as np

from .. import native
from .egobatch import EgoBatch, GroupBatch, make_ego_batch
from .sampler import MaskedGraphSampler

logger = logging.getLogger(__name__)


class GroupBatchLoader:
    def __init__(self,
                 sampler: MaskedGraphSampler,
                 batch_size: int,
                 shuffle: bool = True,
                 seed: int = 0,
                 prefetch: int = 2,
                 backend: str = "auto"):
        if sampler.mode == "test":
            raise ValueError(
                "GroupBatchLoader serves train/validation; use "
                "taxoexpan_torch.evaluation for test-time all-candidate "
                "ranking")
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown loader backend {backend!r}")
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.prefetch = prefetch
        # the native sampler for the train layout (sampling_mode 1) and
        # the validation layout (sampling_mode 0)
        self.native = None
        if backend != "python":
            try:
                native.get_lib()
            except RuntimeError as e:
                if backend == "native":
                    raise
                logger.info("loader backend auto: the native sampler did "
                            "not build, using the Python sampler (%s)", e)
            else:
                self.native = native.NativeSampler(sampler, seed=seed)
        self.backend = "python" if self.native is None else "native"
        if sampler.sampling_mode == 1:
            self.max_pos = 1
        else:
            self.max_pos = sampler.max_query_parents
        self.group_size = self.max_pos + sampler.negative_size
        self.num_queries = len(sampler)
        self.num_batches = -(-self.num_queries // self.batch_size)

    def _build_batch_native(self, queries: list[int]) -> GroupBatch:
        s = self.sampler
        g, c = self.batch_size, self.group_size
        n = s.max_parents + 1 + s.expand_factor
        q = np.asarray(queries, dtype=np.int32)
        sample = self.native.sample_train_batch if s.sampling_mode == 1 \
            else self.native.sample_eval_batch
        node_ids, ngp, nsib, labels, cand_mask = sample(q)
        pad = g - len(queries)
        if pad:                     # pad the final batch with empty groups
            node_ids = np.vstack([node_ids,
                                  np.zeros((pad * c, n), np.int32)])
            ngp = np.concatenate([ngp, np.zeros(pad * c, np.int32)])
            nsib = np.concatenate([nsib, np.zeros(pad * c, np.int32)])
            labels = np.vstack([labels, np.zeros((pad, c), np.float32)])
            cand_mask = np.vstack([cand_mask, np.zeros((pad, c), bool)])
        query_ids = np.zeros((g,), np.int32)
        query_ids[:len(queries)] = q
        ego = EgoBatch(node_ids=node_ids, ngp=ngp, nsib=nsib)
        return GroupBatch(ego=ego, query_ids=query_ids, query_feats=None,
                          labels=labels, cand_mask=cand_mask)

    def _build_batch(self, queries: list[int]) -> GroupBatch:
        if self.native is not None:
            return self._build_batch_native(queries)
        s = self.sampler
        g, c = self.batch_size, self.group_size
        labels = np.zeros((g, c), dtype=np.float32)
        cand_mask = np.zeros((g, c), dtype=bool)
        query_ids = np.zeros((g,), dtype=np.int32)
        egonets = [([], 0, [])] * (g * c)

        for gi, q in enumerate(queries):
            enets, labs, _anchors = s.sample_group(q)
            npos = sum(labs)
            nneg = len(labs) - npos
            if npos > self.max_pos or nneg > s.negative_size:
                raise RuntimeError(
                    f"group overflow for query {q}: {npos} positives (max "
                    f"{self.max_pos}), {nneg} negatives (max "
                    f"{s.negative_size})")
            query_ids[gi] = q
            for j in range(npos):
                egonets[gi * c + j] = enets[j]
                labels[gi, j] = 1.0
                cand_mask[gi, j] = True
            for j in range(nneg):
                col = self.max_pos + j
                egonets[gi * c + col] = enets[npos + j]
                cand_mask[gi, col] = True

        ego = make_ego_batch(egonets, s.max_parents, s.expand_factor)
        return GroupBatch(ego=ego, query_ids=query_ids, query_feats=None,
                          labels=labels, cand_mask=cand_mask)

    def _batches(self):
        order = list(self.sampler.node_list)
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            yield self._build_batch(order[i:i + self.batch_size])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list[BaseException] = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # surface worker errors in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]

    def __len__(self) -> int:
        return self.num_batches
