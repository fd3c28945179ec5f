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
thread. The JAX package's native C++ sampler (`taxoexpan_tpu/native`) is
not ported: `backend="native"` raises, "auto" is the Python backend.
"""
from __future__ import annotations

import queue
import random
import threading

import numpy as np

from .egobatch import GroupBatch, make_ego_batch
from .sampler import MaskedGraphSampler


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
        if backend == "native":
            raise ValueError("the native C++ sampler is not ported; use "
                             "backend='python' (or 'auto')")
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.prefetch = prefetch
        if sampler.sampling_mode == 1:
            self.max_pos = 1
        else:
            self.max_pos = sampler.max_query_parents
        self.group_size = self.max_pos + sampler.negative_size
        self.num_queries = len(sampler)
        self.num_batches = -(-self.num_queries // self.batch_size)

    def _build_batch(self, queries: list[int]) -> GroupBatch:
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
