"""Generic split-sampling loader base — parity with base/base_data_loader.py
(port copy of `taxoexpan_tpu/data/split_loader.py`, numpy only).

The reference ships a victoresque-template BaseDataLoader that splits a
dataset into train/validation index samplers (base_data_loader.py:7-61); the
main TaxoExpan path never uses it (MaskedGraphDataLoader subclasses torch's
DataLoader directly — SURVEY.md §2.3). Provided here for capability parity:
a framework-agnostic index-split batch iterator over any sequence-like
dataset.
"""
from __future__ import annotations

import numpy as np


class SplitBatchLoader:
    """Shuffled batch iterator with a held-out validation split.

    `validation_split`: float fraction (0 < x < 1) or int count, like
    base_data_loader.py:30-55. `split_validation()` returns the paired
    validation loader.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 validation_split: float | int = 0.0, seed: int = 0,
                 collate_fn=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.collate_fn = collate_fn or (lambda items: items)
        n = len(dataset)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(n) if shuffle else np.arange(n)
        if isinstance(validation_split, float) and 0 < validation_split < 1:
            n_val = int(n * validation_split)
        elif isinstance(validation_split, int) and validation_split > 0:
            if validation_split >= n:
                raise ValueError(
                    "validation set size is configured to be larger than "
                    "entire dataset")
            n_val = validation_split
        else:
            n_val = 0
        self.valid_idx = idx[:n_val]
        self.train_idx = idx[n_val:]
        self._indices = self.train_idx
        self.rng = rng

    @property
    def n_samples(self) -> int:
        return len(self._indices)

    def split_validation(self) -> "SplitBatchLoader | None":
        if len(self.valid_idx) == 0:
            return None
        val = SplitBatchLoader.__new__(SplitBatchLoader)
        val.dataset = self.dataset
        val.batch_size = self.batch_size
        val.shuffle = False
        val.collate_fn = self.collate_fn
        val.valid_idx = np.asarray([], dtype=np.int64)
        val.train_idx = self.valid_idx
        val._indices = self.valid_idx
        val.rng = self.rng
        return val

    def __len__(self) -> int:
        return -(-len(self._indices) // self.batch_size)

    def __iter__(self):
        order = np.array(self._indices)
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, len(order), self.batch_size):
            items = [self.dataset[int(i)] for i in order[lo:lo + self.batch_size]]
            yield self.collate_fn(items)
