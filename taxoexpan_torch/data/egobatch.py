"""Fixed-shape padded ego-network batches (numpy).

Port counterpart of `taxoexpan_tpu/data/egobatch.py` without the JAX pytree
registration: every TaxoExpan egonet is a depth-1 star around a candidate
anchor laid out in a fixed slot grid

    slot 0 .. P-1 : grandparents  (ngp valid, position code 0)
    slot P        : anchor        (always valid, position code 1)
    slot P+1..N-1 : siblings      (nsib valid, position code 2)

with N = P + 1 + S (P = max parents, S = expand_factor). Batches carry node
ids; features are gathered on the device from the resident feature table.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

Egonet = tuple[Sequence[int], int, Sequence[int]]  # (grandparents, anchor, siblings)


@dataclass
class EgoBatch:
    """A batch of B padded star egonets (numpy arrays)."""
    node_ids: np.ndarray   # [B, N] int32, global node ids (0 in padded slots)
    ngp: np.ndarray        # [B] int32, number of valid grandparent slots
    nsib: np.ndarray       # [B] int32, number of valid sibling slots

    @property
    def batch_size(self) -> int:
        return self.node_ids.shape[0]

    @property
    def num_slots(self) -> int:
        return self.node_ids.shape[1]


@dataclass
class GroupBatch:
    """G query groups of C candidate positions each (see the JAX package's
    GroupBatch for the train / eval column layouts)."""
    ego: EgoBatch
    query_ids: Optional[np.ndarray]    # [G] int32 (None when query_feats given)
    query_feats: Optional[np.ndarray]  # [G, D] float32
    labels: np.ndarray                 # [G, C] float32, 1.0 = positive
    cand_mask: np.ndarray              # [G, C] bool, True = real candidate

    @property
    def num_groups(self) -> int:
        return self.labels.shape[0]

    @property
    def group_size(self) -> int:
        return self.labels.shape[1]


def make_ego_batch(egonets: Sequence[Egonet], max_parents: int,
                   expand_factor: int) -> EgoBatch:
    """Collate python egonet triplets into a padded EgoBatch (host side)."""
    b = len(egonets)
    n = max_parents + 1 + expand_factor
    node_ids = np.zeros((b, n), dtype=np.int32)
    ngp = np.zeros((b,), dtype=np.int32)
    nsib = np.zeros((b,), dtype=np.int32)
    for i, (gps, anchor, sibs) in enumerate(egonets):
        g = min(len(gps), max_parents)
        s = min(len(sibs), expand_factor)
        if g:
            node_ids[i, :g] = gps[:g]
        node_ids[i, max_parents] = anchor
        if s:
            node_ids[i, max_parents + 1:max_parents + 1 + s] = sibs[:s]
        ngp[i] = g
        nsib[i] = s
    return EgoBatch(node_ids=node_ids, ngp=ngp, nsib=nsib)
