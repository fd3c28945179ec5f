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


def slot_mask(ngp: np.ndarray, nsib: np.ndarray, max_parents: int,
              expand_factor: int) -> np.ndarray:
    """[B, N] validity mask from the per-egonet gp / sibling counts."""
    n = max_parents + 1 + expand_factor
    slots = np.arange(n, dtype=np.int32)[None, :]
    gp_ok = slots < np.asarray(ngp)[:, None]
    anchor_ok = slots == max_parents
    sib_ok = (slots > max_parents) & (
        slots < max_parents + 1 + np.asarray(nsib)[:, None])
    return gp_ok | anchor_ok | sib_ok


def ego_batch_edges(batch: EgoBatch, max_parents: int, expand_factor: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (src, dst, edge_mask) arrays of the batched star graphs over the
    flattened [B * N] node space, the generic sparse view (models/
    generic.py). Edge slots per egonet (E = N + P + S), in the edge order
    of the reference's dataset (data_loader/dataset.py:431-435):
        e in [0, P)        : gp_e -> anchor           (valid iff e < ngp)
        e in [P, P+S)      : anchor -> sibling_(e-P)  (valid iff e-P < nsib)
        e in [P+S, P+S+N)  : self-loops               (valid iff node valid)
    """
    b = batch.node_ids.shape[0]
    p, s = max_parents, expand_factor
    n = p + 1 + s
    ngp = np.asarray(batch.ngp)
    nsib = np.asarray(batch.nsib)
    src = np.zeros((b, p + s + n), dtype=np.int32)
    dst = np.zeros((b, p + s + n), dtype=np.int32)
    mask = np.zeros((b, p + s + n), dtype=bool)

    gp_slots = np.arange(p, dtype=np.int32)
    src[:, :p] = gp_slots[None, :]
    dst[:, :p] = p
    mask[:, :p] = gp_slots[None, :] < ngp[:, None]

    src[:, p:p + s] = p
    dst[:, p:p + s] = np.arange(s, dtype=np.int32)[None, :] + p + 1
    mask[:, p:p + s] = np.arange(s)[None, :] < nsib[:, None]

    src[:, p + s:] = np.arange(n, dtype=np.int32)[None, :]
    dst[:, p + s:] = np.arange(n, dtype=np.int32)[None, :]
    mask[:, p + s:] = slot_mask(ngp, nsib, p, s)

    offset = (np.arange(b, dtype=np.int32) * n)[:, None]
    return ((src + offset).reshape(-1), (dst + offset).reshape(-1),
            mask.reshape(-1))
