"""The reference's own view of a generated taxonomy: the working graphs of
the reference implementation's `MaskedGraphDataset` (data_loader/
dataset.py:206-437) and the star egonets built on them, in numpy.

- training: the graph induced on the train nodes; a query's positives are
  its parents, a negative anchor is any train node outside the query's
  mask (its descendants, parents, itself and the roots);
- serving (test): the graph induced on the train and test nodes with the
  test nodes' in-edges removed; the candidates are the train and test
  nodes (infer's anchor set).

An egonet of anchor a: its first P parents (P = the largest in-degree of
the working graph, at most 64), a, and all its children (minus the query
for a positive egonet). The reference builds every child set whole, so it
holds only while no anchor has more children than the egonet has sibling
slots; `check_expand` says where that fails.
"""
from __future__ import annotations

from collections import deque

import numpy as np


class WorkingGraph:
    def __init__(self, tax, mode: str):
        train = np.asarray(tax.train_node_ids, dtype=np.int64)
        v = tax.num_nodes
        allowed = np.zeros(v, dtype=bool)
        allowed[train] = True
        if mode == "test":
            allowed[np.asarray(tax.test_node_ids, dtype=np.int64)] = True
        e = np.asarray(tax.edges, dtype=np.int64)
        e = e[allowed[e[:, 0]] & allowed[e[:, 1]]]
        in_deg = np.bincount(e[:, 1], minlength=v)
        self.roots = set(np.flatnonzero(allowed & (in_deg == 0)).tolist())
        self.pre_children = _csr(v, e[:, 0], e[:, 1])
        self.pre_parents = _csr(v, e[:, 1], e[:, 0])
        if mode == "test":
            test = np.zeros(v, dtype=bool)
            test[np.asarray(tax.test_node_ids, dtype=np.int64)] = True
            e = e[~test[e[:, 1]]]
        self.children = _csr(v, e[:, 0], e[:, 1])
        self.parents = _csr(v, e[:, 1], e[:, 0])
        deg = np.diff(self.parents[0])
        self.max_parents = max(1, min(int(deg.max()) if len(e) else 1, 64))
        self.candidates = np.flatnonzero(allowed)

    def kids(self, a: int) -> np.ndarray:
        ip, ix = self.children
        return ix[ip[a]:ip[a + 1]]

    def pars(self, a: int) -> np.ndarray:
        ip, ix = self.parents
        return ix[ip[a]:ip[a + 1]]

    def true_parents(self, q: int) -> set:
        ip, ix = self.pre_parents
        return set(ix[ip[q]:ip[q + 1]].tolist())

    def mask(self, q: int) -> set:
        """Positions that are never a negative of query q."""
        ip, ix = self.pre_children
        seen: set = set()
        dq = deque(ix[ip[q]:ip[q + 1]].tolist())
        while dq:
            n = dq.popleft()
            if n not in seen:
                seen.add(n)
                dq.extend(ix[ip[n]:ip[n + 1]].tolist())
        return seen | self.true_parents(q) | {q} | self.roots

    def check_expand(self, expand_factor: int) -> None:
        most = int(np.diff(self.children[0]).max())
        if most > expand_factor:
            raise ValueError(
                f"an anchor has {most} children, more than the "
                f"{expand_factor} sibling slots: the sampler would draw "
                "them, which the reference does not follow")

    def ego_arrays(self, anchors: np.ndarray, expand_factor: int):
        """(node_ids [B, N], ngp [B], nsib [B]) of the egonets of
        `anchors` (no query excluded), int64."""
        p, s = self.max_parents, expand_factor
        a = np.asarray(anchors, dtype=np.int64)
        ids = np.zeros((len(a), p + 1 + s), dtype=np.int64)
        ids[:, p] = a
        out = []
        for (ip, ix), width, off in ((self.parents, p, 0),
                                     (self.children, s, p + 1)):
            deg = np.minimum(ip[a + 1] - ip[a], width)
            cols = np.arange(width)[None, :]
            ok = cols < deg[:, None]
            idx = np.minimum(ip[a][:, None] + cols, max(len(ix) - 1, 0))
            ids[:, off:off + width] = np.where(ok, ix[idx] if len(ix) else 0,
                                               0)
            out.append(deg)
        return ids, out[0], out[1]


def _csr(v: int, src: np.ndarray, dst: np.ndarray):
    order = np.argsort(src, kind="stable")
    ip = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=v), out=ip[1:])
    return ip, dst[order].astype(np.int64)


def batch_mismatches(graph: WorkingGraph, node_ids, ngp, nsib, query_ids,
                     labels, cand_mask) -> int:
    """Egonets of a training batch ([G * C] rows of G groups) that are not
    what the working graph gives: a positive (column 0) must be a true
    parent's egonet without the query among its siblings, a negative an
    anchor outside the query's mask; its grandparents the anchor's first
    P parents and its siblings exactly the anchor's children."""
    p = graph.max_parents
    g, c = labels.shape
    bad = 0
    for gi in range(g):
        if not cand_mask[gi].any():
            continue
        q = int(query_ids[gi])
        parents = graph.true_parents(q)
        masked = graph.mask(q)
        for ci in range(c):
            if not cand_mask[gi, ci]:
                continue
            r = gi * c + ci
            a = int(node_ids[r, p])
            pos = ci == 0
            ok = (labels[gi, ci] == 1.0) == pos and (
                a in parents if pos else a not in masked)
            gps = graph.pars(a)[:p]
            kids = graph.kids(a)
            if pos:
                kids = kids[kids != q]
            ok = ok and int(ngp[r]) == len(gps) and int(nsib[r]) == len(kids)
            ok = ok and sorted(node_ids[r, :len(gps)].tolist()) == sorted(
                gps.tolist())
            ok = ok and sorted(node_ids[r, p + 1:p + 1 + len(kids)].tolist()
                               ) == sorted(kids.tolist())
            bad += not ok
    return bad
