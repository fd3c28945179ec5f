"""Operations and bytes of the model's work, counted from its shapes and
from the valid rows of its inputs, as the mathematics needs them and
whatever implements them (the yardstick of the roofline and mfu metrics).

Star egonets of N slots: R = the valid slots (grandparents, the anchor,
siblings) summed over the egonets, E = the edges between distinct slots
(gp -> anchor, anchor -> sibling). A product counts 2 operations a
multiply-add; each input byte is read once and each output byte written
once (float32, 4 bytes); rows that no valid output needs are not counted.

- GAT layer, K input columns with the pe columns, H heads of Dh:
  forward 2 R K H Dh (projection) + 4 R H Dh (the attention logits) +
  2 (R + E) H Dh (the weighted sums over the in-edges, self-loops
  included); backward 2 R K H Dh (dW) + 2 R Din H Dh when the input's grad
  is needed + twice the forward's star work.
- GCN layer, K -> Dout: forward 2 R K Dout + 2 (R + E) Dout + 2 R Dout
  (the two normalisations); backward dW, dx as GAT's, twice the star work.
- BIM matcher: hg @ W once a parameter set (2 C l r) and the products
  with the queries (2 Q C r); in training 2 G C l r + 2 G C r forward, and
  twice that backward.
"""
from __future__ import annotations

import numpy as np

from .frozen import roofline
from .weights import layer_shapes

F32 = 4


def rows_edges(ngp, nsib, mask=None) -> tuple[float, float, int]:
    """(R, E, egonets) of host arrays, over the egonets `mask` keeps."""
    ngp = np.asarray(ngp, dtype=np.int64)
    nsib = np.asarray(nsib, dtype=np.int64)
    if mask is not None:
        keep = np.asarray(mask, dtype=bool).reshape(-1)
        ngp, nsib = ngp[keep], nsib[keep]
    return (float((ngp + 1 + nsib).sum()), float((ngp + nsib).sum()),
            int(ngp.shape[0]))


def propagation(arch: dict, r: float, e: float, b: int, *, n: int,
                backward: bool, train: bool = True) -> tuple[float, float]:
    """(operations, bytes) of one pass of every propagation layer over
    egonets of N slots with R valid rows and E edges; `backward` counts the
    backward pass alone. Without dropout (`train` off) the pe columns are
    the same for every egonet, so their product is taken once a slot."""
    a = arch["args"]
    gat = a["propagation_method"] in ("GAT", "PGAT")
    pos = a.get("pos_dim", 0)
    specs = layer_shapes(arch)
    ops = nbytes = 0.0
    for l, (k, dout, heads) in enumerate(specs):
        final = l == len(specs) - 1
        din = k - pos
        width = heads * dout
        star = (4 * r * width + 2 * (r + e) * width) if gat else \
            (2 * (r + e) * dout + 2 * r * dout)
        w_bytes = k * (width + (2 * heads if gat else 0)) * F32 \
            + (0 if gat else dout * F32)
        # the final layer writes what the readout needs: the three class
        # pools of each egonet
        out_bytes = (b * 3 * dout if final else r * width) * F32
        in_bytes = r * din * F32 + n * pos * F32 + 2 * b * 4
        if not backward:
            pe_rows = r if train else n
            ops += 2 * r * din * width + 2 * pe_rows * pos * width + star
            nbytes += in_bytes + w_bytes + out_bytes
        else:
            need_dx = l > 0
            ops += 2 * r * k * width + (2 * r * din * width if need_dx
                                        else 0) + 2 * star
            # reads the output's grad, the input and the weights; writes
            # the weights' grads and the input's grad
            nbytes += out_bytes + in_bytes + 2 * w_bytes + (
                r * din * F32 if need_dx else 0)
    return ops, nbytes


def propagation_bound_ms(arch: dict, r: float, e: float, b: int, *, n: int,
                         backward: bool, train: bool = True) -> float:
    ops, nbytes = propagation(arch, r, e, b, n=n, backward=backward,
                              train=train)
    return roofline.bound(nbytes, ops, tensor_cores=True)["bound_ms"]


def train_step_ops(arch: dict, r: float, e: float, pairs: int) -> float:
    """Operations of one train step over `pairs` (query, candidate) pairs
    whose egonets hold R valid rows and E edges: the propagation forward
    and backward, the readout and the matcher forward and backward."""
    a = arch["args"]
    fwd, _ = propagation(arch, r, e, pairs, n=0, backward=False)
    bwd, _ = propagation(arch, r, e, pairs, n=0, backward=True)
    lr = 2 * pairs * a["out_dim"] * a["in_dim"] + 2 * pairs * a["in_dim"]
    readout = 2 * r * a["out_dim"]
    return fwd + bwd + 3 * (lr + readout)


def encode_ops(arch: dict, r: float, e: float, b: int) -> float:
    """Operations of an eval encode of egonets (R, E, B)."""
    a = arch["args"]
    ops, _ = propagation(arch, r, e, b, n=0, backward=False, train=False)
    return ops + 2 * r * a["out_dim"]


def match_ops(arch: dict, candidates: int, queries: int,
              param_sets: int) -> float:
    """Operations of scoring `queries` against every candidate, hg @ W
    counted once a parameter set."""
    a = arch["args"]
    return (2.0 * param_sets * candidates * a["out_dim"] * a["in_dim"]
            + 2.0 * queries * candidates * a["in_dim"])


def mfu_pct(ops: float, seconds: float) -> float | None:
    if seconds <= 0 or ops <= 0:
        return None
    return 100.0 * ops / seconds / roofline.PEAK_3XTF32_FLOP_PER_S
