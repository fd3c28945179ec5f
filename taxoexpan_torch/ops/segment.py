"""Generic sparse graph operations over flat (src, dst, mask) edge arrays
(port of `taxoexpan_tpu/ops/segment.py`), in plain PyTorch: index_add_ and
scatter_reduce over the flattened [B*N] node space.

The DGL primitives the reference delegates to: SpMM (update_all with
copy_src / src_mul_edge and sum), SDDMM (apply_edges), edge_softmax,
in_degrees and the segment readouts. This is the general path and the
cross-check of the star closed form (ops/star.py), which computes the same
values with no gathers or scatters; it runs no kernel of its own.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast an [E] mask against [E, ...] data."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of the rows of `data` [E, ...] per segment, masked rows as 0."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data, torch.zeros_like(data))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def masked_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Max per segment, masked rows as NEG_INF; a segment with no row gives
    -inf (jax.ops.segment_max's value)."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data,
                           torch.full_like(data, NEG_INF))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    index = _expand(segment_ids.long(), data).expand_as(data)
    return out.scatter_reduce(0, index, data, reduce="amax",
                              include_self=True)


def in_degrees(dst: torch.Tensor, num_nodes: int,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-node in-degree from a (masked) edge list; g.in_degrees()."""
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    return masked_segment_sum(ones, dst, num_nodes, mask)


def sddmm(a_src: torch.Tensor, a_dst: torch.Tensor, src: torch.Tensor,
          dst: torch.Tensor) -> torch.Tensor:
    """Per-edge a_src[src] + a_dst[dst] (the gather half of GAT attention;
    the caller applies the nonlinearity)."""
    return a_src[src.long()] + a_dst[dst.long()]


def edge_softmax(logits: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax over each destination's incoming edges (dgl edge_softmax);
    logits [E, ...], masked edges get weight 0."""
    dst = dst.long()
    seg_max = masked_segment_max(logits, dst, num_nodes, mask)
    seg_max = torch.where(seg_max <= NEG_INF / 2, torch.zeros_like(seg_max),
                          seg_max)             # segments with no valid edge
    e = torch.exp(logits - seg_max[dst])
    if mask is not None:
        e = torch.where(_expand(mask, e), e, torch.zeros_like(e))
    denom = masked_segment_sum(e, dst, num_nodes)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return e / denom[dst]


def spmm(h_src: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
         num_nodes: int, edge_weight: torch.Tensor | None = None,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """out[d] = sum over the edges (s, d) of w_e * h[s] (update_all with
    copy_src, or src_mul_edge, and sum)."""
    msgs = h_src[src.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight
    return masked_segment_sum(msgs, dst, num_nodes, mask)


def segment_readout(h: torch.Tensor, graph_ids: torch.Tensor,
                    num_graphs: int, node_mask: torch.Tensor | None = None,
                    weight: torch.Tensor | None = None,
                    op: str = "mean") -> torch.Tensor:
    """Per-graph readout over a flat node array, DGL semantics: "sum" of
    w_i h_i, "mean" = that sum over the node COUNT (dgl.mean_nodes with a
    weight, as WMR/CR use it), "max" (weight ignored)."""
    if op == "max":
        return masked_segment_max(h, graph_ids, num_graphs, node_mask)
    hw = h if weight is None else h * weight
    total = masked_segment_sum(hw, graph_ids, num_graphs, node_mask)
    if op == "sum":
        return total
    if op == "mean":
        ones = torch.ones(h.shape[:1], dtype=h.dtype, device=h.device)
        counts = masked_segment_sum(ones, graph_ids, num_graphs, node_mask)
        return total / counts.clamp(min=1.0)[:, None]
    raise ValueError(f"unknown readout op {op!r}")
