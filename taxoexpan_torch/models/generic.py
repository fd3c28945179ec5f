"""Generic sparse-path model forward (port of
`taxoexpan_tpu/models/generic.py`): the same PGAT / PGCN math over flat
(src, dst, mask) edge arrays and the segment operations of ops/segment.py
instead of the star closed form.

It serves as the cross-check of the star path (the star form is
specialised; this path works for any batched graph) and as the
gather/scatter formulation a benchmark can hold the kernels against. It is
plain PyTorch, eval form (no dropout), and shares its parameters with the
star-path model, so both are comparable layer by layer. The position
embeddings are concatenated to each layer's input (pos_mode "concat"),
which equals the star path's position-bias split when nothing is dropped.
Residual GAT layers are not modelled here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.egobatch import EgoBatch, ego_batch_edges
from ..ops import segment
from ..ops import star as star_ops
from .propagation import GAT, HIDDEN_ALPHA, star_slot_positions


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def flat_edges(ego: EgoBatch, max_parents: int, expand_factor: int,
               device=None):
    """(src, dst, edge_mask) tensors of the flattened [B*N] node space
    (data/egobatch.py:ego_batch_edges: gp -> anchor, anchor -> sib,
    self-loops)."""
    host = EgoBatch(node_ids=_numpy(ego.node_ids), ngp=_numpy(ego.ngp),
                    nsib=_numpy(ego.nsib))
    return tuple(torch.from_numpy(a).to(device) for a in
                 ego_batch_edges(host, max_parents, expand_factor))


def _leaky(v: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(v >= 0, v, alpha * v)


def gat_layer_segment(params: dict, h: torch.Tensor, src, dst, edge_mask,
                      num_nodes: int, *, num_heads: int,
                      leaky_alpha: float = 0.2) -> torch.Tensor:
    """GATLayer over flat edges: SDDMM -> edge_softmax -> SpMM
    (model_zoo.py:80-114). h [V, Din] -> [V, H, Dh]."""
    ft = (h @ params["fc"]).reshape(num_nodes, num_heads, -1)
    a1 = (ft * params["attn_l"]).sum(-1)
    a2 = (ft * params["attn_r"]).sum(-1)
    logits = _leaky(segment.sddmm(a1, a2, src, dst), leaky_alpha)
    attn = segment.edge_softmax(logits, dst, num_nodes, edge_mask)
    return segment.spmm(ft, src, dst, num_nodes, edge_weight=attn[..., None],
                        mask=edge_mask)


def gcn_layer_segment(params: dict, h: torch.Tensor, norm: torch.Tensor,
                      src, dst, edge_mask, num_nodes: int, *,
                      alpha) -> torch.Tensor:
    """GCNLayer over flat edges (model_zoo.py:34-50): norm at the source,
    copy_src + sum, norm at the destination, bias, leaky_relu(alpha)."""
    h = (h @ params["w"]) * norm
    h = segment.spmm(h, src, dst, num_nodes, mask=edge_mask) * norm
    h = h + params["b"]
    return h if alpha is None else _leaky(h, alpha)


def encode_segment(model, params: dict, feats_flat: torch.Tensor, src, dst,
                   edge_mask, node_mask, graph_ids, num_graphs: int,
                   slot_pos_flat) -> torch.Tensor:
    """propagate + readout over flat arrays; mirrors TaxoExpan.encode
    without the raw channel."""
    prop = model.propagate
    p = params["propagate"]
    num_nodes = feats_flat.shape[0]
    h = feats_flat

    def with_pos(x, i):
        if not prop.pos_dim:
            return x
        return torch.cat([x, p["pos_emb"][i]["emb"][slot_pos_flat]], dim=-1)

    if isinstance(prop, GAT):
        if any(prop.residual_layers):
            raise ValueError("the generic path has no residual GAT layers")
        for l in range(prop.num_layers):
            h = gat_layer_segment(p["layers"][l], with_pos(h, l), src, dst,
                                  edge_mask, num_nodes,
                                  num_heads=prop.layer_specs[l][2])
            h = _leaky(h.reshape(num_nodes, -1), HIDDEN_ALPHA)
        h = gat_layer_segment(p["layers"][-1], with_pos(h, prop.num_layers),
                              src, dst, edge_mask, num_nodes,
                              num_heads=prop.layer_specs[-1][2]).mean(dim=1)
    else:
        deg = segment.in_degrees(dst, num_nodes, edge_mask)
        norm = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-12)),
                           torch.zeros_like(deg))[:, None]
        for i, (_din, _dout, alpha, _rate) in enumerate(prop.layer_specs):
            h = gcn_layer_segment(p["layers"][i], with_pos(h, i), norm, src,
                                  dst, edge_mask, num_nodes, alpha=alpha)

    kind = model.readout.kind
    if kind in ("MR", "SUM"):
        return segment.segment_readout(h, graph_ids, num_graphs,
                                       node_mask=node_mask,
                                       op="mean" if kind == "MR" else "sum")
    if kind == "WMR":
        w = torch.nn.functional.softplus(params["readout"]["emb"])[:, 0]
        return segment.segment_readout(h, graph_ids, num_graphs,
                                       node_mask=node_mask,
                                       weight=w[slot_pos_flat][:, None])
    if kind == "CR":
        ones = torch.ones(h.shape[:1], dtype=h.dtype, device=h.device)
        counts = segment.masked_segment_sum(ones, graph_ids, num_graphs,
                                            node_mask).clamp(min=1.0)
        return torch.cat([segment.segment_readout(
            h, graph_ids, num_graphs, node_mask=node_mask &
            (slot_pos_flat == c), op="sum") / counts[:, None]
            for c in range(3)], dim=1)
    raise ValueError(f"unsupported readout {kind!r}")


def forward_generic(model, params: dict, batch,
                    feature_table: torch.Tensor) -> torch.Tensor:
    """Scores [G, C] of a GroupBatch through the generic path, eval form;
    the counterpart of TaxoExpan.forward(train=False)."""
    dev = feature_table.device
    g, c = batch.labels.shape
    ego = batch.ego
    b, n = ego.node_ids.shape
    src, dst, edge_mask = flat_edges(ego, model.max_parents,
                                     model.expand_factor, dev)
    ngp, nsib = (torch.as_tensor(_numpy(a), device=dev)
                 for a in (ego.ngp, ego.nsib))
    mask = star_ops.node_mask(ngp, nsib, model.max_parents, n)
    ids = torch.as_tensor(_numpy(ego.node_ids), device=dev).long()
    feats = feature_table[ids] * mask[..., None].to(feature_table.dtype)
    slot_pos = torch.as_tensor(
        np.tile(star_slot_positions(model.max_parents, n), b), device=dev)
    graph_ids = torch.arange(b, device=dev).repeat_interleave(n)
    hg = encode_segment(model, params, feats.reshape(b * n, -1), src, dst,
                        edge_mask, mask.reshape(-1), graph_ids, b, slot_pos)
    qf = (torch.as_tensor(_numpy(batch.query_feats), device=dev)
          if batch.query_feats is not None
          else feature_table[torch.as_tensor(_numpy(batch.query_ids),
                                             device=dev).long()])
    scores = model.match(params, hg, qf.repeat_interleave(c, dim=0))
    return scores.reshape(g, c)
