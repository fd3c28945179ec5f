"""Closed-form dense message passing over batched star egonets (torch).

Port of `taxoexpan_tpu/ops/star.py`. Every egonet is a depth-1 star with
self-loops over the fixed slot layout [0,P) grandparents | P anchor | (P,N)
siblings, so the incoming-edge set of each node is known in closed form:

    gp_i    <- {gp_i}
    anchor  <- {anchor} ∪ {gp_i : i < ngp}
    sib_j   <- {sib_j, anchor}

and SDDMM, edge softmax and SpMM collapse into dense masked reductions over
[B, N, ...] tensors. These functions are also the building blocks of the
plain versions that the CUDA kernels of `ops/gat_kernels.py` and
`ops/gcn_kernels.py` are held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gp_mask(ngp: torch.Tensor, p: int) -> torch.Tensor:
    """[B, P] True where a grandparent slot is valid."""
    return torch.arange(p, device=ngp.device)[None, :] < ngp[:, None]


def _sib_mask(nsib: torch.Tensor, s: int) -> torch.Tensor:
    return torch.arange(s, device=nsib.device)[None, :] < nsib[:, None]


def node_mask(ngp: torch.Tensor, nsib: torch.Tensor, p: int,
              n: int) -> torch.Tensor:
    """[B, N] validity mask over all slots."""
    anchor = torch.ones((ngp.shape[0], 1), dtype=torch.bool,
                        device=ngp.device)
    return torch.cat([_gp_mask(ngp, p), anchor, _sib_mask(nsib, n - p - 1)],
                     dim=1)


def in_degrees(ngp: torch.Tensor, nsib: torch.Tensor, p: int,
               n: int) -> torch.Tensor:
    """[B, N] float32 in-degree, self-loops included: gp 1, anchor 1 + ngp,
    sib 2; 0 on invalid slots."""
    b = ngp.shape[0]
    deg = torch.cat([torch.ones((b, p), device=ngp.device),
                     (1.0 + ngp.to(torch.float32))[:, None],
                     torch.full((b, n - p - 1), 2.0, device=ngp.device)],
                    dim=1)
    return deg * node_mask(ngp, nsib, p, n)


def gcn_norm(ngp: torch.Tensor, nsib: torch.Tensor, p: int,
             n: int) -> torch.Tensor:
    """[B, N, 1] rsqrt(in-degree), 0 where the degree is 0 (invalid
    slots): the GCN layer's normalisation at both ends of an edge."""
    deg = in_degrees(ngp, nsib, p, n)
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-12)),
                       torch.zeros_like(deg))[..., None]


def copy_src_sum(x: torch.Tensor, ngp: torch.Tensor, nsib: torch.Tensor,
                 p: int) -> torch.Tensor:
    """out[d] = sum over the in-edges (s, d) of x[s], the star SpMM; x
    [B, N, D]. Invalid grandparents send nothing; invalid destinations
    keep their formula value (callers mask them if needed)."""
    gp = x[:, :p]
    anchor = x[:, p]
    gp_valid = gp * _gp_mask(ngp, p)[..., None].to(x.dtype)
    return torch.cat([gp, (anchor + gp_valid.sum(dim=1))[:, None],
                      x[:, p + 1:] + anchor[:, None]], dim=1)


def _leaky(v: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(v >= 0, v, alpha * v)


def gat_attention_aggregate(ft: torch.Tensor, a1: torch.Tensor,
                            a2: torch.Tensor, ngp: torch.Tensor,
                            nsib: torch.Tensor, p: int,
                            leaky_alpha: float = 0.2,
                            mask_output: bool = True) -> torch.Tensor:
    """SDDMM + edge softmax + SpMM for multi-head GAT on the star, eval form
    (no attention dropout).

    Per destination: softmax over its in-edges of
    leaky_relu(a1[src] + a2[dst]), then the weighted sum of source features.
    ft: [B, N, H, Dh], a1/a2: [B, N, H]. Returns [B, N, H, Dh].
    """
    b, n, h = a1.shape
    # anchor destination: sources = grandparents + self
    logits_gp = _leaky(a1[:, :p] + a2[:, p][:, None, :], leaky_alpha)
    logit_self = _leaky(a1[:, p] + a2[:, p], leaky_alpha)[:, None, :]
    logits_anchor = torch.cat([logits_gp, logit_self], dim=1)   # [B, P+1, H]
    src_valid = torch.cat(
        [_gp_mask(ngp, p),
         torch.ones((b, 1), dtype=torch.bool, device=ngp.device)], dim=1)
    logits_anchor = torch.where(src_valid[..., None], logits_anchor,
                                torch.full_like(logits_anchor, NEG_INF))
    attn_anchor = torch.softmax(logits_anchor, dim=1)

    # sibling destinations: sources = (anchor, self)
    logits_from_anchor = _leaky(a1[:, p][:, None, :] + a2[:, p + 1:],
                                leaky_alpha)
    logits_sib_self = _leaky(a1[:, p + 1:] + a2[:, p + 1:], leaky_alpha)
    attn_sib = torch.softmax(
        torch.stack([logits_from_anchor, logits_sib_self], dim=2), dim=2)

    attn_anchor = attn_anchor.to(ft.dtype)
    attn_sib = attn_sib.to(ft.dtype)
    out_anchor = (torch.einsum("bph,bphd->bhd", attn_anchor[:, :p],
                               ft[:, :p]) +
                  attn_anchor[:, p][..., None] * ft[:, p])
    out_sib = (attn_sib[:, :, 0, :, None] * ft[:, p][:, None] +
               attn_sib[:, :, 1, :, None] * ft[:, p + 1:])
    # grandparent destinations: self-loop only, attention 1
    out = torch.cat([ft[:, :p], out_anchor[:, None], out_sib], dim=1)
    if mask_output:
        out = out * node_mask(ngp, nsib, p, n)[..., None, None]
    return out


def readout(h: torch.Tensor, ngp: torch.Tensor, nsib: torch.Tensor, p: int,
            kind: str = "MR",
            position_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-egonet pooling over valid slots; h: [B, N, D] -> [B, D'].

    DGL readout semantics: weighted features are summed, then divided by the
    node count of each graph (MR mean, WMR softplus position weights, CR
    concat of per-class sums, SUM plain sum); MAX is the largest value of
    each feature over the valid slots."""
    b, n, _ = h.shape
    mask = node_mask(ngp, nsib, p, n)[..., None].to(h.dtype)
    counts = (ngp + 1 + nsib).to(h.dtype)[:, None]
    hm = h * mask
    if kind == "MR":
        return hm.sum(dim=1) / counts
    if kind == "WMR":
        if position_weights is None:
            raise ValueError("WMR needs position_weights [3, 1]")
        w = torch.nn.functional.softplus(position_weights)[:, 0]    # [3]
        slot_w = torch.cat([w[0].expand(p), w[1][None],
                            w[2].expand(n - p - 1)])
        return (hm * slot_w[None, :, None]).sum(dim=1) / counts
    if kind == "CR":
        return torch.cat([hm[:, :p].sum(dim=1), hm[:, p],
                          hm[:, p + 1:].sum(dim=1)], dim=1) / counts
    if kind == "SUM":
        return hm.sum(dim=1)
    if kind == "MAX":
        # amax splits the gradient among tied maxima, as jnp.max does
        return torch.where(mask.bool(), h,
                           torch.full_like(h, NEG_INF)).amax(dim=1)
    raise ValueError(f"unsupported readout kind {kind!r}")


def readout_attention(h: torch.Tensor, ngp: torch.Tensor, nsib: torch.Tensor,
                      p: int, gate_params: dict) -> torch.Tensor:
    """PATR, the position-aware attention readout, h [B, N, D] -> [B, D]:

        z_i = w2 . tanh(h_i @ w1 + b1 + class_emb[class(i)])
        out = sum_i softmax over the valid slots(z)_i * h_i

    with class 0 for grandparent slots, 1 for the anchor, 2 for siblings
    (port of taxoexpan_tpu/ops/star.py:readout_attention)."""
    b, n, _ = h.shape
    slot_class = torch.full((n,), 2, dtype=torch.long, device=h.device)
    slot_class[:p] = 0
    slot_class[p] = 1
    gate_in = torch.tanh(h @ gate_params["w1"] + gate_params["b1"]
                         + gate_params["class_emb"][slot_class][None])
    logits = (gate_in @ gate_params["w2"])[..., 0]                  # [B, N]
    valid = node_mask(ngp, nsib, p, n)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=1)
    return torch.einsum("bn,bnd->bd", attn, h)


def readout_from_pools(pools: torch.Tensor, ngp: torch.Tensor,
                       nsib: torch.Tensor, kind: str = "MR",
                       position_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Readout from per-position-class pooled sums [B, 3, D] (grandparents,
    anchor, siblings; validity-masked and head-averaged): the output of the
    pooled final-layer kernel. Same results as `readout` on the per-slot
    tensor."""
    counts = (ngp + 1 + nsib).to(pools.dtype)[:, None]
    if kind == "MR":
        return pools.sum(dim=1) / counts
    if kind == "WMR":
        if position_weights is None:
            raise ValueError("WMR needs position_weights [3, 1]")
        w = torch.nn.functional.softplus(position_weights)[:, 0]
        return torch.einsum("bcd,c->bd", pools, w) / counts
    if kind == "CR":
        return torch.cat([pools[:, 0], pools[:, 1], pools[:, 2]],
                         dim=1) / counts
    if kind == "SUM":
        return pools.sum(dim=1)
    raise ValueError(f"unsupported pooled readout kind {kind!r}")


def raw_star_channel(feats: torch.Tensor, ngp: torch.Tensor,
                     nsib: torch.Tensor, p: int) -> torch.Tensor:
    """Unit-normalised mean of the anchor + sibling slots; [B, N, D] -> [B, D].

    The raw-feature channel of the composite model (`raw_channel=True`):
    within one query's ranking, the `simple_structure sum/b0.0` heuristic's
    score is a dot product against this vector. Computed in f32."""
    b, n, _ = feats.shape
    x = feats.to(torch.float32)
    unit = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)
    smask = _sib_mask(nsib, n - p - 1).to(torch.float32)
    total = unit[:, p] + (unit[:, p + 1:] * smask[..., None]).sum(dim=1)
    counts = (1.0 + nsib.to(torch.float32))[:, None]
    return total / counts
