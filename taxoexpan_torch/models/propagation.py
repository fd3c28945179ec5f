"""PGAT / GAT graph propagation (port of the GAT parts of
`taxoexpan_tpu/models/propagation.py`, :206-333 and :509-573).

Every layer runs through the star-GAT kernels of `ops/gat_kernels.py`:
hidden layers with the stack's leaky_relu (slope 0.01) fused in, the final
layer in its pooled form, which emits the readout class pools
[B, 3, out_dim]. Parameters keep the JAX layout: `fc` is [in, H*Dh] with
head-major columns and, for PGAT, the position embedding rows as its tail
rows `fc[din_h:]`; `attn_l`/`attn_r` are [H, Dh].

Position bias (pos_mode="bias"): [h, pe] @ W = h @ W_h + pe @ W_p. Without
input dropout the pe term is a per-slot constant and enters the kernels as
slot biases bias_ft [N, H*Dh] and bias_a1/bias_a2 [N, H]. In train mode
with feat_drop > 0 the reference drops the concatenated input, pe columns
included, so the layer gets the raw pe rows and W_p tail rows instead
(`pe_pack`) and the kernel masks them per node (propagation.py:274-279).

Eval (no autograd) calls the forward wrappers; train mode, or any call
under autograd, the differentiable layers (`gat_layer`, whose backward is
K2 / K4), with one seed per layer drawn from the caller's torch.Generator.
Layer 0's input is the fixed feature tensor: its dx is never computed.
The grads of pos_emb, the fc tail rows and attn_l / attn_r flow through
the slicing and the einsum fold outside the kernels, by autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.gat_kernels import (gat_layer, gat_layer_fwd, gat_layer_pooled,
                               gat_layer_pooled_fwd)
from .init import embedding_params, xavier_normal

HIDDEN_ALPHA = 0.01   # the stack's F.leaky_relu between layers; the
                      # attention logits use 0.2 (ops/gat_kernels.py)


def star_slot_positions(p_slots: int, n: int) -> np.ndarray:
    """Static per-slot position codes (0 gp / 1 anchor / 2 sibling)."""
    pos = np.full((n,), 2, dtype=np.int64)
    pos[:p_slots] = 0
    pos[p_slots] = 1
    return pos


def init_gat_layer(gen: torch.Generator, in_dim: int, out_dim: int,
                   num_heads: int) -> dict:
    """xavier_normal(gain=1.414) for fc / attn_l / attn_r."""
    return {
        "fc": xavier_normal(gen, (in_dim, num_heads * out_dim),
                            fan_in=in_dim, fan_out=num_heads * out_dim),
        # torch shape (1, H, D'): fan_in = H*D', fan_out = D'
        "attn_l": xavier_normal(gen, (num_heads, out_dim),
                                fan_in=num_heads * out_dim, fan_out=out_dim),
        "attn_r": xavier_normal(gen, (num_heads, out_dim),
                                fan_in=num_heads * out_dim, fan_out=out_dim),
    }


def layer_operands(lp: dict, pe: torch.Tensor | None, num_heads: int,
                   din_h: int, n: int, pe_dropout: bool = False):
    """Kernel operands of one layer: ((fc_h, wa1, wa2, bias_ft, bias_a1,
    bias_a2), pe_pack), all contiguous float32.

    wa = einsum("ihd,hd->ih", fc, attn) folds the attention dot products
    into [in, H] so a1/a2 come from the same x as ft; with a position
    embedding `pe` [N, pos_dim] the tail rows of fc and wa become slot
    biases, or, with `pe_dropout`, pe_pack = (pe, fc[din_h:], wa1[din_h:],
    wa2[din_h:]) beside zero biases."""
    fc_full = lp["fc"]
    dh = fc_full.shape[1] // num_heads
    w_heads = fc_full.reshape(-1, num_heads, dh)
    wa1_full = torch.einsum("ihd,hd->ih", w_heads, lp["attn_l"])
    wa2_full = torch.einsum("ihd,hd->ih", w_heads, lp["attn_r"])
    pe_pack = None
    if pe is not None and pe_dropout:
        pe_pack = tuple(t.contiguous() for t in (
            pe, fc_full[din_h:], wa1_full[din_h:], wa2_full[din_h:]))
        pe = None
    if pe is not None:
        bias_ft = pe @ fc_full[din_h:]
        bias_a1 = pe @ wa1_full[din_h:]
        bias_a2 = pe @ wa2_full[din_h:]
    else:
        zeros = fc_full.new_zeros
        bias_ft = zeros((n, fc_full.shape[1]))
        bias_a1 = zeros((n, num_heads))
        bias_a2 = zeros((n, num_heads))
    return tuple(t.contiguous() for t in (
        fc_full[:din_h], wa1_full[:din_h], wa2_full[:din_h], bias_ft,
        bias_a1, bias_a2)), pe_pack


class GAT:
    """GAT stack; PGAT when pos_dim > 0 (the paper's main model)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, heads, pos_dim: int = 0,
                 position_vocab_size: int = 3, feat_drop: float = 0.0,
                 attn_drop: float = 0.0):
        if len(heads) != num_layers + 1:
            raise ValueError(
                f"heads must have num_layers+1 entries, got {heads} for "
                f"num_layers={num_layers}")
        self.num_layers = num_layers
        self.heads = list(heads)
        self.pos_dim = pos_dim
        self.position_vocab_size = position_vocab_size
        self.out_dim = out_dim
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        specs = [(in_dim + pos_dim, hidden_dim, heads[0])]
        for l in range(1, num_layers):
            specs.append((hidden_dim * heads[l - 1] + pos_dim, hidden_dim,
                          heads[l]))
        specs.append((hidden_dim * heads[-2] + pos_dim, out_dim, heads[-1]))
        self.layer_specs = specs

    def init(self, gen: torch.Generator) -> dict:
        params = {"layers": [], "pos_emb": []}
        for din, dout, nh in self.layer_specs:
            params["layers"].append(init_gat_layer(gen, din, dout, nh))
            if self.pos_dim:
                params["pos_emb"].append(embedding_params(
                    gen, self.position_vocab_size, self.pos_dim))
        return params

    def operands(self, params: dict, l: int, n: int, p_slots: int,
                 pe_dropout: bool = False) -> tuple:
        """Kernel operands of layer `l` for egonets of `n` slots: (ops,
        pe_pack), see `layer_operands`."""
        fc = params["layers"][l]["fc"]
        pe = None
        if self.pos_dim:
            slot_pos = torch.as_tensor(star_slot_positions(p_slots, n),
                                       device=fc.device)
            pe = params["pos_emb"][l]["emb"][slot_pos]        # [N, pos_dim]
        return layer_operands(params["layers"][l], pe, self.layer_specs[l][2],
                              fc.shape[0] - self.pos_dim, n,
                              pe_dropout=pe_dropout)

    def apply(self, params: dict, h: torch.Tensor, ngp: torch.Tensor,
              nsib: torch.Tensor, p_slots: int, *,
              gen: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        """Egonet features [B, N, in_dim] -> readout class pools
        [B, 3, out_dim] (grandparents, anchor, siblings; head-averaged).
        train=True turns dropout on, one seed per layer from `gen`."""
        n = h.shape[1]
        feat_drop = self.feat_drop if train else 0.0
        attn_drop = self.attn_drop if train else 0.0
        differentiable = train or torch.is_grad_enabled()
        last = self.num_layers
        for l in range(last + 1):
            heads = self.layer_specs[l][2]
            ops, pe_pack = self.operands(params, l, n, p_slots,
                                         pe_dropout=feat_drop > 0)
            if not differentiable:
                if l < last:   # flat [B, N, H*Dh] = the flatten-heads step
                    h = gat_layer_fwd(h, *ops, ngp, nsib, p_slots, heads,
                                      out_alpha=HIDDEN_ALPHA)
                else:
                    h = gat_layer_pooled_fwd(h, *ops, ngp, nsib, p_slots,
                                             heads)
                continue
            seed = 0
            if train:
                seed = int(torch.randint(0, 2_147_483_647, (1,),
                                         generator=gen))
            kw = dict(pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
                      attn_drop=attn_drop, need_dx=l > 0)
            if l < last:
                h = gat_layer(h, *ops, ngp, nsib, p_slots, heads,
                              out_alpha=HIDDEN_ALPHA, **kw)
            else:
                h = gat_layer_pooled(h, *ops, ngp, nsib, p_slots, heads, **kw)
        return h
