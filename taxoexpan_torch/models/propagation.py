"""Graph propagation: the PGAT / GAT and PGCN / GCN stacks (port of
`taxoexpan_tpu/models/propagation.py`: GAT :206-333 and :509-573, GCN
:40-86 and :338-449).

Every layer runs through the star kernels: the GAT layers through
`ops/gat_kernels.py` (hidden layers with the stack's leaky_relu, slope
0.01, fused in; the final layer in its pooled form, which emits the readout
class pools [B, 3, out_dim], or per slot, [B, N, out_dim] after the mean
over heads, for the readouts that are no linear pool), the GCN layers
through `ops/gcn_kernels.py` (hidden layers with leaky_relu 0.01 fused in;
the final layer per slot, [B, N, out_dim], with no activation).
Parameters keep the JAX layout: GAT's
`fc` is [in, H*Dh] with head-major columns, `attn_l`/`attn_r` [H, Dh];
GCN's `w` is [in, out] and `b` [out]; with positions the embedding rows of
the weight are its tail rows `[din_h:]`.

Position bias (pos_mode="bias"): [h, pe] @ W = h @ W_h + pe @ W_p. Without
input dropout the pe term is a per-slot constant and enters the kernels as
slot biases (GAT: bias_ft [N, H*Dh], bias_a1/bias_a2 [N, H]; GCN: z_bias
[N, out]). In train mode with input dropout the reference drops the
concatenated input, pe columns included, so the layer gets the raw pe rows
and the W_p tail rows instead (`pe_pack`) and the kernel masks them per
node (propagation.py:274-279, :430-435).

Eval (no autograd) calls the forward wrappers; train mode, or any call
under autograd, the differentiable layers (`gat_layer`, `gcn_layer`), with
one seed per layer drawn from the caller's torch.Generator. Layer 0's input
is the fixed feature tensor: its dx is never computed. The grads of the
pos_emb rows, the weights' tail rows and attn_l / attn_r flow through the
slicing and the einsum fold outside the kernels, by autograd.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.gat_kernels import (gat_layer, gat_layer_fwd, gat_layer_pooled,
                               gat_layer_pooled_fwd)
from ..ops.gcn_kernels import gcn_layer, gcn_layer_fwd
from .init import embedding_params, uniform, xavier_normal

HIDDEN_ALPHA = 0.01   # the stack's F.leaky_relu between layers; the
                      # attention logits use 0.2 (ops/gat_kernels.py)


def star_slot_positions(p_slots: int, n: int) -> np.ndarray:
    """Static per-slot position codes (0 gp / 1 anchor / 2 sibling)."""
    pos = np.full((n,), 2, dtype=np.int64)
    pos[:p_slots] = 0
    pos[p_slots] = 1
    return pos


def slot_embeddings(emb: torch.Tensor, p_slots: int, n: int) -> torch.Tensor:
    """The position embedding row of every slot: emb [3, pos] -> [N, pos]."""
    return emb[torch.as_tensor(star_slot_positions(p_slots, n),
                               device=emb.device)]


def _layer_seed(gen: torch.Generator | None, train: bool) -> int:
    if not train:
        return 0
    return int(torch.randint(0, 2_147_483_647, (1,), generator=gen))


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
            pe = slot_embeddings(params["pos_emb"][l]["emb"], p_slots, n)
        return layer_operands(params["layers"][l], pe, self.layer_specs[l][2],
                              fc.shape[0] - self.pos_dim, n,
                              pe_dropout=pe_dropout)

    def apply(self, params: dict, h: torch.Tensor, ngp: torch.Tensor,
              nsib: torch.Tensor, p_slots: int, *,
              gen: torch.Generator | None = None, train: bool = False,
              pool_readout: bool = True) -> torch.Tensor:
        """Egonet features [B, N, in_dim] -> readout class pools
        [B, 3, out_dim] (grandparents, anchor, siblings; head-averaged) or,
        with pool_readout=False, the per-slot activation [B, N, out_dim]
        (the mean over heads of the final layer, which has no activation;
        invalid slots keep their formula value, the readouts mask them).
        train=True turns dropout on, one seed per layer from `gen`."""
        b, n = h.shape[:2]
        feat_drop = self.feat_drop if train else 0.0
        attn_drop = self.attn_drop if train else 0.0
        differentiable = train or torch.is_grad_enabled()
        last = self.num_layers
        for l in range(last + 1):
            heads = self.layer_specs[l][2]
            ops, pe_pack = self.operands(params, l, n, p_slots,
                                         pe_dropout=feat_drop > 0)
            pooled = l == last and pool_readout
            # hidden layers: flat [B, N, H*Dh] = the flatten-heads step
            out_alpha = HIDDEN_ALPHA if l < last else None
            if not differentiable:
                if pooled:
                    h = gat_layer_pooled_fwd(h, *ops, ngp, nsib, p_slots,
                                             heads)
                else:
                    h = gat_layer_fwd(h, *ops, ngp, nsib, p_slots, heads,
                                      out_alpha=out_alpha)
                continue
            kw = dict(pe_pack=pe_pack, seed=_layer_seed(gen, train),
                      feat_drop=feat_drop, attn_drop=attn_drop,
                      need_dx=l > 0)
            if pooled:
                h = gat_layer_pooled(h, *ops, ngp, nsib, p_slots, heads, **kw)
            else:
                h = gat_layer(h, *ops, ngp, nsib, p_slots, heads,
                              out_alpha=out_alpha, **kw)
        if pool_readout:
            return h
        return h.reshape(b, n, self.layer_specs[last][2], -1).mean(dim=2)


# ----------------------------------------------------------------- GCN

def init_gcn_layer(gen: torch.Generator, in_f: int, out_f: int) -> dict:
    """U(-stdv, stdv), stdv = 1/sqrt(out_f), for w and b."""
    stdv = 1.0 / math.sqrt(out_f)
    return {"w": uniform(gen, (in_f, out_f), stdv),
            "b": uniform(gen, (out_f,), stdv)}


def gcn_layer_operands(lp: dict, pe: torch.Tensor | None, din_h: int, n: int,
                       pe_dropout: bool = False):
    """Kernel operands of one GCN layer: ((w_h, b, z_bias), pe_pack), all
    contiguous float32. With a position embedding `pe` [N, pos] the tail
    rows W_p of w give z_bias = pe @ W_p or, with `pe_dropout`, pe_pack =
    (pe, W_p) beside a zero z_bias."""
    w = lp["w"]
    zeros = w.new_zeros((n, w.shape[1]))
    if pe is None:
        return (w.contiguous(), lp["b"].contiguous(), zeros), None
    w_h, w_p = w[:din_h].contiguous(), w[din_h:].contiguous()
    if pe_dropout:
        return (w_h, lp["b"].contiguous(), zeros), (pe.contiguous(), w_p)
    return (w_h, lp["b"].contiguous(), (pe @ w_p).contiguous()), None


def apply_gcn_layer(lp: dict, h: torch.Tensor, ngp: torch.Tensor,
                    nsib: torch.Tensor, p_slots: int, *, alpha, drop: float,
                    seed: int, pos_emb: torch.Tensor | None = None,
                    differentiable: bool = False,
                    need_dx: bool = True) -> torch.Tensor:
    """One GCN layer (model_zoo.py:34-50) on h [B, N, Din]: dropout at rate
    `drop` (0 in eval), [h, pe] @ W, the degree-normalised star sum, bias
    and leaky_relu(alpha) (None: no activation). Runs the K5 wrappers:
    the kernel on CUDA, its plain composition
    (ops/gcn_kernels.py:gcn_layer_train_plain) on the CPU; the eval
    forward alone unless the layer is `differentiable` or drops."""
    ops, pe_pack = gcn_layer_operands(lp, pos_emb, h.shape[-1], h.shape[1],
                                      pe_dropout=drop > 0)
    if not differentiable and drop == 0:
        return gcn_layer_fwd(h, *ops, ngp, nsib, p_slots, alpha=alpha)
    return gcn_layer(h, *ops, ngp, nsib, p_slots, pe_pack=pe_pack,
                     seed=seed, drop=drop, alpha=alpha, need_dx=need_dx)


class GCN:
    """GCN stack; PGCN when pos_dim > 0. Layer specs (din, dout, alpha,
    dropout rate): layer 0 at in_dropout, the middle layers at
    hidden_dropout, the final layer at output_dropout and without
    activation."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, pos_dim: int = 0,
                 position_vocab_size: int = 3, in_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, output_dropout: float = 0.0):
        self.pos_dim = pos_dim
        self.position_vocab_size = position_vocab_size
        self.out_dim = out_dim
        self.layer_specs = (
            [(in_dim + pos_dim, hidden_dim, HIDDEN_ALPHA, in_dropout)] +
            [(hidden_dim + pos_dim, hidden_dim, HIDDEN_ALPHA, hidden_dropout)
             for _ in range(num_layers - 1)] +
            [(hidden_dim + pos_dim, out_dim, None, output_dropout)])

    def init(self, gen: torch.Generator) -> dict:
        params = {"layers": [], "pos_emb": []}
        for din, dout, _alpha, _rate in self.layer_specs:
            params["layers"].append(init_gcn_layer(gen, din, dout))
            if self.pos_dim:
                params["pos_emb"].append(embedding_params(
                    gen, self.position_vocab_size, self.pos_dim))
        return params

    def apply(self, params: dict, h: torch.Tensor, ngp: torch.Tensor,
              nsib: torch.Tensor, p_slots: int, *,
              gen: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        """Egonet features [B, N, in_dim] -> per-slot activations
        [B, N, out_dim]. train=True turns dropout on, one seed per layer
        from `gen`."""
        n = h.shape[1]
        differentiable = train or torch.is_grad_enabled()
        for i, (_din, _dout, alpha, rate) in enumerate(self.layer_specs):
            pe = None
            if self.pos_dim:
                pe = slot_embeddings(params["pos_emb"][i]["emb"], p_slots, n)
            h = apply_gcn_layer(params["layers"][i], h, ngp, nsib, p_slots,
                                alpha=alpha, drop=rate if train else 0.0,
                                seed=_layer_seed(gen, train), pos_emb=pe,
                                differentiable=differentiable,
                                need_dx=i > 0)
        return h
