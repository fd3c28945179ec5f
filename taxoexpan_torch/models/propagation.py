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

Position concat (pos_mode="concat", propagation.py:387-411, :520-530):
each layer's input gets the slots' embedding rows appended as columns
(`concat_pos`), and the kernels take the whole input with zero slot biases
and no pe path; their feature dropout then covers the pe columns. The same
parameters serve both modes.

Eval (no autograd) calls the forward wrappers; train mode, or any call
under autograd, the differentiable layers (`gat_layer`, `gcn_layer`), with
one seed per layer drawn from the caller's torch.Generator. Layer 0's input
is the fixed feature tensor in pos_mode "bias", and its dx is not
computed; under "concat" it carries the trainable pe columns, and layer 0
computes its dx as every later layer does (propagation.py:541-542). Under
data parallelism each layer's seed has the stack's `rank` folded in
(`fold_rank`). The grads of the pos_emb rows, the weights' tail rows and
attn_l / attn_r flow through the slicing, the concatenation and the einsum
fold outside the kernels, by autograd.

Residual GAT layers (`GAT(residual=True)`, propagation.py:187-203,
:326-332): see `GAT._residual_layer`.

Compute dtype (GAT only; `GAT(dtype=torch.bfloat16)`, the JAX package's
compute_dtype "bfloat16" with its Pallas kernels, propagation.py:239-305):
each layer's input is rounded to bf16, and so are fc and the folded
wa1 / wa2, computed in float32 from the float32 params and then cast; the
slot biases and the pe path's rows stay float32. The kernels then take the
bf16 forms (ops/gat_kernels.py): the hidden layers' outputs come out in
bf16, the pools in float32, and the per-slot final layer's head mean is
taken in bf16 and cast to float32 (propagation.py:573). The params and
their grads stay float32: the casts sit outside the kernels' autograd
Function, so autograd turns the bf16 grads of fc, wa1 and wa2 back into
float32 ones. GCN has no compute dtype (taxoexpan.py:78 passes none).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.gat_kernels import (gat_layer, gat_layer_fwd, gat_layer_pooled,
                               gat_layer_pooled_fwd)
from ..ops import dropout
from ..ops.gcn_kernels import gcn_layer, gcn_layer_fwd
from ..parallel import distributed
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
    """The position embedding row of every slot: emb [3, pos] -> [N, pos],
    the rows of `star_slot_positions`' codes taken by slices of emb: an
    index tensor of the codes copied from the host to a card would wait
    for its stream."""
    return torch.cat([emb[0:1].expand(p_slots, -1), emb[1:2],
                      emb[2:3].expand(n - p_slots - 1, -1)])


RANK_SEED_STRIDE = 1_000_003
MP_SEED_STRIDE = 7_368_787


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def fold_rank(seed: int, rank: int, mp_index: int | None = None) -> int:
    """A layer's dropout seed on data-parallel rank `rank`: seed + rank *
    1_000_003 in int32 wraparound, as the JAX package folds the device's
    'dp' index in (propagation.py:138 for GAT, :173 for GCN), so the ranks'
    shares of a batch draw independent masks. A head-sharded layer also
    folds its mp index in, + mp_index * 7_368_787 (:140), so the mp ranks'
    heads draw independent masks; a layer replicated over 'mp' keeps the
    dp fold alone, and its replicas stay equal bit for bit."""
    seed = _int32(seed + rank * RANK_SEED_STRIDE)
    if mp_index is not None:
        seed = _int32(seed + mp_index * MP_SEED_STRIDE)
    return seed


def _layer_seed(gen: torch.Generator | None, train: bool,
                rank: int = 0, mp_index: int | None = None) -> int:
    if not train:
        return 0
    return fold_rank(int(torch.randint(0, 2_147_483_647, (1,),
                                       generator=gen)), rank, mp_index)


def init_gat_layer(gen: torch.Generator, in_dim: int, out_dim: int,
                   num_heads: int, residual: bool = False) -> dict:
    """xavier_normal(gain=1.414) for fc / attn_l / attn_r and, for a
    residual layer whose input width differs from its head width, the
    residual projection res_fc [in, H*Dh] (propagation.py:187-203)."""
    p = {
        "fc": xavier_normal(gen, (in_dim, num_heads * out_dim),
                            fan_in=in_dim, fan_out=num_heads * out_dim),
        # torch shape (1, H, D'): fan_in = H*D', fan_out = D'
        "attn_l": xavier_normal(gen, (num_heads, out_dim),
                                fan_in=num_heads * out_dim, fan_out=out_dim),
        "attn_r": xavier_normal(gen, (num_heads, out_dim),
                                fan_in=num_heads * out_dim, fan_out=out_dim),
    }
    if residual and in_dim != out_dim:
        p["res_fc"] = xavier_normal(gen, (in_dim, num_heads * out_dim),
                                    fan_in=in_dim,
                                    fan_out=num_heads * out_dim)
    return p


def layer_operands(lp: dict, pe: torch.Tensor | None, num_heads: int,
                   din_h: int, n: int, pe_dropout: bool = False,
                   dtype: torch.dtype = torch.float32):
    """Kernel operands of one layer: ((fc_h, wa1, wa2, bias_ft, bias_a1,
    bias_a2), pe_pack), all contiguous; fc_h, wa1 and wa2 in `dtype`
    (computed in float32, then cast), the rest float32.

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
        fc_full[:din_h].to(dtype), wa1_full[:din_h].to(dtype),
        wa2_full[:din_h].to(dtype), bias_ft, bias_a1, bias_a2)), pe_pack


def head_shard(ops: tuple, pe_pack, heads: int, index: int, parts: int):
    """Head shard `index` of `parts` of a layer's kernel operands (see
    `layer_operands`): fc / bias_ft columns [index * H/parts * Dh, ...) and
    wa1 / wa2 / bias_a1 / bias_a2 columns [index * H/parts, ...), and the
    same columns of the pe path's weight rows (pe itself whole). The
    columns are head-major, so a column shard is a head shard, as the JAX
    package shards them over 'mp' (propagation.py:132-134)."""
    local = heads // parts
    width = ops[0].shape[1] // heads * local

    def cols(t, w):
        return t[:, index * w:(index + 1) * w].contiguous()
    fc, wa1, wa2, bias_ft, bias_a1, bias_a2 = ops
    ops = (cols(fc, width), cols(wa1, local), cols(wa2, local),
           cols(bias_ft, width), cols(bias_a1, local), cols(bias_a2, local))
    if pe_pack is not None:
        pe, wp, wpa1, wpa2 = pe_pack
        pe_pack = (pe, cols(wp, width), cols(wpa1, local), cols(wpa2, local))
    return ops, pe_pack


POS_MODES = ("bias", "concat")


def check_pos_mode(pos_mode: str) -> str:
    if pos_mode not in POS_MODES:
        raise ValueError(f"pos_mode must be bias|concat, got {pos_mode!r}")
    return pos_mode


def concat_pos(h: torch.Tensor, emb: torch.Tensor,
               p_slots: int) -> torch.Tensor:
    """pos_mode "concat": the slots' position embedding rows, cast to h's
    dtype, appended to h [B, N, D] as columns (propagation.py:525-530)."""
    b, n = h.shape[:2]
    pe = slot_embeddings(emb, p_slots, n).to(h.dtype)
    return torch.cat([h, pe.expand(b, n, -1)], dim=-1)


class GAT:
    """GAT stack; PGAT when pos_dim > 0 (the paper's main model). `dtype`:
    the compute dtype of its layers, float32 or bfloat16. `pos_mode`:
    "bias" (the position embeddings as slot biases or the kernels' pe path,
    see the module docstring) or "concat" (their rows appended to each
    layer's input as columns; the kernels then take no slot biases and no
    pe path, and their feature dropout covers the pe columns). Both modes
    have the same parameters. `residual`: every layer after layer 0 adds a
    residual branch (`_residual_layer`).

    Head tensor parallelism (`mp`, the mp group of the trainer's or the
    ranker's layout; `_fused_call_spmd`, propagation.py:106-159): a layer
    whose head count the group's size divides runs this rank's head shard
    (`head_shard`) through the same kernels at H / mp heads, with the mp
    index folded into its seed; a per-slot output is then gathered over
    the group along its feature axis (head-major), a pooled one scaled by
    heads_local / heads and summed over the group; the grad of its input
    from the layer before is summed over the group (each rank's heads give
    a part of it). The grads of its own pos_emb rows, whether they enter
    as biases or as concatenated columns, stay this rank's part, and the
    trainer sums them over the world with the layer's weights: so layer
    0's input grad under concat is summed where it is used, on the
    [3, pos] embedding, and never as a [B, N, Din] tensor. A layer whose
    head count mp does not divide, and every residual layer, runs whole on
    every rank."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, heads, pos_dim: int = 0,
                 position_vocab_size: int = 3, feat_drop: float = 0.0,
                 attn_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 pos_mode: str = "bias", residual: bool = False):
        if len(heads) != num_layers + 1:
            raise ValueError(
                f"heads must have num_layers+1 entries, got {heads} for "
                f"num_layers={num_layers}")
        self.pos_mode = check_pos_mode(pos_mode)
        if residual and pos_dim and pos_mode == "bias":
            # the JAX package builds res_fc over the input with its pe
            # columns (propagation.py:200-202, :492-495) but multiplies the
            # input without them (:328): its residual PGAT runs only in
            # pos_mode "concat"
            raise ValueError(
                "residual GAT layers with position embeddings need "
                "pos_mode='concat': in pos_mode='bias' the JAX package's "
                "res_fc has in_dim + pos_dim rows but multiplies the input "
                "without its pe columns (propagation.py:200-202, :328)")
        self.num_layers = num_layers
        self.heads = list(heads)
        self.pos_dim = pos_dim
        self.position_vocab_size = position_vocab_size
        self.out_dim = out_dim
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.dtype = dtype
        # this process's data-parallel rank, folded into the dropout seeds,
        # and its mp group (head tensor parallelism; None: off), both set by
        # the trainer or the ranker
        self.rank = 0
        self.mp = None
        specs = [(in_dim + pos_dim, hidden_dim, heads[0])]
        for l in range(1, num_layers):
            specs.append((hidden_dim * heads[l - 1] + pos_dim, hidden_dim,
                          heads[l]))
        specs.append((hidden_dim * heads[-2] + pos_dim, out_dim, heads[-1]))
        self.layer_specs = specs
        # the JAX layer specs' fourth entry: layer 0 is never residual
        self.residual_layers = [False] + [bool(residual)] * num_layers

    @property
    def concat(self) -> bool:
        """Whether the position embeddings enter as input columns."""
        return bool(self.pos_dim) and self.pos_mode == "concat"

    def init(self, gen: torch.Generator) -> dict:
        params = {"layers": [], "pos_emb": []}
        for (din, dout, nh), res in zip(self.layer_specs,
                                        self.residual_layers):
            params["layers"].append(init_gat_layer(gen, din, dout, nh,
                                                   residual=res))
            if self.pos_dim:
                params["pos_emb"].append(embedding_params(
                    gen, self.position_vocab_size, self.pos_dim))
        return params

    def operands(self, params: dict, l: int, n: int, p_slots: int,
                 pe_dropout: bool = False) -> tuple:
        """Kernel operands of layer `l` for egonets of `n` slots: (ops,
        pe_pack), see `layer_operands`; under pos_mode "concat" the whole
        of fc multiplies the input and no pe operand exists."""
        fc = params["layers"][l]["fc"]
        pe = None
        if self.pos_dim and not self.concat:
            pe = slot_embeddings(params["pos_emb"][l]["emb"], p_slots, n)
        return layer_operands(params["layers"][l], pe, self.layer_specs[l][2],
                              fc.shape[0] - (0 if pe is None
                                             else self.pos_dim), n,
                              pe_dropout=pe_dropout, dtype=self.dtype)

    def layer_input(self, params: dict, h: torch.Tensor, l: int,
                    p_slots: int) -> torch.Tensor:
        """Layer `l`'s input from the previous output (or the features):
        the pe columns appended under pos_mode "concat" (in h's dtype, as
        the JAX package concatenates before its cast), then cast to the
        compute dtype."""
        if self.concat:
            h = concat_pos(h, params["pos_emb"][l]["emb"], p_slots)
        return h.to(self.dtype)

    def sharded_layers(self) -> list[int]:
        """The layers whose heads run sharded over `mp`: those whose head
        count the group's size divides and that are not residual (none
        without a group)."""
        if self.mp is None or self.mp.size == 1:
            return []
        return [l for l, spec in enumerate(self.layer_specs)
                if spec[2] % self.mp.size == 0 and not self.residual_layers[l]]

    def apply(self, params: dict, h: torch.Tensor, ngp: torch.Tensor,
              nsib: torch.Tensor, p_slots: int, *,
              gen: torch.Generator | None = None, train: bool = False,
              pool_readout: bool = True) -> torch.Tensor:
        """Egonet features [B, N, in_dim] -> readout class pools
        [B, 3, out_dim] (grandparents, anchor, siblings; head-averaged) or,
        with pool_readout=False, the per-slot activation [B, N, out_dim]
        (the mean over heads of the final layer, which has no activation;
        invalid slots keep their formula value, the readouts mask them),
        both float32. train=True turns dropout on, one seed per layer from
        `gen`. A residual final layer has no pooled form
        (propagation.py:264-266)."""
        b, n = h.shape[:2]
        feat_drop = self.feat_drop if train else 0.0
        attn_drop = self.attn_drop if train else 0.0
        differentiable = train or torch.is_grad_enabled()
        last = self.num_layers
        if pool_readout and self.residual_layers[last]:
            raise ValueError("a residual final GAT layer has no pooled "
                             "form: apply it with pool_readout=False")
        sharded = self.sharded_layers()
        for l in range(last + 1):
            heads = self.layer_specs[l][2]
            mp = self.mp if l in sharded else None
            if mp is not None and differentiable and l > 0:
                h = distributed.mp_sum_grads(h, mp)
            x = self.layer_input(params, h, l, p_slots)
            ops, pe_pack = self.operands(params, l, n, p_slots,
                                         pe_dropout=feat_drop > 0)
            pooled = l == last and pool_readout
            # hidden layers: flat [B, N, H*Dh] = the flatten-heads step
            out_alpha = HIDDEN_ALPHA if l < last else None
            if mp is not None:
                ops, pe_pack = head_shard(ops, pe_pack, heads, mp.rank,
                                          mp.size)
            local = heads // (1 if mp is None else mp.size)
            seed = _layer_seed(gen, train, self.rank,
                               None if mp is None else mp.rank)
            # layer 0's input is the fixed feature tensor unless the pe
            # columns are concatenated to it (propagation.py:541-542)
            need_dx = l > 0 or self.concat
            if self.residual_layers[l]:
                h = self._residual_layer(
                    params["layers"][l], x, ops, ngp, nsib, p_slots, heads,
                    seed=seed, feat_drop=feat_drop, attn_drop=attn_drop,
                    differentiable=differentiable, need_dx=need_dx)
                if l < last:
                    h = torch.nn.functional.leaky_relu(h, HIDDEN_ALPHA)
                continue
            if not differentiable:
                if pooled:
                    h = gat_layer_pooled_fwd(x, *ops, ngp, nsib, p_slots,
                                             local)
                else:
                    h = gat_layer_fwd(x, *ops, ngp, nsib, p_slots, local,
                                      out_alpha=out_alpha)
            else:
                kw = dict(pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
                          attn_drop=attn_drop, need_dx=need_dx)
                if pooled:
                    h = gat_layer_pooled(x, *ops, ngp, nsib, p_slots, local,
                                         **kw)
                else:
                    h = gat_layer(x, *ops, ngp, nsib, p_slots, local,
                                  out_alpha=out_alpha, **kw)
            if mp is not None:
                h = (distributed.mp_sum(h * (local / heads), mp) if pooled
                     else distributed.mp_gather_last(h, mp))
        if pool_readout:
            return h
        return h.reshape(b, n, self.layer_specs[last][2],
                         -1).mean(dim=2).float()

    def _residual_layer(self, lp: dict, x, ops, ngp, nsib, p_slots: int,
                        heads: int, *, seed: int, feat_drop: float,
                        attn_drop: float, differentiable: bool,
                        need_dx: bool) -> torch.Tensor:
        """A residual layer, as the JAX package's non-fused layer
        (propagation.py:234-238, :326-332): the feature dropout applied once
        to the input x, outside the kernel (`ops/dropout.py`'s feature
        stream of this layer's seed), so that both branches see one mask;
        the per-slot kernel on the dropped input with its attention dropout
        and no fused activation; plus the residual branch, x @ res_fc (or x
        itself, broadcast over the heads, when the widths agree). Returns
        [B, N, H*Dh] before the stack's activation."""
        b, n, din = x.shape
        if feat_drop > 0:
            mask = dropout.slot_mask(seed, dropout.STREAM_FEAT, b, n, din,
                                     feat_drop, x.device)
            x = x * mask.to(x.dtype)
        if not differentiable:
            out = gat_layer_fwd(x, *ops, ngp, nsib, p_slots, heads)
        else:
            out = gat_layer(x, *ops, ngp, nsib, p_slots, heads, seed=seed,
                            attn_drop=attn_drop, need_dx=need_dx)
        if "res_fc" in lp:
            return out + x @ lp["res_fc"].to(x.dtype)
        return (out.reshape(b, n, heads, -1) + x[:, :, None, :]).reshape(
            b, n, -1)


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
    activation. `pos_mode` as GAT's: under "concat" each layer's input
    carries the pe columns and K5 takes no z_bias and no pe path
    (propagation.py:387-411, where the JAX package runs the concat on its
    XLA path: the same function)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, pos_dim: int = 0,
                 position_vocab_size: int = 3, in_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, output_dropout: float = 0.0,
                 pos_mode: str = "bias"):
        self.pos_mode = check_pos_mode(pos_mode)
        self.pos_dim = pos_dim
        self.position_vocab_size = position_vocab_size
        self.out_dim = out_dim
        self.rank = 0    # data-parallel rank, as GAT.rank
        # GAT.mp's counterpart, unused: GCN has no heads to shard, so every
        # layer runs whole on every mp rank (propagation.py:161-179)
        self.mp = None
        self.layer_specs = (
            [(in_dim + pos_dim, hidden_dim, HIDDEN_ALPHA, in_dropout)] +
            [(hidden_dim + pos_dim, hidden_dim, HIDDEN_ALPHA, hidden_dropout)
             for _ in range(num_layers - 1)] +
            [(hidden_dim + pos_dim, out_dim, None, output_dropout)])

    def sharded_layers(self) -> list[int]:
        """None: under `mp` every layer runs whole on every rank."""
        return []

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
        concat = bool(self.pos_dim) and self.pos_mode == "concat"
        for i, (_din, _dout, alpha, rate) in enumerate(self.layer_specs):
            pe = None
            if concat:
                h = concat_pos(h, params["pos_emb"][i]["emb"], p_slots)
            elif self.pos_dim:
                pe = slot_embeddings(params["pos_emb"][i]["emb"], p_slots, n)
            h = apply_gcn_layer(params["layers"][i], h, ngp, nsib, p_slots,
                                alpha=alpha, drop=rate if train else 0.0,
                                seed=_layer_seed(gen, train, self.rank),
                                pos_emb=pe,
                                differentiable=differentiable,
                                need_dx=i > 0 or concat)
        return h
