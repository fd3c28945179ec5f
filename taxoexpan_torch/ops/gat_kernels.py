"""The star-GAT layer kernels, their plain PyTorch versions, their launch
counters and the autograd Functions around them.

    wrapper                     replaces (taxoexpan_tpu/ops/pallas_gat.py)
    gat_layer_fwd               K1 eval: fused_gat_layer fwd (:838, _fwd_kernel :315)
    gat_layer_pooled_fwd        K3 eval: fused_gat_layer_pooled fwd (:1105,
                                _fwd_pool_kernel :372)
    gat_layer_fwd_train         K1 train form (dropout, pe path)
    gat_layer_pooled_fwd_train  K3 train form
    gat_layer_bwd               K2: fused_gat_layer bwd (:991, _bwd_kernel :507)
    gat_layer_pooled_bwd        K4: fused_gat_layer_pooled bwd (:1188,
                                _bwd_pool_kernel :680)
    gat_layer_fwd_train_store,  K7a, the train forms that also write the
    gat_layer_pooled_fwd_train_store  softmax weights (_store_attn :231)
    gat_layer_bwd_stored,       K7a, the backwards that read them
    gat_layer_pooled_bwd_stored       (_attn_from_stored :240)

The forwards are `ops/csrc/gat_fwd.cu`, the backwards `ops/csrc/gat_bwd.cu`;
their headers state what bounds them on an H100 and what the design does
about it. Each computes the layer's product once, the projection [ft | a1 |
a2] = [x*m | pe*m_pe] @ [fc | wa1 | wa2; wp | wpa1 | wpa2] + the slot
biases, on the tensor cores (float32 layers in 3xTF32 on the TMA-fed
wgmma ring of `ops/csrc/gemm_wgmma.cuh`, `f32_product` runs it alone;
bf16 layers below). K2 writes it for all B*N rows into a workspace P that
its head core reads; K4 for the valid rows alone, compacted on the card
(its dx is zero at the invalid slots, as the reference gives it).
The forwards, in either dtype, take one of three forms by shape
(`fwd_form`, each form's launches also counted in
`<wrapper>.launches_by_form`): "fused" (the per-slot layer at N <= 64:
a1 | a2 first, then ft with the star pass in the product's epilogue, so P
never reaches device memory), "valid_rows" (the pooled eval and train
forms: the valid rows alone, compacted on the card, as K4 runs) or
"two_pass" (P over all B*N rows, then the star pass or the pooled star
pass: the per-slot layer at N > 64, the pooled store form); `use_form`
picks one for timing and comparison. `gat_projection` and
`gat_pooled_star` run the projection and the pooled star pass alone, for
tests. `fwd_pass_ms` / `bwd_pass_ms` time one call's passes. Dropout bits
come from `ops/dropout.py`, whose generator the kernels share, so a plain
version regenerates the kernels' masks exactly; every train form and
backward takes `dropout_bits` (32, or 8 for the 8-bit thresholds of K7b,
pallas_gat.py:73-97).

Dispatch is by the device of the tensors: on the CPU a wrapper runs its
plain version; on CUDA it launches the kernel or raises. There is no
fallback from one to the other. Each wrapper counts its launches in
`<wrapper>.launches` (the float32 kernel) and `<wrapper>.launches_bf16`
(the bf16 kernel), incremented only where that kernel is launched, and
again by the layer's heads on this rank in `<wrapper>.launches_by_heads`
(which tells a head-sharded launch from a whole one).

bf16 layers (compute_dtype "bfloat16"; the Pallas kernels called with x in
bf16): x, fc, wa1, wa2 come in bf16, the slot biases and the pe path's rows
in float32. Every form then has a bf16 kernel (`*_bf16` in the C
libraries), which follows the Pallas path: X = [x*m | pe*m_pe] rounded to
bf16 (the x columns multiplied by the mask rounded to bf16, pallas_gat.py:
282-283; the pe columns by the float32 mask, :296-297), W_p rounded to
bf16 (:298), the products on bf16 operands with float32 accumulation, so
the projection P (ft, a1, a2), the softmax and the aggregation are float32;
the per-slot output is rounded to bf16 after the fused leaky (:359-362),
the pools stay float32 (:1148). The bf16 products run on a TMA-fed,
warp-specialised wgmma kernel (`ops/csrc/gemm_wgmma.cuh`; `bf16_product`
runs it alone); the fused per-slot forward runs its star pass on the
product's tile of ft in shared memory, the pooled eval and train forwards
their product on the valid rows. The backwards keep the head core in
float32; it writes its grads D once, in bf16, for the dW and dx products
(_bwd_epilogue :607-651) and sums D's float32 values for the slot-bias
grads itself. They return dx
(times its float32 mask), dfc, dwa1 and dwa2 in bf16 (:651, :1097, :1289),
the slot-bias and pe grads in float32. The plain versions compute the
same roundings: bf16-exact operands upcast and multiplied in float32
(`launch.bf16_operands`), the backward written out pass by pass
(`_bwd_plain_bf16`) rather than by autograd through the casts.

`gat_layer` / `gat_layer_pooled` are the differentiable layers (the
counterparts of the JAX custom_vjp functions): their forward runs a forward
wrapper, their backward the matching backward wrapper, on either device.
The backward saves the layer inputs and the seed, and recomputes ft and the
attention (never stores ft), as the TPU kernel does. Two switches of the JAX
package, read from the environment when the layer's forward runs and kept
for its backward (so the replay cannot desynchronise): TAXOEXPAN_DROPOUT_BITS
=8 selects the 8-bit masks; TAXOEXPAN_STORED_ATTN=1 makes the forward, when
a gradient is needed, run the store form and the backward the stored form,
which reads the softmax weights instead of recomputing them (the inference
path never writes them, pallas_gat.py:1295-1299).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
from dataclasses import dataclass

import torch

from . import cuda_build, dropout, star
from .launch import (F as _F, I as _I, P as _P, TrainArgs as _TrainArgs,
                     bf16_operands, check_operands, check_star, chunk_elems,
                     count_launch, is_bf16, needs_staging, on_cuda,
                     pass_times, product_splits, product_work, raise_on,
                     round_bf16, round_up, stream, train_args, weight_work)

LEAKY_ALPHA = 0.2   # attention logits (GATLayer default); the inter-layer
                    # activation fused through `out_alpha` is 0.01


_BWD_POINTERS = ("x", "fc", "wa1", "wa2", "bias_ft", "bias_a1", "bias_a2",
                 "ngp", "nsib", "g", "attn", "dcat", "part_w", "part_b",
                 "pe_rows", "part_pe", "dx", "dfc", "dwa1", "dwa2", "dbias_ft",
                 "dbias_a1", "dbias_a2", "dpe", "dwp", "dwpa1", "dwpa2", "xm",
                 "wcat", "wt", "biascat", "d16", "row_off", "row_map",
                 "bt")
_BWD_INTS = ("b", "n", "din", "heads", "dh", "p", "pooled", "need_dx",
             "need_dbias", "has_out_alpha", "splits", "chunks", "kxp", "wdp",
             "ntp")


class _BwdArgs(ctypes.Structure):
    """BwdArgs of ops/csrc/gat_bwd.cu, field by field."""
    _fields_ = ([(name, _P) for name in _BWD_POINTERS] +
                [(name, _I) for name in _BWD_INTS] +
                [("alpha", _F), ("out_alpha", _F)])


_FWD_POINTERS = ("proj", "xm", "wcat", "biascat", "wa", "biasa", "a12",
                 "wts", "row_off", "row_map")


class _FwdWork(ctypes.Structure):
    """FwdWork of ops/csrc/gat_fwd.cu, field by field: a forward's
    workspaces."""
    _fields_ = ([(name, _P) for name in _FWD_POINTERS] +
                [(name, _I) for name in ("kxp", "wdp", "wap", "lda")])


# C signatures of ops/csrc/gat_fwd.cu: 10 pointers (x, fc, wa1, wa2,
# bias_ft, bias_a1, bias_a2, ngp, nsib, out), b, n, din, heads, dh, p,
# alpha, ... (the per-slot forms: out_alpha, has_out_alpha; the train
# forms: TrainArgs*, attn or null; then FwdWork* and the stream); each in
# a float32 (_f32) and a bf16 (_bf16) form
_COMMON = [_P] * 10 + [_I] * 6 + [_F]
_TA = ctypes.POINTER(_TrainArgs)
_FW = ctypes.POINTER(_FwdWork)
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
FWD_SIGNATURES = {
    f"{name}_{sfx}": sig for sfx in _DTYPE_SUFFIX.values()
    for name, sig in (
        ("gat_layer_fwd", (_COMMON + [_F, _I, _FW, _P], _I)),
        ("gat_layer_pooled_fwd", (_COMMON + [_FW, _P], _I)),
        ("gat_layer_fwd_train", (_COMMON + [_F, _I, _TA, _P, _FW, _P], _I)),
        ("gat_layer_pooled_fwd_train", (_COMMON + [_TA, _P, _FW, _P], _I)),
        ("gat_projection", ([_P] * 7 + [_I] * 5 + [_TA, _FW, _P], _I)))}
FWD_SIGNATURES.update({
    "dropout_bits_u32": ([ctypes.c_uint, ctypes.c_uint, _P, _P, _P,
                          ctypes.c_longlong, _I, _P], _I),
    # proj, ldp, ngp, nsib, pools, b, n, heads, dh, p, alpha, ta, attn
    "gat_pooled_star_f32": ([_P, _I] + [_P] * 3 + [_I] * 5 + [_F, _TA, _P,
                                                              _P], _I),
    "gat_fwd_set_timing": ([_I], _I),
    "gat_fwd_pass_ms": ([_P], _I),
    "gat_fwd_error_string": ([_I], ctypes.c_char_p),
})
BWD_SIGNATURES = {
    "gat_layer_bwd_f32": ([ctypes.POINTER(_BwdArgs), _TA, _P], _I),
    "gat_layer_bwd_bf16": ([ctypes.POINTER(_BwdArgs), _TA, _P], _I),
    # a, lda, a_kmajor, b, ldb, c, m, n, k, splits, stream
    "gat_product_bf16": ([_P, ctypes.c_longlong, _I, _P, ctypes.c_longlong,
                          _P, ctypes.c_longlong, _I, ctypes.c_longlong, _I,
                          _P], _I),
    # a, lda, a_kmajor, b, ldb, bt, c, m, n, k, splits, stream
    "gat_product_f32": ([_P, ctypes.c_longlong, _I, _P, ctypes.c_longlong,
                         _P, _P, ctypes.c_longlong, _I, ctypes.c_longlong,
                         _I, _P], _I),
    "gat_bwd_set_timing": ([_I], _I),
    "gat_bwd_pass_ms": ([_P], _I),
    "gat_bwd_error_string": ([_I], ctypes.c_char_p),
}
# what the pass times of `pass_times` measure, in order: a forward's by its
# form (`fwd_form`; the fused form's pass A computes a1 | a2, its weights
# pass the star softmax, its fused product ft with the aggregation in the
# epilogue; the valid-rows form's first pass counts and compacts the valid
# rows); the bf16 backwards' and K4's head core adds D into the slot-bias
# partials (writing D in bf16 in a bf16 layer), so their fourth pass is the
# partials' reduction alone, K4's first pass counts and compacts the valid
# rows, and a float32 layer's dW pass transposes its B operand into planes
# first
FWD_PASSES = {"two_pass": ("stage_pack", "projection", "star"),
              "fused": ("stage_pack", "pass_a", "weights", "fused_product"),
              "valid_rows": ("stage_rows_pack", "projection_rows", "star")}
BWD_PASSES = ("stage_pack", "projection", "head", "dbias", "dw", "dx")
BWD_PASSES_BF16 = ("stage_pack", "projection", "head_d16", "dbias_reduce",
                   "dw", "dx")
# zero rows after a compacted operand's valid rows (csrc/bwd_common.cuh:
# kRowPad)
ROW_PAD = 64
# the largest N of the per-slot fused form (csrc/gat_fwd.cu:
# kFusedMaxSlots): a warpgroup's 64 rows of the product hold whole egonets
FUSED_MAX_SLOTS = 64
_FORCED: list = []   # `use_form`'s choice, innermost last


def _serves(form: str, n: int, pooled: bool, store: bool) -> bool:
    """Whether `form` can run a forward of N = n slots: "two_pass" every
    one, "fused" the per-slot layer at N <= FUSED_MAX_SLOTS, "valid_rows"
    the pooled eval and train forms."""
    if form == "fused":
        return not pooled and n <= FUSED_MAX_SLOTS
    if form == "valid_rows":
        return pooled and not store
    return form == "two_pass"


def fwd_form(x: torch.Tensor, pooled: bool, store: bool = False) -> str:
    """The form a forward kernel takes for x, in either dtype
    (csrc/gat_fwd.cu's header): "fused" for a per-slot layer with N <=
    FUSED_MAX_SLOTS, "valid_rows" for a pooled layer's eval and train
    forms, else "two_pass" (the per-slot layer at larger N, the pooled
    store form). Inside `use_form(name)` a call takes `name` (ValueError
    where that form cannot run it)."""
    n = x.shape[1]
    if _FORCED:
        if not _serves(_FORCED[-1], n, pooled, store):
            raise ValueError(f"the {_FORCED[-1]} form cannot run this "
                             f"forward (N = {n}, pooled {pooled}, store "
                             f"{store})")
        return _FORCED[-1]
    for form in ("fused", "valid_rows"):
        if _serves(form, n, pooled, store):
            return form
    return "two_pass"


@contextlib.contextmanager
def use_form(name: str):
    """The star-GAT forwards inside, of either dtype, take the form `name`
    (FWD_PASSES' keys): "two_pass" (the form of every shape before the
    fused and valid-rows forms existed, so that the forms can be timed and
    their results compared on the same inputs), "fused" or "valid_rows"
    where they serve the call."""
    if name not in FWD_PASSES:
        raise ValueError(f"unknown star-GAT forward form {name!r}")
    _FORCED.append(name)
    try:
        yield
    finally:
        _FORCED.pop()


def _lib() -> ctypes.CDLL:
    return cuda_build.load("gat_fwd", FWD_SIGNATURES)


def _bwd_lib() -> ctypes.CDLL:
    return cuda_build.load("gat_bwd", BWD_SIGNATURES)


# ------------------------------------------------------------ plain versions

def _ft_logits(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, heads):
    b, n, din = x.shape
    hd = fc.shape[1]
    ft = (x.reshape(b * n, din) @ fc).reshape(b, n, hd) + bias_ft[None]
    a1 = x @ wa1 + bias_a1[None]                                 # [B, N, H]
    a2 = x @ wa2 + bias_a2[None]
    return ft.reshape(b, n, heads, hd // heads), a1, a2


def gat_layer_fwd_plain(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                        nsib, p: int, heads: int,
                        out_alpha=None) -> torch.Tensor:
    """Plain PyTorch version of `gat_layer_fwd`: [B, N, H*Dh] in x's dtype.
    Invalid slots keep their formula value (the TPU kernel does not mask
    them)."""
    if is_bf16(x):
        return gat_layer_train_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                     bias_a2, ngp, nsib, p, heads,
                                     out_alpha=out_alpha)
    b, n, _ = x.shape
    ft, a1, a2 = _ft_logits(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                            heads)
    out = star.gat_attention_aggregate(ft, a1, a2, ngp, nsib, p,
                                       leaky_alpha=LEAKY_ALPHA,
                                       mask_output=False)
    out = out.reshape(b, n, -1)
    if out_alpha is not None:
        out = torch.where(out >= 0, out, out_alpha * out)
    return out


def gat_layer_pooled_fwd_plain(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                               ngp, nsib, p: int,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch version of `gat_layer_pooled_fwd`: pools [B, 3, Dh] =
    (sum over valid gp slots, anchor, sum over valid sib slots) of the
    head-averaged aggregation, float32."""
    if is_bf16(x):
        return gat_layer_train_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                     bias_a2, ngp, nsib, p, heads,
                                     pooled=True)
    b, n, _ = x.shape
    ft, a1, a2 = _ft_logits(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                            heads)
    out = star.gat_attention_aggregate(ft, a1, a2, ngp, nsib, p,
                                       leaky_alpha=LEAKY_ALPHA,
                                       mask_output=True)
    hm = out.mean(dim=2)                                         # [B, N, Dh]
    return torch.stack([hm[:, :p].sum(dim=1), hm[:, p],
                        hm[:, p + 1:].sum(dim=1)], dim=1)


def _leaky(v, alpha):
    return torch.where(v >= 0, v, alpha * v)


def attn_row(n: int, p: int) -> int:
    """Floats of one (egonet, head)'s stored softmax weights: P gp -> anchor,
    the anchor's self-loop, S anchor -> sib and S sib self-loops."""
    return 2 * n - p - 1


class _StoredSoftmax(torch.autograd.Function):
    """softmax(logits, dim) whose value is the forward's stored weights `sm`
    and whose backward is the softmax's Jacobian at them, sm * (g - sum(sm *
    g)): the plain version of the stored-attention backward
    (_attn_from_stored, pallas_gat.py:240, and the Jacobian :474-480)."""

    @staticmethod
    def forward(ctx, logits, sm, dim):
        ctx.save_for_backward(sm)
        ctx.dim = dim
        return sm.clone()

    @staticmethod
    def backward(ctx, g):
        (sm,) = ctx.saved_tensors
        return sm * (g - (sm * g).sum(ctx.dim, keepdim=True)), None, None


def _star_attention_train(ft, a1, a2, ngp, p, masks, stored=None):
    """The star attention of `_tile_attention` (pallas_gat.py:118-162) with
    the attention masks multiplied in after the softmax. ft [B, N, H, Dh],
    a1/a2 [B, N, H]; masks as dropout.attention_masks, or None; stored: the
    softmax weights [B, H, 2N - P - 1] to use instead of recomputing them.
    Returns (out_gp [B, P, H, Dh], out_anchor [B, H, Dh], out_sib
    [B, S, H, Dh], gp_mask [B, P, 1], the softmax weights before dropout
    [B, H, 2N - P - 1])."""
    gp_mask = (torch.arange(p, device=ngp.device)[None, :]
               < ngp[:, None].long())[..., None]
    lg_gp = _leaky(a1[:, :p] + a2[:, p:p + 1], LEAKY_ALPHA)        # [B,P,H]
    lg_gp = torch.where(gp_mask, lg_gp, torch.full_like(lg_gp, star.NEG_INF))
    lg_self = _leaky(a1[:, p:p + 1] + a2[:, p:p + 1], LEAKY_ALPHA)  # [B,1,H]
    l0 = _leaky(a1[:, p:p + 1] + a2[:, p + 1:], LEAKY_ALPHA)       # [B,S,H]
    l1 = _leaky(a1[:, p + 1:] + a2[:, p + 1:], LEAKY_ALPHA)
    if stored is None:
        m = lg_self
        if p:
            m = torch.maximum(lg_gp.max(dim=1, keepdim=True).values, lg_self)
        e_gp = torch.where(gp_mask, torch.exp(lg_gp - m),
                           torch.zeros_like(lg_gp))
        e_self = torch.exp(lg_self - m)
        den = e_gp.sum(dim=1, keepdim=True) + e_self
        w_gp2a, w_selfa = e_gp / den, e_self / den
        m2 = torch.maximum(l0, l1)
        e0, e1 = torch.exp(l0 - m2), torch.exp(l1 - m2)
        w_s0, w_s1 = e0 / (e0 + e1), e1 / (e0 + e1)
    else:
        s = l0.shape[1]
        st = stored.permute(0, 2, 1)                              # [B, K, H]
        sm_a = _StoredSoftmax.apply(torch.cat([lg_gp, lg_self], dim=1),
                                    st[:, :p + 1], 1)
        sm_s = _StoredSoftmax.apply(
            torch.stack([l0, l1], dim=-1),
            torch.stack([st[:, p + 1:p + 1 + s], st[:, p + 1 + s:]], dim=-1),
            -1)
        w_gp2a, w_selfa = sm_a[:, :p], sm_a[:, p:]
        w_s0, w_s1 = sm_s[..., 0], sm_s[..., 1]
    sm = torch.cat([w_gp2a, w_selfa, w_s0, w_s1], dim=1).detach().permute(
        0, 2, 1).contiguous()
    if masks is not None:
        d_gp2a, d_selfa, d_s0, d_s1, d_gp = masks
        w_gp2a, w_selfa = w_gp2a * d_gp2a, w_selfa * d_selfa
        w_s0, w_s1 = w_s0 * d_s0, w_s1 * d_s1
        out_gp = d_gp[..., None] * ft[:, :p]
    else:
        out_gp = ft[:, :p]
    ft_anchor = ft[:, p]                                           # [B,H,Dh]
    out_anchor = ((w_gp2a[..., None] * ft[:, :p]).sum(dim=1)
                  + w_selfa[:, 0, :, None] * ft_anchor)
    out_sib = w_s0[..., None] * ft_anchor[:, None] + w_s1[..., None] * \
        ft[:, p + 1:]
    return out_gp, out_anchor, out_sib, gp_mask, sm


def _projection_bf16(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, pe_pack,
                     seed, feat_drop, dropout_bits):
    """A bf16 layer's projection P = X @ W + the slot biases, [B, N, wd]
    float32, and its operands (`launch.bf16_operands`)."""
    b, n, _ = x.shape
    pe, wp = (None, None) if pe_pack is None else (
        pe_pack[0], torch.cat(pe_pack[1:], dim=1))
    xs, w, fmask, pmask = bf16_operands(x, torch.cat([fc, wa1, wa2], dim=1),
                                        pe, wp, seed, feat_drop,
                                        dropout_bits)
    bias = torch.cat([bias_ft, bias_a1, bias_a2], dim=1).float()
    proj = (xs @ w).reshape(b, n, -1) + bias[None]
    return proj, (xs, w, fmask, pmask)


def _projection_plain(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, pe_pack,
                      seed, feat_drop, dropout_bits):
    """ft [B, N, H*Dh], a1, a2 [B, N, H] of the layer input [x*m | pe*m_pe]
    (the masks of ops/dropout.py when feat_drop > 0); float32, also for a
    bf16 x (`_projection_bf16`)."""
    if is_bf16(x):
        heads = wa1.shape[1]
        hd = fc.shape[1]
        proj, _ = _projection_bf16(x, fc, wa1, wa2, bias_ft, bias_a1,
                                   bias_a2, pe_pack, seed, feat_drop,
                                   dropout_bits)
        return (proj[..., :hd], proj[..., hd:hd + heads],
                proj[..., hd + heads:])
    b, n, din = x.shape
    hd = fc.shape[1]
    dev = x.device
    if feat_drop > 0:
        x = x * dropout.slot_mask(seed, dropout.STREAM_FEAT, b, n, din,
                                  feat_drop, dev, dropout_bits)
    ft = (x.reshape(b * n, din) @ fc).reshape(b, n, hd) + bias_ft[None]
    a1 = x @ wa1 + bias_a1[None]
    a2 = x @ wa2 + bias_a2[None]
    if pe_pack is not None:
        pe, wp, wpa1, wpa2 = pe_pack
        pos = pe.shape[1]
        pm = pe[None] * dropout.slot_mask(seed, dropout.STREAM_PE, b, n, pos,
                                          feat_drop, dev, dropout_bits)
        ft = ft + (pm.reshape(b * n, pos) @ wp).reshape(b, n, hd)
        a1 = a1 + pm @ wpa1
        a2 = a2 + pm @ wpa2
    return ft, a1, a2


def gat_projection_plain(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, *,
                         pe_pack=None, seed: int = 0, feat_drop: float = 0.0,
                         dropout_bits: int = 32) -> torch.Tensor:
    """Plain version of `gat_projection`: [ft | a1 | a2], [B, N, H*Dh +
    2H]."""
    return torch.cat(_projection_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                       bias_a2, pe_pack, seed, feat_drop,
                                       dropout_bits), dim=-1)


def gat_layer_train_plain(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                          nsib, p: int, heads: int, *, pe_pack=None,
                          seed: int = 0, feat_drop: float = 0.0,
                          attn_drop: float = 0.0, out_alpha=None,
                          pooled: bool = False, dropout_bits: int = 32,
                          store_attn: bool = False, stored_attn=None):
    """Plain PyTorch version of the train forms (and, at rates 0, of the
    eval forms), differentiable by autograd in float32: per-slot output
    [B, N, H*Dh] in x's dtype or, with `pooled`, pools [B, 3, Dh] float32.
    The masks come from ops/dropout.py, exactly the kernels' bits
    (`dropout_bits` 32 or 8). For a bf16 x the roundings of the bf16
    kernels (module docstring); its backward is `gat_layer_bwd_plain`, not
    autograd through the casts.

    pe_pack = (pe [N, pos], wp [pos, H*Dh], wpa1 [pos, H], wpa2 [pos, H]):
    the pe path, [x*m | pe*m_pe] @ [W_h; W_p] (requires feat_drop > 0).
    store_attn: return (output, softmax weights [B, H, 2N - P - 1]) as the
    store forms do; stored_attn: such weights, used instead of the softmax
    (their backward is the stored form's)."""
    ft, a1, a2 = _projection_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                   bias_a2, pe_pack, seed, feat_drop,
                                   dropout_bits)
    out, sm = _star_plain(ft, a1, a2, ngp, nsib, p, heads, seed, attn_drop,
                          out_alpha, pooled, dropout_bits, stored_attn)
    if not pooled:
        out = out.to(x.dtype)
    return (out, sm) if store_attn else out


def _star_plain(ft, a1, a2, ngp, nsib, p, heads, seed, attn_drop, out_alpha,
                pooled, dropout_bits, stored_attn):
    """The star pass of the train forms from the projection's ft [B, N,
    H*Dh], a1, a2 [B, N, H]: (output, softmax weights before dropout)."""
    b, n, hd = ft.shape
    dev = ft.device
    masks = None
    if attn_drop > 0:
        masks = dropout.attention_masks(seed, b, p, n - p - 1, heads,
                                        attn_drop, dev, dropout_bits)
    out_gp, out_anchor, out_sib, gp_mask, sm = _star_attention_train(
        ft.reshape(b, n, heads, hd // heads), a1, a2, ngp, p, masks,
        stored_attn)
    if pooled:
        sib_mask = (torch.arange(n - p - 1, device=dev)[None, :]
                    < nsib[:, None].long())[..., None, None]
        pool_gp = (out_gp * gp_mask[..., None]).sum(dim=1).mean(dim=1)
        pool_sib = (out_sib * sib_mask).sum(dim=1).mean(dim=1)
        out = torch.stack([pool_gp, out_anchor.mean(dim=1), pool_sib], dim=1)
    else:
        out = torch.cat([out_gp, out_anchor[:, None], out_sib],
                        dim=1).reshape(b, n, hd)
        if out_alpha is not None:
            out = _leaky(out, out_alpha)
    return out, sm


def gat_pooled_star_plain(proj, ngp, nsib, p: int, heads: int, *,
                          seed: int = 0, attn_drop: float = 0.0,
                          dropout_bits: int = 32, store_attn: bool = False):
    """Plain version of `gat_pooled_star`: the pools [B, 3, Dh] of the
    pooled layer from its projection proj = [ft | a1 | a2], [B, N, H*Dh +
    2H] (`gat_projection_plain`'s output), with the attention masks of
    `seed`; with `store_attn`, (pools, softmax weights [B, H, 2N - P - 1])."""
    hd = proj.shape[-1] - 2 * heads
    out, sm = _star_plain(proj[..., :hd], proj[..., hd:hd + heads],
                          proj[..., hd + heads:hd + 2 * heads], ngp, nsib, p,
                          heads, seed, attn_drop, None, True, dropout_bits,
                          None)
    return (out, sm) if store_attn else out


_GRAD_NAMES = ("x", "fc", "wa1", "wa2", "bias_ft", "bias_a1", "bias_a2")
_PE_NAMES = ("pe", "wp", "wpa1", "wpa2")


def gat_layer_bwd_plain(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                        nsib, p: int, heads: int, *, pe_pack=None,
                        seed: int = 0, feat_drop: float = 0.0,
                        attn_drop: float = 0.0, out_alpha=None,
                        pooled: bool = False, need_dx: bool = True,
                        dropout_bits: int = 32, stored_attn=None) -> dict:
    """Plain backward: torch.autograd.grad through `gat_layer_train_plain`
    with the same seed, so the same masks (and, given `stored_attn`, the
    stored form's softmax weights). Returns {name: grad} for x (None unless
    need_dx), fc, wa1, wa2, the slot biases and, on the pe path, pe, wp,
    wpa1, wpa2 (for a bf16 x: `_bwd_plain_bf16`)."""
    if is_bf16(x):
        return _bwd_plain_bf16(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                               ngp, nsib, p, heads, pe_pack, seed, feat_drop,
                               attn_drop, out_alpha, pooled, need_dx,
                               dropout_bits, stored_attn)
    tensors = [x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2]
    names = list(_GRAD_NAMES)
    if pe_pack is not None:
        tensors += list(pe_pack)
        names += list(_PE_NAMES)
    leaves = [t.detach().requires_grad_(True) for t in tensors]
    with torch.enable_grad():
        out = gat_layer_train_plain(
            *leaves[:7], ngp, nsib, p, heads,
            pe_pack=tuple(leaves[7:]) if pe_pack is not None else None,
            seed=seed, feat_drop=feat_drop, attn_drop=attn_drop,
            out_alpha=out_alpha, pooled=pooled, dropout_bits=dropout_bits,
            stored_attn=stored_attn)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    res = dict(zip(names, grads))
    if not need_dx:
        res["x"] = None
    return res


def _projection_grad(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                     nsib, p, heads, pe_pack, seed, feat_drop, attn_drop,
                     out_alpha, pooled, dropout_bits, stored_attn):
    """D = dP [B, N, H*Dh + 2H] float32, the grad of the layer's projection
    P = [ft | a1 | a2] for the incoming grad g (upcast): the head core's
    output, through the float32 star pass by autograd, P computed as the
    layer computes it. Returns (D, the bf16 operands of
    `launch.bf16_operands` for a bf16 x, else None)."""
    hd = fc.shape[1]
    args = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, pe_pack, seed,
            feat_drop, dropout_bits)
    if is_bf16(x):
        proj, operands = _projection_bf16(*args)
    else:
        proj, operands = torch.cat(_projection_plain(*args), dim=-1), None
    proj = proj.detach().requires_grad_(True)
    with torch.enable_grad():
        out, _ = _star_plain(proj[..., :hd], proj[..., hd:hd + heads],
                             proj[..., hd + heads:], ngp, nsib, p, heads,
                             seed, attn_drop, out_alpha, pooled,
                             dropout_bits, stored_attn)
        (dproj,) = torch.autograd.grad(out, proj, g.float())
    return dproj, operands


def _bwd_plain_bf16(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                    nsib, p, heads, pe_pack, seed, feat_drop, attn_drop,
                    out_alpha, pooled, need_dx, dropout_bits,
                    stored_attn) -> dict:
    """The plain backward of a bf16 layer, pass by pass as the bf16 kernels
    run it (pallas_gat.py:_bwd_epilogue :607-677): the projection P
    recomputed from the staged X and packed W; D = dP through the float32
    star pass by autograd (the head core, `_projection_grad`), g upcast;
    the slot-bias grads D's float32 sums over egonets; D rounded to bf16
    for dW = X^T D (dfc, dwa1, dwa2 rounded to bf16; the pe rows' dwp,
    dwpa1, dwpa2 float32) and dX = D W^T (dx times its float32 mask,
    rounded to bf16; the pe columns times theirs, summed over egonets into
    dpe, float32)."""
    b, n, din = x.shape
    hd = fc.shape[1]
    dproj, (xs, w, fmask, pmask) = _projection_grad(
        g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
        pe_pack, seed, feat_drop, attn_drop, out_alpha, pooled, dropout_bits,
        stored_attn)
    d = dproj.reshape(b * n, -1)
    dsum = dproj.sum(dim=0)
    res = {"bias_ft": dsum[:, :hd], "bias_a1": dsum[:, hd:hd + heads],
           "bias_a2": dsum[:, hd + heads:]}
    d16 = round_bf16(d)
    dw = xs.T @ d16
    bf = torch.bfloat16
    res.update(fc=dw[:din, :hd].to(bf), wa1=dw[:din, hd:hd + heads].to(bf),
               wa2=dw[:din, hd + heads:].to(bf))
    dxs = d16 @ w.T
    dx = dxs[:, :din] if fmask is None else dxs[:, :din] * fmask
    res["x"] = dx.reshape(b, n, din).to(bf) if need_dx else None
    if pe_pack is not None:
        pos = pe_pack[0].shape[1]
        res.update(pe=(dxs[:, din:] * pmask).reshape(b, n, pos).sum(dim=0),
                   wp=dw[din:, :hd], wpa1=dw[din:, hd:hd + heads],
                   wpa2=dw[din:, hd + heads:])
    return res


# ------------------------------------------------------------------ checks

def _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
           pe_pack=None, extra=(), low=("fc", "wa1", "wa2")):
    """Shapes, device, dtype and layout of the operands (x and the names in
    `low` float32, or all bf16; every other float operand float32); ngp,
    nsib and p None for the projection alone."""
    b, n, din = x.shape
    hd = fc.shape[1]
    if hd % heads:
        raise ValueError(f"fc width {hd} is not a multiple of heads {heads}")
    shapes = {"fc": (fc, (din, hd)), "wa1": (wa1, (din, heads)),
              "wa2": (wa2, (din, heads)), "bias_ft": (bias_ft, (n, hd)),
              "bias_a1": (bias_a1, (n, heads)),
              "bias_a2": (bias_a2, (n, heads))}
    if p is not None:
        shapes.update(ngp=(ngp, (b,)), nsib=(nsib, (b,)))
    if pe_pack is not None:
        pe, wp, wpa1, wpa2 = pe_pack
        pos = pe.shape[-1]
        shapes.update({"pe": (pe, (n, pos)), "wp": (wp, (pos, hd)),
                       "wpa1": (wpa1, (pos, heads)),
                       "wpa2": (wpa2, (pos, heads))})
    shapes.update(dict(extra))
    check_operands(x, shapes, low)
    check_star(x, 0 if p is None else p)
    # a launch whose shared memory (the backward's head core about 1 KB a
    # slot, gat_bwd.cu:head_floats) exceeds the device's limit comes back as
    # an error and raises


# ----------------------------------------------------------------- forwards

def _fwd_cuda(what: str, pooled: bool, x, fc, wa1, wa2, bias_ft, bias_a1,
              bias_a2, ngp, nsib, p, heads, out_alpha=None, train=None,
              store: bool = False):
    """Check, allocate and launch one forward kernel; `train` = (pe_pack,
    seed, feat_drop, attn_drop, dropout_bits) selects the train form, and
    `store` its store form, whose output is (out, attn). Returns (output,
    the form launched, `fwd_form`)."""
    pe_pack = train[0] if train is not None else None
    _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
           pe_pack)
    ta = train_args(*train) if train is not None else None
    lib = _lib()
    b, n, din = x.shape
    dh = fc.shape[1] // heads
    shape = (b, 3, dh) if pooled else (b, n, heads * dh)
    # the per-slot output in x's dtype, the pools float32
    out = torch.empty(shape, dtype=torch.float32 if pooled else x.dtype,
                      device=x.device)
    attn = (torch.empty((b, heads, attn_row(n, p)), dtype=torch.float32,
                        device=x.device) if store else None)
    form = fwd_form(x, pooled, store)
    if b == 0:
        return (out, attn) if store else out, form
    args = [t.data_ptr() for t in (x, fc, wa1, wa2, bias_ft, bias_a1,
                                   bias_a2, ngp, nsib, out)]
    args += [b, n, din, heads, dh, p, LEAKY_ALPHA]
    if not pooled:
        args += [0.0 if out_alpha is None else float(out_alpha),
                 0 if out_alpha is None else 1]
    if ta is not None:
        args += [ctypes.byref(ta), attn.data_ptr() if store else None]
    work = _fwd_work(x, heads, dh, train[2] if train is not None else 0.0,
                     ta, form)
    args.append(ctypes.byref(work.args))
    fn = getattr(lib, f"{'gat_layer_pooled_fwd' if pooled else 'gat_layer_fwd'}"
                      f"{'_train' if train is not None else ''}"
                      f"_{_DTYPE_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        rc = fn(*args, stream(x))
    raise_on(lib, rc, what, "gat_fwd_error_string")
    return (out, attn) if store else out, form


@dataclass
class _Work:
    """ctypes arguments and the tensors they point into (kept alive until
    the launch has been enqueued)."""
    args: ctypes.Structure
    tensors: list


def _fwd_work(x, heads: int, dh: int, feat_drop: float, ta,
              form: str) -> _Work:
    """A forward's workspaces (gat_fwd.cu:FwdWork) for its `form`, in the
    products' layouts (widths 16-byte multiples): X staged where needed
    (the valid-rows form: always, compacted, ROW_PAD rows more) and W in
    x's dtype (`weight_work`: float32 as W^T's hi / lo planes), the slot
    biases float32; the two-pass and valid-rows forms the projection P
    [B*N, wdp] float32 (wdp = H*Dh + 2H rounded up); the fused form no P,
    but W split into [fc; wp] (wdp = H*Dh rounded up) and [wa1 | wa2; wpa1
    | wpa2] (wap = 2H rounded up) with their slot biases, pass A's a1 | a2
    [B*N, lda] float32 (lda = 2H rounded up to 4) and the star weights
    [B*N, H, 4] float32; the valid-rows form its row offsets [B + 1] and
    row map [B*N + ROW_PAD], int32. The kernel takes the form these
    workspaces name."""
    b, n, din = x.shape
    m, hd = b * n, heads * dh
    pos = ta.pos if ta is not None else 0
    c = chunk_elems(x)
    kx = din + pos
    rows = m + ROW_PAD if form == "valid_rows" else m
    if rows >= 1 << 31:
        raise ValueError("B * N + 64 must stay below 2**31 (int32 row map)")
    staged = form == "valid_rows" or needs_staging(x, feat_drop, pos)
    kxp = round_up(kx, c) if staged else kx
    fused = form == "fused"
    wdp = round_up(hd if fused else hd + 2 * heads, c)
    wap, lda = round_up(2 * heads, c), round_up(2 * heads, 4)
    empty = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    i32 = torch.int32
    t = {"proj": None if fused else empty(m, wdp),
         "xm": empty(rows, kxp, dtype=x.dtype) if staged else None,
         "wcat": weight_work(x, kxp, wdp), "biascat": empty(n, wdp),
         "wa": weight_work(x, kxp, wap) if fused else None,
         "biasa": empty(n, lda) if fused else None,
         "a12": empty(m, lda) if fused else None,
         "wts": empty(m, heads, 4) if fused else None,
         "row_off": empty(b + 1, dtype=i32) if rows > m else None,
         "row_map": empty(rows, dtype=i32) if rows > m else None}
    args = _FwdWork(*[t[k].data_ptr() if t[k] is not None else None
                      for k in _FWD_POINTERS], kxp, wdp, wap, lda)
    return _Work(args, list(t.values()))


def gat_layer_fwd(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                  p: int, heads: int, out_alpha=None) -> torch.Tensor:
    """One star-GAT layer, per-slot output [B, N, H*Dh] in x's dtype.

    x [B, N, Din]; fc [Din, H*Dh] (head-major columns); wa1/wa2 [Din, H]
    (fc folded with attn_l / attn_r), all four float32 or all bf16; slot
    biases bias_ft [N, H*Dh], bias_a1/bias_a2 [N, H] (float32); ngp/nsib
    [B] int32; p = anchor slot; out_alpha: fused leaky_relu slope of the
    output, or None."""
    ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads)
    if not on_cuda(x, "gat_layer_fwd"):
        return gat_layer_fwd_plain(*ops, out_alpha)
    out, form = _fwd_cuda("gat_layer_fwd", False, *ops, out_alpha=out_alpha)
    _count_fwd(gat_layer_fwd, x, heads, form)
    return out


def gat_layer_pooled_fwd(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                         nsib, p: int, heads: int) -> torch.Tensor:
    """Final star-GAT layer with the head mean and the per-class readout
    pools fused in: returns pools [B, 3, Dh] (float32, also for a bf16 x)
    and never writes the [B, N, H*Dh] activation. Arguments as
    `gat_layer_fwd`."""
    ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads)
    if not on_cuda(x, "gat_layer_pooled_fwd"):
        return gat_layer_pooled_fwd_plain(*ops)
    out, form = _fwd_cuda("gat_layer_pooled_fwd", True, *ops)
    _count_fwd(gat_layer_pooled_fwd, x, heads, form)
    return out


def _train_fwd(wrapper, pooled: bool, store: bool, ops, out_alpha, pe_pack,
               seed, feat_drop, attn_drop, dropout_bits):
    """A train-form forward wrapper's body: the plain version on the CPU,
    the kernel (counted on `wrapper`) on CUDA."""
    what = wrapper.__name__
    if not on_cuda(ops[0], what):
        return gat_layer_train_plain(
            *ops, pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
            attn_drop=attn_drop, out_alpha=out_alpha, pooled=pooled,
            dropout_bits=dropout_bits, store_attn=store)
    out, form = _fwd_cuda(what, pooled, *ops, out_alpha=out_alpha,
                          train=(pe_pack, seed, feat_drop, attn_drop,
                                 dropout_bits), store=store)
    _count_fwd(wrapper, ops[0], ops[10], form)
    return out


def _count_fwd(wrapper, x, heads: int, form: str) -> None:
    """A forward launch on `wrapper` (`count_launch`), also under its form
    in `wrapper.launches_by_form` (either dtype)."""
    count_launch(wrapper, x, heads)
    if x.shape[0]:
        counts = wrapper.launches_by_form
        counts[form] = counts.get(form, 0) + 1


def gat_layer_fwd_train(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                        nsib, p: int, heads: int, *, pe_pack=None,
                        seed: int = 0, feat_drop: float = 0.0,
                        attn_drop: float = 0.0, out_alpha=None,
                        dropout_bits: int = 32) -> torch.Tensor:
    """Train form of `gat_layer_fwd`: input-feature dropout (feat_drop),
    attention dropout (attn_drop) and the pe path (pe_pack, see
    `gat_layer_train_plain`), masks drawn from `seed` with `dropout_bits`
    thresholds."""
    return _train_fwd(gat_layer_fwd_train, False, False,
                      (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                       p, heads), out_alpha, pe_pack, seed, feat_drop,
                      attn_drop, dropout_bits)


def gat_layer_pooled_fwd_train(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                               ngp, nsib, p: int, heads: int, *,
                               pe_pack=None, seed: int = 0,
                               feat_drop: float = 0.0,
                               attn_drop: float = 0.0,
                               dropout_bits: int = 32) -> torch.Tensor:
    """Train form of `gat_layer_pooled_fwd` (see `gat_layer_fwd_train`)."""
    return _train_fwd(gat_layer_pooled_fwd_train, True, False,
                      (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                       p, heads), None, pe_pack, seed, feat_drop, attn_drop,
                      dropout_bits)


def gat_layer_fwd_train_store(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                              ngp, nsib, p: int, heads: int, *, pe_pack=None,
                              seed: int = 0, feat_drop: float = 0.0,
                              attn_drop: float = 0.0, out_alpha=None,
                              dropout_bits: int = 32):
    """Store form of `gat_layer_fwd_train`: returns (out, attn), attn
    [B, H, 2N - P - 1] the softmax weights before dropout, for
    `gat_layer_bwd_stored`."""
    return _train_fwd(gat_layer_fwd_train_store, False, True,
                      (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                       p, heads), out_alpha, pe_pack, seed, feat_drop,
                      attn_drop, dropout_bits)


def gat_layer_pooled_fwd_train_store(x, fc, wa1, wa2, bias_ft, bias_a1,
                                     bias_a2, ngp, nsib, p: int, heads: int,
                                     *, pe_pack=None, seed: int = 0,
                                     feat_drop: float = 0.0,
                                     attn_drop: float = 0.0,
                                     dropout_bits: int = 32):
    """Store form of `gat_layer_pooled_fwd_train`: returns (pools, attn)."""
    return _train_fwd(gat_layer_pooled_fwd_train_store, True, True,
                      (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                       p, heads), None, pe_pack, seed, feat_drop, attn_drop,
                      dropout_bits)


# ---------------------------------------------------------------- backwards

def _bwd_cuda(pooled: bool, g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
              ngp, nsib, p, heads, pe_pack, seed, feat_drop, attn_drop,
              out_alpha, need_dx, need_dbias, dropout_bits=32,
              attn=None) -> dict:
    b, n, din = x.shape
    hd = fc.shape[1]
    dh = hd // heads
    g_shape = (b, 3, dh) if pooled else (b, n, hd)
    extra = [("g", (g, g_shape))]
    if attn is not None:
        extra.append(("attn", (attn, (b, heads, attn_row(n, p)))))
    # K2's incoming grad is the grad of an output in x's dtype; K4's are
    # the float32 pools'
    low = ("fc", "wa1", "wa2") + (() if pooled else ("g",))
    _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
           pe_pack, extra=extra, low=low)
    ta = train_args(pe_pack, seed, feat_drop, attn_drop, dropout_bits)
    pos = ta.pos
    dev = x.device
    empty = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=dev)
    dt = x.dtype    # dx, dfc, dwa1, dwa2 in x's dtype; the rest float32
    grads = {"x": empty(b, n, din, dtype=dt) if need_dx else None,
             "fc": empty(din, hd, dtype=dt),
             "wa1": empty(din, heads, dtype=dt),
             "wa2": empty(din, heads, dtype=dt)}
    if need_dbias:
        grads.update(bias_ft=empty(n, hd), bias_a1=empty(n, heads),
                     bias_a2=empty(n, heads))
    else:
        grads.update(bias_ft=None, bias_a1=None, bias_a2=None)
    if pe_pack is not None:
        grads.update(pe=empty(n, pos), wp=empty(pos, hd),
                     wpa1=empty(pos, heads), wpa2=empty(pos, heads))
    if b == 0:
        for t in grads.values():
            if t is not None:
                t.zero_()
        return grads
    m = b * n
    wd = hd + 2 * heads
    kx = din + pos
    bf16 = is_bf16(x)
    # K4 runs its products on the valid rows, compacted: X always staged,
    # kRowPad zero rows after the valid ones in X and D
    compact = pooled
    rows = m + ROW_PAD if compact else m
    if compact and rows >= 1 << 31:
        raise ValueError("B * N + 64 must stay below 2**31 (int32 row map)")
    splits = product_splits(x, m, kx, wd)
    chunks = _bwd_chunks(x, b, heads, pooled)
    pw = product_work(x, rows, kx, wd,
                      compact or needs_staging(x, feat_drop, pos),
                      0 if need_dx else din, splits)
    wdp = pw["wdp"]
    work = {"dcat": empty(rows, wdp), "part_w": pw["part_w"],
            "part_b": empty(chunks, n, wdp) if need_dbias else None,
            "pe_rows": empty(m, pos) if pos else None,
            "part_pe": empty(chunks, n, pos) if pos else None,
            "xm": pw["xm"], "wt": pw["wt"], "bt": pw["bt"],
            # the projection's W and slot biases
            "wcat": weight_work(x, pw["kxp"], wdp), "biascat": empty(n, wdp),
            # the products' D in bf16, written by the head core
            "d16": empty(rows, wdp, dtype=dt) if bf16 else None,
            "row_off": (empty(b + 1, dtype=torch.int32) if compact
                        else None),
            "row_map": empty(rows, dtype=torch.int32) if compact else None}
    args = _BwdArgs()
    ptrs = {"x": x, "fc": fc, "wa1": wa1, "wa2": wa2, "bias_ft": bias_ft,
            "bias_a1": bias_a1, "bias_a2": bias_a2, "ngp": ngp,
            "nsib": nsib, "g": g, "attn": attn, **work, "dx": grads["x"],
            "dfc": grads["fc"], "dwa1": grads["wa1"], "dwa2": grads["wa2"],
            "dbias_ft": grads["bias_ft"], "dbias_a1": grads["bias_a1"],
            "dbias_a2": grads["bias_a2"], "dpe": grads.get("pe"),
            "dwp": grads.get("wp"), "dwpa1": grads.get("wpa1"),
            "dwpa2": grads.get("wpa2")}
    for name, t in ptrs.items():
        setattr(args, name, t.data_ptr() if t is not None else None)
    for name, v in (("b", b), ("n", n), ("din", din), ("heads", heads),
                    ("dh", dh), ("p", p), ("pooled", int(pooled)),
                    ("need_dx", int(need_dx)),
                    ("need_dbias", int(need_dbias)),
                    ("has_out_alpha", int(out_alpha is not None)),
                    ("splits", splits), ("chunks", chunks),
                    ("kxp", pw["kxp"]), ("wdp", wdp), ("ntp", pw["ntp"])):
        setattr(args, name, v)
    args.alpha = LEAKY_ALPHA
    args.out_alpha = 0.0 if out_alpha is None else float(out_alpha)
    lib = _bwd_lib()
    fn = getattr(lib, f"gat_layer_bwd_{_DTYPE_SUFFIX[x.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(args), ctypes.byref(ta), stream(x))
    what = "gat_layer_pooled_bwd" if pooled else "gat_layer_bwd"
    raise_on(lib, rc, what, "gat_bwd_error_string")
    return grads


def _bwd_chunks(x, b: int, heads: int, pooled: bool) -> int:
    """Chunks of egonets of the slot-bias and dpe sums: 64 in K2 float32;
    in the bf16 forms and K4, where a head-core block walks a chunk for its
    head, about three blocks an SM."""
    if not is_bf16(x) and not pooled:
        return min(b, 64)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return min(b, max(64, 3 * sms // heads))


def _bwd(wrapper, pooled: bool, g, ops, out_alpha, attn, pe_pack, seed,
         feat_drop, attn_drop, need_dx, need_dbias, dropout_bits) -> dict:
    """A backward wrapper's body: the plain version on the CPU, the kernels
    (counted on `wrapper`) on CUDA."""
    x = ops[0]
    if not on_cuda(x, wrapper.__name__):
        return gat_layer_bwd_plain(
            g, *ops, pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
            attn_drop=attn_drop, out_alpha=out_alpha, pooled=pooled,
            need_dx=need_dx, dropout_bits=dropout_bits, stored_attn=attn)
    res = _bwd_cuda(pooled, g, *ops, pe_pack, seed, feat_drop, attn_drop,
                    out_alpha, need_dx, need_dbias, dropout_bits, attn)
    count_launch(wrapper, x, ops[10])
    return res


def gat_layer_bwd(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                  p: int, heads: int, *, pe_pack=None, seed: int = 0,
                  feat_drop: float = 0.0, attn_drop: float = 0.0,
                  out_alpha=None, need_dx: bool = True,
                  need_dbias: bool = True, dropout_bits: int = 32) -> dict:
    """Backward of `gat_layer_fwd[_train]` for the incoming grad g
    [B, N, H*Dh] (in x's dtype): {x (need_dx), fc, wa1, wa2, bias_ft,
    bias_a1, bias_a2 (need_dbias), and with pe_pack pe, wp, wpa1, wpa2};
    x, fc, wa1, wa2's grads in x's dtype, the others float32."""
    return _bwd(gat_layer_bwd, False, g,
                (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
                 heads), out_alpha, None, pe_pack, seed, feat_drop,
                attn_drop, need_dx, need_dbias, dropout_bits)


def gat_layer_pooled_bwd(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                         nsib, p: int, heads: int, *, pe_pack=None,
                         seed: int = 0, feat_drop: float = 0.0,
                         attn_drop: float = 0.0, need_dx: bool = True,
                         need_dbias: bool = True,
                         dropout_bits: int = 32) -> dict:
    """Backward of `gat_layer_pooled_fwd[_train]` for the pool grads g
    [B, 3, Dh]; returns as `gat_layer_bwd`."""
    return _bwd(gat_layer_pooled_bwd, True, g,
                (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
                 heads), None, None, pe_pack, seed, feat_drop, attn_drop,
                need_dx, need_dbias, dropout_bits)


def gat_layer_bwd_stored(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                         nsib, p: int, heads: int, attn, *, pe_pack=None,
                         seed: int = 0, feat_drop: float = 0.0,
                         attn_drop: float = 0.0, out_alpha=None,
                         need_dx: bool = True, need_dbias: bool = True,
                         dropout_bits: int = 32) -> dict:
    """Stored form of `gat_layer_bwd`: the softmax weights come from `attn`
    [B, H, 2N - P - 1] (of `gat_layer_fwd_train_store`, same seed) instead
    of a recompute."""
    return _bwd(gat_layer_bwd_stored, False, g,
                (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
                 heads), out_alpha, attn, pe_pack, seed, feat_drop,
                attn_drop, need_dx, need_dbias, dropout_bits)


def gat_layer_pooled_bwd_stored(g, x, fc, wa1, wa2, bias_ft, bias_a1,
                                bias_a2, ngp, nsib, p: int, heads: int, attn,
                                *, pe_pack=None, seed: int = 0,
                                feat_drop: float = 0.0,
                                attn_drop: float = 0.0,
                                need_dx: bool = True,
                                need_dbias: bool = True,
                                dropout_bits: int = 32) -> dict:
    """Stored form of `gat_layer_pooled_bwd` (see `gat_layer_bwd_stored`)."""
    return _bwd(gat_layer_pooled_bwd_stored, True, g,
                (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
                 heads), None, attn, pe_pack, seed, feat_drop, attn_drop,
                need_dx, need_dbias, dropout_bits)


def gat_projection(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, *,
                   pe_pack=None, seed: int = 0, feat_drop: float = 0.0,
                   dropout_bits: int = 32) -> torch.Tensor:
    """The projection of the per-slot layer alone, [ft | a1 | a2] =
    [x*m | pe*m_pe] @ [fc | wa1 | wa2; wp | wpa1 | wpa2] + the slot biases,
    [B, N, H*Dh + 2H], float32 (also for a bf16 x): the first launch of
    `gat_layer_fwd[_train]` and of `gat_layer_bwd`, exposed for testing it
    on its own (the plain version on the CPU; on the card the kernel,
    counted in `gat_projection.launches[_bf16]`)."""
    kw = dict(pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
              dropout_bits=dropout_bits)
    if not on_cuda(x, "gat_projection"):
        return gat_projection_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                    bias_a2, **kw)
    heads = wa1.shape[1]
    _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, None, None, None,
           heads, pe_pack)
    b, n, din = x.shape
    hd = fc.shape[1]
    wd = hd + 2 * heads
    ta = train_args(pe_pack, seed, feat_drop, 0.0, dropout_bits)
    work = _fwd_work(x, heads, hd // heads, feat_drop, ta, "two_pass")
    lib = _lib()
    fn = getattr(lib, f"gat_projection_{_DTYPE_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        rc = fn(
            *[t.data_ptr() for t in (x, fc, wa1, wa2, bias_ft, bias_a1,
                                     bias_a2)],
            b, n, din, heads, hd // heads, ctypes.byref(ta),
            ctypes.byref(work.args), stream(x))
    raise_on(lib, rc, "gat_projection", "gat_fwd_error_string")
    count_launch(gat_projection, x)
    return work.tensors[0].reshape(b, n, -1)[..., :wd]


gat_projection.launches = gat_projection.launches_bf16 = 0


def gat_pooled_star(proj, ngp, nsib, p: int, heads: int, *, seed: int = 0,
                    attn_drop: float = 0.0, dropout_bits: int = 32,
                    store: bool = False):
    """The pooled star pass of `gat_layer_pooled_fwd[_train[_store]]` alone,
    pools [B, 3, Dh] from a projection proj [B, N, H*Dh + 2H] (rows may be
    wider, as `gat_projection`'s output on the card is: its last dimension
    unit-strided), with the attention masks of `seed`; with `store`,
    (pools, softmax weights [B, H, 2N - P - 1]). Exposed for testing the
    pass on its own (the plain version on the CPU; on the card the kernel,
    counted in `gat_pooled_star.launches`)."""
    kw = dict(seed=seed, attn_drop=attn_drop, dropout_bits=dropout_bits)
    if not on_cuda(proj, "gat_pooled_star"):
        return gat_pooled_star_plain(proj, ngp, nsib, p, heads,
                                     store_attn=store, **kw)
    b, n, width = proj.shape
    dh = (width - 2 * heads) // heads
    if dh <= 0 or proj.dtype != torch.float32 or proj.stride(2) != 1 or (
            b > 1 and proj.stride(0) != n * proj.stride(1)):
        raise ValueError("proj must be float32 [B, N, H*Dh + 2H] with "
                         "unit-strided, evenly spaced rows")
    for name, t in (("ngp", ngp), ("nsib", nsib)):
        if (tuple(t.shape) != (b,) or t.dtype != torch.int32
                or t.device != proj.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{b}] on "
                             f"{proj.device}")
    check_star(proj, p)
    ta = train_args(None, seed, 0.0, attn_drop, dropout_bits)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa
                                       device=proj.device)
    pools = empty(b, 3, dh)
    attn = empty(b, heads, attn_row(n, p)) if store else None
    lib = _lib()
    with torch.cuda.device(proj.device):
        rc = lib.gat_pooled_star_f32(
            proj.data_ptr(), proj.stride(1), ngp.data_ptr(), nsib.data_ptr(),
            pools.data_ptr(), b, n, heads, dh, p, LEAKY_ALPHA,
            ctypes.byref(ta), attn.data_ptr() if store else None,
            stream(proj))
    raise_on(lib, rc, "gat_pooled_star", "gat_fwd_error_string")
    if b:
        gat_pooled_star.launches += 1
    return (pools, attn) if store else pools


gat_pooled_star.launches = 0


def fwd_pass_ms(call, form: str = "two_pass") -> dict:
    """Device ms of a forward's launches in one `call` of
    gat_layer[_pooled]_fwd[_train[_store]] on the card, by FWD_PASSES of
    the call's `form` (`fwd_form`; the pooled forms' "star" is the pooled
    star pass)."""
    return dict(zip(FWD_PASSES[form], pass_times(_lib(), "gat_fwd", call)))


def bwd_pass_ms(call, bf16: bool = False) -> dict:
    """Device ms of the backward's passes in one `call` of a backward
    wrapper on the card, by BWD_PASSES (BWD_PASSES_BF16 for a bf16
    layer's)."""
    names = BWD_PASSES_BF16 if bf16 else BWD_PASSES
    return dict(zip(names, pass_times(_bwd_lib(), "gat_bwd", call)))


def bf16_product(a, b, *, a_kmajor: bool = True,
                 splits: int = 1) -> torch.Tensor:
    """C = A @ B on the bf16 layers' product kernel alone
    (csrc/gemm_wgmma.cuh, the store epilogue): A [M, K] (a_kmajor) or, as
    the dW product reads X, A^T given as [K, M]; B [K, N]; bf16. Rows whose
    width is not a multiple of 8 are copied into zero-padded rows first (the
    layers' workspaces are padded so). Returns float32 [M, N], the split-K
    partials (splits > 1) summed over the splits. For tests and
    chip_smoke's product lines; no layer calls it. The plain version on the
    CPU (the float32 product of the bf16 operands); on the card the kernel,
    counted in `bf16_product.launches`."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("a and b must be matrices")
    m, k = (a.shape if a_kmajor else a.shape[::-1])
    if b.shape[0] != k:
        raise ValueError(f"inner dimensions differ: {k} and {b.shape[0]}")
    if not on_cuda(a, "bf16_product"):
        af = a.float() if a_kmajor else a.float().T
        return af @ b.float()
    n = b.shape[1]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or t.device != a.device:
            raise ValueError(f"{name} must be bf16 on {a.device}")

    def padded(t):
        width = round_up(t.shape[1], 8)
        if width == t.shape[1] and t.is_contiguous() and \
                t.data_ptr() % 16 == 0:
            return t
        out = t.new_zeros((t.shape[0], width))
        out[:, :t.shape[1]] = t
        return out
    a, b = padded(a), padded(b)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    lib = _bwd_lib()
    with torch.cuda.device(a.device):
        rc = lib.gat_product_bf16(a.data_ptr(), a.shape[1], int(a_kmajor),
                                  b.data_ptr(), b.shape[1], part.data_ptr(),
                                  m, n, k, splits, stream(a))
    raise_on(lib, rc, "bf16_product", "gat_bwd_error_string")
    if m and n:
        bf16_product.launches += 1
    return part[0] if splits == 1 else part.sum(dim=0)


bf16_product.launches = 0


def f32_product(a, b, *, a_kmajor: bool = True,
                splits: int = 1) -> torch.Tensor:
    """C = A @ B on the float32 layers' product kernel alone (3xTF32 on
    csrc/gemm_wgmma.cuh's ring, the store epilogue), B's hi / lo planes
    made as the dW product makes its B (csrc/bwd_common.cuh:
    transpose_split_kernel): A [M, K] (a_kmajor) or A^T given as [K, M]; B
    [K, N]; float32. Rows whose width is not a multiple of 4 are copied
    into zero-padded rows first. Returns [M, N], the split-K partials
    (splits > 1) summed over the splits. For the card tests; no layer
    calls it. The plain version on the CPU (the float32 product); on the
    card the kernel, counted in `f32_product.launches`."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("a and b must be matrices")
    m, k = (a.shape if a_kmajor else a.shape[::-1])
    if b.shape[0] != k:
        raise ValueError(f"inner dimensions differ: {k} and {b.shape[0]}")
    if not on_cuda(a, "f32_product"):
        return (a if a_kmajor else a.T) @ b
    n = b.shape[1]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"{name} must be float32 on {a.device}")

    def padded(t):
        width = round_up(t.shape[1], 4)
        if width == t.shape[1] and t.is_contiguous() and \
                t.data_ptr() % 16 == 0:
            return t
        out = t.new_zeros((t.shape[0], width))
        out[:, :t.shape[1]] = t
        return out
    a, b = padded(a), padded(b)
    bt = torch.empty((2, round_up(n, 4), round_up(k, 4)),
                     dtype=torch.float32, device=a.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    lib = _bwd_lib()
    with torch.cuda.device(a.device):
        rc = lib.gat_product_f32(a.data_ptr(), a.shape[1], int(a_kmajor),
                                 b.data_ptr(), b.shape[1], bt.data_ptr(),
                                 part.data_ptr(), m, n, k, splits, stream(a))
    raise_on(lib, rc, "f32_product", "gat_bwd_error_string")
    if m and n:
        f32_product.launches += 1
    return part[0] if splits == 1 else part.sum(dim=0)


f32_product.launches = 0


WRAPPERS = {w.__name__: w for w in (
    gat_layer_fwd, gat_layer_pooled_fwd, gat_layer_fwd_train,
    gat_layer_pooled_fwd_train, gat_layer_fwd_train_store,
    gat_layer_pooled_fwd_train_store, gat_layer_bwd, gat_layer_pooled_bwd,
    gat_layer_bwd_stored, gat_layer_pooled_bwd_stored)}
for _w in WRAPPERS.values():
    _w.launches = _w.launches_bf16 = 0
    _w.launches_by_heads = {}
    _w.launches_by_form = {}


# --------------------------------------------------- differentiable layers

def stored_attn_enabled() -> bool:
    """TAXOEXPAN_STORED_ATTN as the JAX package reads it
    (pallas_gat.py:208)."""
    return os.environ.get("TAXOEXPAN_STORED_ATTN", "0") == "1"


@dataclass(frozen=True)
class _LayerCfg:
    p: int
    heads: int
    seed: int
    feat_drop: float
    attn_drop: float
    out_alpha: float | None
    need_dx: bool
    pooled: bool
    dropout_bits: int
    store: bool


class _GatLayerFn(torch.autograd.Function):
    """Forward: the train-form kernel (its store form with cfg.store; the
    eval kernel when no dropout is on and nothing is stored); backward: K2 /
    K4 (their stored forms with cfg.store). On CPU tensors both are the
    plain versions."""

    @staticmethod
    def forward(ctx, cfg, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                nsib, *pe_pack):
        pe_pack = tuple(pe_pack) or None
        ctx.cfg = cfg
        ctx.save_for_backward(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                              ngp, nsib, *(pe_pack or ()))
        ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
               cfg.p, cfg.heads)
        train_kw = dict(pe_pack=pe_pack, seed=cfg.seed,
                        feat_drop=cfg.feat_drop, attn_drop=cfg.attn_drop,
                        dropout_bits=cfg.dropout_bits)
        if not cfg.pooled:
            train_kw["out_alpha"] = cfg.out_alpha
        if cfg.store:
            fwd = (gat_layer_pooled_fwd_train_store if cfg.pooled
                   else gat_layer_fwd_train_store)
            out, ctx.attn = fwd(*ops, **train_kw)
            return out
        if cfg.feat_drop > 0 or cfg.attn_drop > 0:
            fwd = (gat_layer_pooled_fwd_train if cfg.pooled
                   else gat_layer_fwd_train)
            return fwd(*ops, **train_kw)
        if cfg.pooled:
            return gat_layer_pooled_fwd(*ops)
        return gat_layer_fwd(*ops, out_alpha=cfg.out_alpha)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        pe_pack = tuple(saved[9:]) or None
        needs = ctx.needs_input_grad
        kw = dict(pe_pack=pe_pack, seed=cfg.seed, feat_drop=cfg.feat_drop,
                  attn_drop=cfg.attn_drop,
                  need_dx=cfg.need_dx and needs[1],
                  need_dbias=any(needs[5:8]),
                  dropout_bits=cfg.dropout_bits)
        if not cfg.pooled:
            kw["out_alpha"] = cfg.out_alpha
        args = (g.contiguous(), *saved[:9], cfg.p, cfg.heads)
        if cfg.store:
            bwd = (gat_layer_pooled_bwd_stored if cfg.pooled
                   else gat_layer_bwd_stored)
            grads = bwd(*args, ctx.attn, **kw)
        else:
            bwd = gat_layer_pooled_bwd if cfg.pooled else gat_layer_bwd
            grads = bwd(*args, **kw)
        out = [None] + [grads[k] for k in _GRAD_NAMES] + [None, None]
        if pe_pack is not None:
            out += [grads[k] for k in _PE_NAMES]
        return tuple(out)


def _layer_cfg(p, heads, seed, feat_drop, attn_drop, out_alpha, need_dx,
               pooled, tensors) -> _LayerCfg:
    """The layer's static configuration, with the two switches read now,
    at forward time: the dropout bits, and the stored attention when a
    gradient is needed."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return _LayerCfg(p, heads, int(seed), float(feat_drop), float(attn_drop),
                     None if out_alpha is None else float(out_alpha),
                     bool(need_dx), pooled, dropout.env_bits(),
                     grad and stored_attn_enabled())


def gat_layer(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p: int,
              heads: int, *, pe_pack=None, seed: int = 0,
              feat_drop: float = 0.0, attn_drop: float = 0.0,
              out_alpha=None, need_dx: bool = True) -> torch.Tensor:
    """Differentiable star-GAT layer, [B, N, H*Dh] (the port of the
    `fused_gat_layer` custom_vjp). need_dx=False: the caller guarantees x's
    grad is never used (layer 0's fixed input features) and the backward
    skips the dx product."""
    tensors = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, *(pe_pack or ()))
    cfg = _layer_cfg(p, heads, seed, feat_drop, attn_drop, out_alpha,
                     need_dx, False, tensors)
    return _GatLayerFn.apply(cfg, *tensors[:7], ngp, nsib, *tensors[7:])


def gat_layer_pooled(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                     p: int, heads: int, *, pe_pack=None, seed: int = 0,
                     feat_drop: float = 0.0, attn_drop: float = 0.0,
                     need_dx: bool = True) -> torch.Tensor:
    """Differentiable final star-GAT layer with the pools fused in,
    [B, 3, Dh] (the port of `fused_gat_layer_pooled`)."""
    tensors = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, *(pe_pack or ()))
    cfg = _layer_cfg(p, heads, seed, feat_drop, attn_drop, None, need_dx,
                     True, tensors)
    return _GatLayerFn.apply(cfg, *tensors[:7], ngp, nsib, *tensors[7:])
