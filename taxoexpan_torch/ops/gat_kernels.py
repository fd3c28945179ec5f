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

The forwards are `ops/csrc/gat_fwd.cu`, the backwards `ops/csrc/gat_bwd.cu`;
their headers state what bounds them on an H100 and what the design does
about it. Dropout bits come from `ops/dropout.py`, whose generator the
kernels share, so a plain version regenerates the kernels' masks exactly.

Dispatch is by the device of the tensors: on the CPU a wrapper runs its
plain version; on CUDA it launches the kernel or raises. There is no
fallback from one to the other. Each wrapper counts its launches in
`<wrapper>.launches`, incremented only where the kernel is launched.

`gat_layer` / `gat_layer_pooled` are the differentiable layers (the
counterparts of the JAX custom_vjp functions): their forward runs a forward
wrapper, their backward the matching backward wrapper, on either device.
The backward saves the layer inputs and the seed, and recomputes ft and the
attention (never stores ft), as the TPU kernel does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import cuda_build, dropout, star
from .launch import (F as _F, I as _I, P as _P, TrainArgs as _TrainArgs,
                     check_operands, check_star, on_cuda, product_splits,
                     raise_on, stream, train_args)

LEAKY_ALPHA = 0.2   # attention logits (GATLayer default); the inter-layer
                    # activation fused through `out_alpha` is 0.01


_BWD_POINTERS = ("x", "fc", "wa1", "wa2", "bias_ft", "bias_a1", "bias_a2",
                 "ngp", "nsib", "g", "dcat", "part_w", "part_b", "pe_rows",
                 "part_pe", "dx", "dfc", "dwa1", "dwa2", "dbias_ft",
                 "dbias_a1", "dbias_a2", "dpe", "dwp", "dwpa1", "dwpa2")
_BWD_INTS = ("b", "n", "din", "heads", "dh", "p", "pooled", "need_dx",
             "need_dbias", "has_out_alpha", "splits", "chunks")


class _BwdArgs(ctypes.Structure):
    """BwdArgs of ops/csrc/gat_bwd.cu, field by field."""
    _fields_ = ([(name, _P) for name in _BWD_POINTERS] +
                [(name, _I) for name in _BWD_INTS] +
                [("alpha", _F), ("out_alpha", _F)])


# C signatures of ops/csrc/gat_fwd.cu: 10 pointers (x, fc, wa1, wa2,
# bias_ft, bias_a1, bias_a2, ngp, nsib, out), b, n, din, heads, dh, p,
# alpha, ...
_COMMON = [_P] * 10 + [_I] * 6 + [_F]
_TA = ctypes.POINTER(_TrainArgs)
FWD_SIGNATURES = {
    "gat_layer_fwd_f32": (_COMMON + [_F, _I, _P], _I),
    "gat_layer_pooled_fwd_f32": (_COMMON + [_P], _I),
    "gat_layer_fwd_train_f32": (_COMMON + [_F, _I, _TA, _P], _I),
    "gat_layer_pooled_fwd_train_f32": (_COMMON + [_TA, _P], _I),
    "dropout_bits_u32": ([ctypes.c_uint, ctypes.c_uint, _P, _P, _P,
                          ctypes.c_longlong, _P], _I),
    "gat_fwd_error_string": ([_I], ctypes.c_char_p),
}
BWD_SIGNATURES = {
    "gat_layer_bwd_f32": ([ctypes.POINTER(_BwdArgs), _TA, _P], _I),
    "gat_bwd_error_string": ([_I], ctypes.c_char_p),
}


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
    """Plain PyTorch version of `gat_layer_fwd`: [B, N, H*Dh]. Invalid
    slots keep their formula value (the TPU kernel does not mask them)."""
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
    head-averaged aggregation."""
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


def _star_attention_train(ft, a1, a2, ngp, p, masks):
    """The star attention of `_tile_attention` (pallas_gat.py:118-162) with
    the attention masks multiplied in after the softmax. ft [B, N, H, Dh],
    a1/a2 [B, N, H]; masks as dropout.attention_masks, or None.
    Returns (out_gp [B, P, H, Dh], out_anchor [B, H, Dh], out_sib
    [B, S, H, Dh], gp_mask [B, P, 1])."""
    gp_mask = (torch.arange(p, device=ngp.device)[None, :]
               < ngp[:, None].long())[..., None]
    lg_gp = _leaky(a1[:, :p] + a2[:, p:p + 1], LEAKY_ALPHA)        # [B,P,H]
    lg_gp = torch.where(gp_mask, lg_gp, torch.full_like(lg_gp, star.NEG_INF))
    lg_self = _leaky(a1[:, p:p + 1] + a2[:, p:p + 1], LEAKY_ALPHA)  # [B,1,H]
    m = lg_self
    if p:
        m = torch.maximum(lg_gp.max(dim=1, keepdim=True).values, lg_self)
    e_gp = torch.where(gp_mask, torch.exp(lg_gp - m), torch.zeros_like(lg_gp))
    e_self = torch.exp(lg_self - m)
    den = e_gp.sum(dim=1, keepdim=True) + e_self
    w_gp2a, w_selfa = e_gp / den, e_self / den
    l0 = _leaky(a1[:, p:p + 1] + a2[:, p + 1:], LEAKY_ALPHA)       # [B,S,H]
    l1 = _leaky(a1[:, p + 1:] + a2[:, p + 1:], LEAKY_ALPHA)
    m2 = torch.maximum(l0, l1)
    e0, e1 = torch.exp(l0 - m2), torch.exp(l1 - m2)
    w_s0, w_s1 = e0 / (e0 + e1), e1 / (e0 + e1)
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
    return out_gp, out_anchor, out_sib, gp_mask


def gat_layer_train_plain(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                          nsib, p: int, heads: int, *, pe_pack=None,
                          seed: int = 0, feat_drop: float = 0.0,
                          attn_drop: float = 0.0, out_alpha=None,
                          pooled: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the train forms (and, at rates 0, of the
    eval forms), differentiable by autograd: per-slot output [B, N, H*Dh]
    or, with `pooled`, pools [B, 3, Dh]. The masks come from
    ops/dropout.py, exactly the kernels' bits.

    pe_pack = (pe [N, pos], wp [pos, H*Dh], wpa1 [pos, H], wpa2 [pos, H]):
    the pe path, [x*m | pe*m_pe] @ [W_h; W_p] (requires feat_drop > 0)."""
    b, n, din = x.shape
    hd = fc.shape[1]
    dev = x.device
    if feat_drop > 0:
        x = x * dropout.slot_mask(seed, dropout.STREAM_FEAT, b, n, din,
                                  feat_drop, dev)
    ft = (x.reshape(b * n, din) @ fc).reshape(b, n, hd) + bias_ft[None]
    a1 = x @ wa1 + bias_a1[None]
    a2 = x @ wa2 + bias_a2[None]
    if pe_pack is not None:
        pe, wp, wpa1, wpa2 = pe_pack
        pos = pe.shape[1]
        pm = pe[None] * dropout.slot_mask(seed, dropout.STREAM_PE, b, n, pos,
                                          feat_drop, dev)
        ft = ft + (pm.reshape(b * n, pos) @ wp).reshape(b, n, hd)
        a1 = a1 + pm @ wpa1
        a2 = a2 + pm @ wpa2
    masks = None
    if attn_drop > 0:
        masks = dropout.attention_masks(seed, b, p, n - p - 1, heads,
                                        attn_drop, dev)
    out_gp, out_anchor, out_sib, gp_mask = _star_attention_train(
        ft.reshape(b, n, heads, hd // heads), a1, a2, ngp, p, masks)
    if pooled:
        sib_mask = (torch.arange(n - p - 1, device=dev)[None, :]
                    < nsib[:, None].long())[..., None, None]
        pool_gp = (out_gp * gp_mask[..., None]).sum(dim=1).mean(dim=1)
        pool_sib = (out_sib * sib_mask).sum(dim=1).mean(dim=1)
        return torch.stack([pool_gp, out_anchor.mean(dim=1), pool_sib], dim=1)
    out = torch.cat([out_gp, out_anchor[:, None], out_sib], dim=1).reshape(
        b, n, hd)
    if out_alpha is not None:
        out = _leaky(out, out_alpha)
    return out


_GRAD_NAMES = ("x", "fc", "wa1", "wa2", "bias_ft", "bias_a1", "bias_a2")
_PE_NAMES = ("pe", "wp", "wpa1", "wpa2")


def gat_layer_bwd_plain(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                        nsib, p: int, heads: int, *, pe_pack=None,
                        seed: int = 0, feat_drop: float = 0.0,
                        attn_drop: float = 0.0, out_alpha=None,
                        pooled: bool = False, need_dx: bool = True) -> dict:
    """Plain backward: torch.autograd.grad through `gat_layer_train_plain`
    with the same seed, so the same masks. Returns {name: grad} for x
    (None unless need_dx), fc, wa1, wa2, the slot biases and, on the pe
    path, pe, wp, wpa1, wpa2."""
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
            out_alpha=out_alpha, pooled=pooled)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    res = dict(zip(names, grads))
    if not need_dx:
        res["x"] = None
    return res


# ------------------------------------------------------------------ checks

def _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
           pe_pack=None, extra=()):
    b, n, din = x.shape
    hd = fc.shape[1]
    if hd % heads:
        raise ValueError(f"fc width {hd} is not a multiple of heads {heads}")
    shapes = {"fc": (fc, (din, hd)), "wa1": (wa1, (din, heads)),
              "wa2": (wa2, (din, heads)), "bias_ft": (bias_ft, (n, hd)),
              "bias_a1": (bias_a1, (n, heads)),
              "bias_a2": (bias_a2, (n, heads)), "ngp": (ngp, (b,)),
              "nsib": (nsib, (b,))}
    if pe_pack is not None:
        pe, wp, wpa1, wpa2 = pe_pack
        pos = pe.shape[-1]
        shapes.update({"pe": (pe, (n, pos)), "wp": (wp, (pos, hd)),
                       "wpa1": (wpa1, (pos, heads)),
                       "wpa2": (wpa2, (pos, heads))})
    shapes.update(dict(extra))
    check_operands(x, shapes)
    check_star(x, p)
    # a launch whose shared memory (gat::smem_bytes, about 0.5 KB a slot;
    # about 1 KB in the backward) exceeds the device's limit comes back as
    # an error and raises


# ----------------------------------------------------------------- forwards

def _fwd_cuda(what: str, pooled: bool, x, fc, wa1, wa2, bias_ft, bias_a1,
              bias_a2, ngp, nsib, p, heads, out_alpha=None, train=None):
    """Check, allocate and launch one forward kernel; `train` = (pe_pack,
    seed, feat_drop, attn_drop) selects the train form."""
    pe_pack = train[0] if train is not None else None
    _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
           pe_pack)
    ta = train_args(*train) if train is not None else None
    lib = _lib()
    b, n, din = x.shape
    dh = fc.shape[1] // heads
    shape = (b, 3, dh) if pooled else (b, n, heads * dh)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    args = [t.data_ptr() for t in (x, fc, wa1, wa2, bias_ft, bias_a1,
                                   bias_a2, ngp, nsib, out)]
    args += [b, n, din, heads, dh, p, LEAKY_ALPHA]
    if not pooled:
        args += [0.0 if out_alpha is None else float(out_alpha),
                 0 if out_alpha is None else 1]
    if ta is not None:
        args.append(ctypes.byref(ta))
    fn = getattr(lib, f"{'gat_layer_pooled_fwd' if pooled else 'gat_layer_fwd'}"
                      f"{'_train' if train is not None else ''}_f32")
    with torch.cuda.device(x.device):
        rc = fn(*args, stream(x))
    raise_on(lib, rc, what, "gat_fwd_error_string")
    return out


def gat_layer_fwd(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                  p: int, heads: int, out_alpha=None) -> torch.Tensor:
    """One star-GAT layer, per-slot output [B, N, H*Dh] (float32).

    x [B, N, Din]; fc [Din, H*Dh] (head-major columns); wa1/wa2 [Din, H]
    (fc folded with attn_l / attn_r); slot biases bias_ft [N, H*Dh],
    bias_a1/bias_a2 [N, H]; ngp/nsib [B] int32; p = anchor slot;
    out_alpha: fused leaky_relu slope of the output, or None."""
    ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads)
    if not on_cuda(x, "gat_layer_fwd"):
        return gat_layer_fwd_plain(*ops, out_alpha)
    out = _fwd_cuda("gat_layer_fwd", False, *ops, out_alpha=out_alpha)
    if x.shape[0]:
        gat_layer_fwd.launches += 1
    return out


def gat_layer_pooled_fwd(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                         nsib, p: int, heads: int) -> torch.Tensor:
    """Final star-GAT layer with the head mean and the per-class readout
    pools fused in: returns pools [B, 3, Dh] (float32) and never writes the
    [B, N, H*Dh] activation. Arguments as `gat_layer_fwd`."""
    ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads)
    if not on_cuda(x, "gat_layer_pooled_fwd"):
        return gat_layer_pooled_fwd_plain(*ops)
    out = _fwd_cuda("gat_layer_pooled_fwd", True, *ops)
    if x.shape[0]:
        gat_layer_pooled_fwd.launches += 1
    return out


def gat_layer_fwd_train(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                        nsib, p: int, heads: int, *, pe_pack=None,
                        seed: int = 0, feat_drop: float = 0.0,
                        attn_drop: float = 0.0,
                        out_alpha=None) -> torch.Tensor:
    """Train form of `gat_layer_fwd`: input-feature dropout (feat_drop),
    attention dropout (attn_drop) and the pe path (pe_pack, see
    `gat_layer_train_plain`), masks drawn from `seed`."""
    ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads)
    if not on_cuda(x, "gat_layer_fwd_train"):
        return gat_layer_train_plain(*ops, pe_pack=pe_pack, seed=seed,
                                     feat_drop=feat_drop,
                                     attn_drop=attn_drop, out_alpha=out_alpha)
    out = _fwd_cuda("gat_layer_fwd_train", False, *ops, out_alpha=out_alpha,
                    train=(pe_pack, seed, feat_drop, attn_drop))
    if x.shape[0]:
        gat_layer_fwd_train.launches += 1
    return out


def gat_layer_pooled_fwd_train(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                               ngp, nsib, p: int, heads: int, *,
                               pe_pack=None, seed: int = 0,
                               feat_drop: float = 0.0,
                               attn_drop: float = 0.0) -> torch.Tensor:
    """Train form of `gat_layer_pooled_fwd` (see `gat_layer_fwd_train`)."""
    ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads)
    if not on_cuda(x, "gat_layer_pooled_fwd_train"):
        return gat_layer_train_plain(*ops, pe_pack=pe_pack, seed=seed,
                                     feat_drop=feat_drop,
                                     attn_drop=attn_drop, pooled=True)
    out = _fwd_cuda("gat_layer_pooled_fwd_train", True, *ops,
                    train=(pe_pack, seed, feat_drop, attn_drop))
    if x.shape[0]:
        gat_layer_pooled_fwd_train.launches += 1
    return out


# ---------------------------------------------------------------- backwards

def _bwd_cuda(pooled: bool, g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
              ngp, nsib, p, heads, pe_pack, seed, feat_drop, attn_drop,
              out_alpha, need_dx, need_dbias) -> dict:
    b, n, din = x.shape
    hd = fc.shape[1]
    dh = hd // heads
    g_shape = (b, 3, dh) if pooled else (b, n, hd)
    _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads,
           pe_pack, extra=[("g", (g, g_shape))])
    ta = train_args(pe_pack, seed, feat_drop, attn_drop)
    pos = ta.pos
    dev = x.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa
                                       device=dev)
    grads = {"x": empty(b, n, din) if need_dx else None,
             "fc": empty(din, hd), "wa1": empty(din, heads),
             "wa2": empty(din, heads)}
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
    if (m + 63) // 64 > 65535:
        raise ValueError(f"B * N = {m} rows exceed the dx grid (4,194,240)")
    wd = hd + 2 * heads
    kx = din + pos
    splits = product_splits(x, m, kx, wd)
    chunks = min(b, 64)
    work = {"dcat": empty(m, wd), "part_w": empty(splits, kx, wd),
            "part_b": empty(chunks, n, wd) if need_dbias else None,
            "pe_rows": empty(m, pos) if pos else None,
            "part_pe": empty(chunks, n, pos) if pos else None}
    args = _BwdArgs()
    ptrs = {"x": x, "fc": fc, "wa1": wa1, "wa2": wa2, "bias_ft": bias_ft,
            "bias_a1": bias_a1, "bias_a2": bias_a2, "ngp": ngp,
            "nsib": nsib, "g": g, **work, "dx": grads["x"],
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
                    ("splits", splits), ("chunks", chunks)):
        setattr(args, name, v)
    args.alpha = LEAKY_ALPHA
    args.out_alpha = 0.0 if out_alpha is None else float(out_alpha)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.gat_layer_bwd_f32(ctypes.byref(args), ctypes.byref(ta),
                                   stream(x))
    what = "gat_layer_pooled_bwd" if pooled else "gat_layer_bwd"
    raise_on(lib, rc, what, "gat_bwd_error_string")
    return grads


def gat_layer_bwd(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                  p: int, heads: int, *, pe_pack=None, seed: int = 0,
                  feat_drop: float = 0.0, attn_drop: float = 0.0,
                  out_alpha=None, need_dx: bool = True,
                  need_dbias: bool = True) -> dict:
    """Backward of `gat_layer_fwd[_train]` for the incoming grad g
    [B, N, H*Dh]: {x (need_dx), fc, wa1, wa2, bias_ft, bias_a1, bias_a2
    (need_dbias), and with pe_pack pe, wp, wpa1, wpa2}."""
    if not on_cuda(x, "gat_layer_bwd"):
        return gat_layer_bwd_plain(
            g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
            heads, pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
            attn_drop=attn_drop, out_alpha=out_alpha, need_dx=need_dx)
    res = _bwd_cuda(False, g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                    ngp, nsib, p, heads, pe_pack, seed, feat_drop,
                    attn_drop, out_alpha, need_dx, need_dbias)
    if x.shape[0]:
        gat_layer_bwd.launches += 1
    return res


def gat_layer_pooled_bwd(g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                         nsib, p: int, heads: int, *, pe_pack=None,
                         seed: int = 0, feat_drop: float = 0.0,
                         attn_drop: float = 0.0, need_dx: bool = True,
                         need_dbias: bool = True) -> dict:
    """Backward of `gat_layer_pooled_fwd[_train]` for the pool grads g
    [B, 3, Dh]; returns as `gat_layer_bwd`."""
    if not on_cuda(x, "gat_layer_pooled_bwd"):
        return gat_layer_bwd_plain(
            g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
            heads, pe_pack=pe_pack, seed=seed, feat_drop=feat_drop,
            attn_drop=attn_drop, pooled=True, need_dx=need_dx)
    res = _bwd_cuda(True, g, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                    ngp, nsib, p, heads, pe_pack, seed, feat_drop,
                    attn_drop, None, need_dx, need_dbias)
    if x.shape[0]:
        gat_layer_pooled_bwd.launches += 1
    return res


for _w in (gat_layer_fwd, gat_layer_pooled_fwd, gat_layer_fwd_train,
           gat_layer_pooled_fwd_train, gat_layer_bwd, gat_layer_pooled_bwd):
    _w.launches = 0
WRAPPERS = {w.__name__: w for w in (
    gat_layer_fwd, gat_layer_pooled_fwd, gat_layer_fwd_train,
    gat_layer_pooled_fwd_train, gat_layer_bwd, gat_layer_pooled_bwd)}


# --------------------------------------------------- differentiable layers

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


class _GatLayerFn(torch.autograd.Function):
    """Forward: the train-form kernel (or the eval kernel when no dropout is
    on); backward: K2 / K4. On CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, cfg, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                nsib, *pe_pack):
        pe_pack = tuple(pe_pack) or None
        ctx.cfg = cfg
        ctx.save_for_backward(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                              ngp, nsib, *(pe_pack or ()))
        ops = (x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
               cfg.p, cfg.heads)
        dropping = cfg.feat_drop > 0 or cfg.attn_drop > 0
        train_kw = dict(pe_pack=pe_pack, seed=cfg.seed,
                        feat_drop=cfg.feat_drop, attn_drop=cfg.attn_drop)
        if cfg.pooled:
            if dropping:
                return gat_layer_pooled_fwd_train(*ops, **train_kw)
            return gat_layer_pooled_fwd(*ops)
        if dropping:
            return gat_layer_fwd_train(*ops, out_alpha=cfg.out_alpha,
                                       **train_kw)
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
                  need_dbias=any(needs[5:8]))
        if cfg.pooled:
            grads = gat_layer_pooled_bwd(g.contiguous(), *saved[:9], cfg.p,
                                         cfg.heads, **kw)
        else:
            grads = gat_layer_bwd(g.contiguous(), *saved[:9], cfg.p,
                                  cfg.heads, out_alpha=cfg.out_alpha, **kw)
        out = [None] + [grads[k] for k in _GRAD_NAMES] + [None, None]
        if pe_pack is not None:
            out += [grads[k] for k in _PE_NAMES]
        return tuple(out)


def gat_layer(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p: int,
              heads: int, *, pe_pack=None, seed: int = 0,
              feat_drop: float = 0.0, attn_drop: float = 0.0,
              out_alpha=None, need_dx: bool = True) -> torch.Tensor:
    """Differentiable star-GAT layer, [B, N, H*Dh] (the port of the
    `fused_gat_layer` custom_vjp). need_dx=False: the caller guarantees x's
    grad is never used (layer 0's fixed input features) and the backward
    skips the dx product."""
    cfg = _LayerCfg(p, heads, int(seed), float(feat_drop), float(attn_drop),
                    None if out_alpha is None else float(out_alpha),
                    bool(need_dx), False)
    return _GatLayerFn.apply(cfg, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                             ngp, nsib, *(pe_pack or ()))


def gat_layer_pooled(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                     p: int, heads: int, *, pe_pack=None, seed: int = 0,
                     feat_drop: float = 0.0, attn_drop: float = 0.0,
                     need_dx: bool = True) -> torch.Tensor:
    """Differentiable final star-GAT layer with the pools fused in,
    [B, 3, Dh] (the port of `fused_gat_layer_pooled`)."""
    cfg = _LayerCfg(p, heads, int(seed), float(feat_drop), float(attn_drop),
                    None, bool(need_dx), True)
    return _GatLayerFn.apply(cfg, x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                             ngp, nsib, *(pe_pack or ()))
