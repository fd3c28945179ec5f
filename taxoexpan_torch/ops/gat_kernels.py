"""The star-GAT layer kernels of the serving path, their plain PyTorch
versions and their launch counters.

`gat_layer_fwd` replaces the forward of `fused_gat_layer`
(taxoexpan_tpu/ops/pallas_gat.py:838, body `_fwd_kernel` :315) and
`gat_layer_pooled_fwd` the forward of `fused_gat_layer_pooled` (:1105,
body `_fwd_pool_kernel` :372), in eval form (no dropout). The CUDA source is
`ops/csrc/gat_fwd.cu`; its header states what bounds the kernels on an H100
(the float32 x @ fc product) and what the design does about it.

Dispatch is by the device of the tensors: on the CPU a wrapper runs its
plain version; on CUDA it launches the kernel or raises. There is no
fallback from one to the other. Each wrapper counts its launches in
`<wrapper>.launches`, incremented only where the kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, star

LEAKY_ALPHA = 0.2   # attention logits (GATLayer default); the inter-layer
                    # activation fused through `out_alpha` is 0.01

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# C signatures of ops/csrc/gat_fwd.cu: 10 pointers (x, fc, wa1, wa2, bias_ft,
# bias_a1, bias_a2, ngp, nsib, out), b, n, din, heads, dh, p, alpha, ...
_COMMON = [_P] * 10 + [_I] * 6 + [_F]
_SIGNATURES = {
    "gat_layer_fwd_f32": (_COMMON + [_F, _I, _P], _I),
    "gat_layer_pooled_fwd_f32": (_COMMON + [_P], _I),
    "gat_fwd_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return cuda_build.load("gat_fwd", _SIGNATURES)


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


# ------------------------------------------------------------------ wrappers

def _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p, heads):
    b, n, din = x.shape
    hd = fc.shape[1]
    if hd % heads:
        raise ValueError(f"fc width {hd} is not a multiple of heads {heads}")
    shapes = {"fc": (fc, (din, hd)), "wa1": (wa1, (din, heads)),
              "wa2": (wa2, (din, heads)), "bias_ft": (bias_ft, (n, hd)),
              "bias_a1": (bias_a1, (n, heads)),
              "bias_a2": (bias_a2, (n, heads)), "ngp": (ngp, (b,)),
              "nsib": (nsib, (b,))}
    for name, (t, want) in [("x", (x, (b, n, din)))] + list(shapes.items()):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        want_dtype = torch.int32 if name in ("ngp", "nsib") else torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"{want_dtype} only")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if not 0 <= p < n:
        raise ValueError(f"anchor slot p={p} outside [0, {n})")
    # a launch whose shared memory (smem_bytes in gat_fwd.cu, about 0.5 KB
    # a slot) exceeds the device's limit comes back as an error and raises
    return _lib()


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gat_fwd_error_string(rc).decode()})")


def gat_layer_fwd(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib,
                  p: int, heads: int, out_alpha=None) -> torch.Tensor:
    """One star-GAT layer, per-slot output [B, N, H*Dh] (float32).

    x [B, N, Din]; fc [Din, H*Dh] (head-major columns); wa1/wa2 [Din, H]
    (fc folded with attn_l / attn_r); slot biases bias_ft [N, H*Dh],
    bias_a1/bias_a2 [N, H]; ngp/nsib [B] int32; p = anchor slot;
    out_alpha: fused leaky_relu slope of the output, or None."""
    if x.device.type == "cpu":
        return gat_layer_fwd_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                   bias_a2, ngp, nsib, p, heads, out_alpha)
    if x.device.type != "cuda":
        raise ValueError(f"gat_layer_fwd: unsupported device {x.device}")
    lib = _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
                 heads)
    b, n, din = x.shape
    hd = fc.shape[1]
    out = torch.empty((b, n, hd), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.gat_layer_fwd_f32(
            x.data_ptr(), fc.data_ptr(), wa1.data_ptr(), wa2.data_ptr(),
            bias_ft.data_ptr(), bias_a1.data_ptr(), bias_a2.data_ptr(),
            ngp.data_ptr(), nsib.data_ptr(), out.data_ptr(), b, n, din,
            heads, hd // heads, p, LEAKY_ALPHA,
            0.0 if out_alpha is None else float(out_alpha),
            0 if out_alpha is None else 1, stream)
    _raise_on(lib, rc, "gat_layer_fwd")
    gat_layer_fwd.launches += 1
    return out


def gat_layer_pooled_fwd(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp,
                         nsib, p: int, heads: int) -> torch.Tensor:
    """Final star-GAT layer with the head mean and the per-class readout
    pools fused in: returns pools [B, 3, Dh] (float32) and never writes the
    [B, N, H*Dh] activation. Arguments as `gat_layer_fwd`."""
    if x.device.type == "cpu":
        return gat_layer_pooled_fwd_plain(x, fc, wa1, wa2, bias_ft, bias_a1,
                                          bias_a2, ngp, nsib, p, heads)
    if x.device.type != "cuda":
        raise ValueError(f"gat_layer_pooled_fwd: unsupported device "
                         f"{x.device}")
    lib = _check(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib, p,
                 heads)
    b, n, din = x.shape
    dh = fc.shape[1] // heads
    pools = torch.empty((b, 3, dh), dtype=torch.float32, device=x.device)
    if b == 0:
        return pools
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.gat_layer_pooled_fwd_f32(
            x.data_ptr(), fc.data_ptr(), wa1.data_ptr(), wa2.data_ptr(),
            bias_ft.data_ptr(), bias_a1.data_ptr(), bias_a2.data_ptr(),
            ngp.data_ptr(), nsib.data_ptr(), pools.data_ptr(), b, n, din,
            heads, dh, p, LEAKY_ALPHA, stream)
    _raise_on(lib, rc, "gat_layer_pooled_fwd")
    gat_layer_pooled_fwd.launches += 1
    return pools


gat_layer_fwd.launches = 0
gat_layer_pooled_fwd.launches = 0
