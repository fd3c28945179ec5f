"""The star-GCN layer kernels (K5), their plain PyTorch versions, their
launch counters and the autograd Function around them.

    wrapper               replaces (taxoexpan_tpu/ops/pallas_gcn.py)
    gcn_layer_fwd         K5f eval: fused_gcn_layer fwd (:241, _fused_fwd
                          :256, _fwd_kernel :101)
    gcn_layer_fwd_train   K5f train form (feature and pe dropout, pe_pack)
    gcn_layer_bwd         K5b: fused_gcn_layer bwd (_fused_bwd :304,
                          _bwd_kernel :129)

All three are `ops/csrc/gcn.cu`, whose header states what bounds them on an
H100 and what the design does about it. One layer is

    z   = [x*m | pe*m_pe] @ [W_h; W_p] + z_bias
    out = act(norm * copy_src_sum(norm * z) + b)

with norm = rsqrt(in-degree) in closed form (ops/star.py:gcn_norm) and act
leaky_relu(alpha) on hidden layers, none on the final one. The eval form
has no masks and no pe rows (their term is the constant z_bias = pe @ W_p);
the train form draws the masks from ops/dropout.py (STREAM_FEAT over x,
STREAM_PE over the pe rows, row = b * N + slot), the kernels' own bits.

Dispatch is by the device of the tensors: on the CPU a wrapper runs its
plain version; on CUDA it launches the kernel or raises. Each wrapper
counts its launches in `<wrapper>.launches`, incremented only where the
kernel is launched. `gcn_layer` is the differentiable layer (the port of
the `fused_gcn_layer` custom_vjp): it saves the layer inputs and the seed,
and its backward replays the masks and recomputes z where leaky' needs it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import cuda_build, dropout, star
from .launch import (F, I, P, TrainArgs, check_operands, check_star,
                     needs_staging, on_cuda, pass_times, product_splits,
                     product_work, raise_on, stream, train_args)

_POINTERS = ("x", "w", "bias", "z_bias", "ngp", "nsib", "g", "out", "dz",
             "g2sum", "part_w", "part_b", "pe_rows", "part_pe", "dx", "dw",
             "db", "dzb", "dpe", "dwp", "xm", "wt")
_INTS = ("b", "n", "din", "dout", "p", "has_alpha", "need_dx", "need_dzb",
         "splits", "chunks", "kxp", "ldd", "ntp")


class _GcnArgs(ctypes.Structure):
    """GcnArgs of ops/csrc/gcn.cu, field by field."""
    _fields_ = ([(name, P) for name in _POINTERS] +
                [(name, I) for name in _INTS] + [("alpha", F)])


_ARGS = ctypes.POINTER(_GcnArgs)
_TA = ctypes.POINTER(TrainArgs)
SIGNATURES = {
    "gcn_layer_fwd_f32": ([_ARGS, _TA, I, P], I),
    "gcn_layer_bwd_f32": ([_ARGS, _TA, P], I),
    "gcn_bwd_set_timing": ([I], I),
    "gcn_bwd_pass_ms": ([P], I),
    "gcn_error_string": ([I], ctypes.c_char_p),
}
BWD_PASSES = ("dw", "dx")


def _lib() -> ctypes.CDLL:
    return cuda_build.load("gcn", SIGNATURES)


# ------------------------------------------------------------ plain versions

def _leaky(v, alpha):
    return torch.where(v >= 0, v, alpha * v)


def gcn_layer_train_plain(x, w, b, z_bias, ngp, nsib, p: int, *,
                          pe_pack=None, seed: int = 0, drop: float = 0.0,
                          alpha=None) -> torch.Tensor:
    """Plain PyTorch version of the train form (and, at drop 0, of the eval
    form), differentiable by autograd: [B, N, Dout]. pe_pack = (pe [N, pos],
    wp [pos, Dout]): the pe path (requires drop > 0). The masks come from
    ops/dropout.py, exactly the kernel's bits."""
    bsz, n, din = x.shape
    if drop > 0:
        x = x * dropout.slot_mask(seed, dropout.STREAM_FEAT, bsz, n, din,
                                  drop, x.device)
    z = (x.reshape(bsz * n, din) @ w).reshape(bsz, n, -1) + z_bias[None]
    if pe_pack is not None:
        pe, wp = pe_pack
        pm = pe[None] * dropout.slot_mask(seed, dropout.STREAM_PE, bsz, n,
                                          pe.shape[1], drop, x.device)
        z = z + (pm.reshape(bsz * n, -1) @ wp).reshape(bsz, n, -1)
    norm = star.gcn_norm(ngp, nsib, p, n)
    out = star.copy_src_sum(z * norm, ngp, nsib, p) * norm + b
    return out if alpha is None else _leaky(out, alpha)


def gcn_layer_fwd_plain(x, w, b, z_bias, ngp, nsib, p: int,
                        alpha=None) -> torch.Tensor:
    """Plain PyTorch version of `gcn_layer_fwd`."""
    return gcn_layer_train_plain(x, w, b, z_bias, ngp, nsib, p, alpha=alpha)


_GRAD_NAMES = ("x", "w", "b", "z_bias")
_PE_NAMES = ("pe", "wp")


def gcn_layer_bwd_plain(g, x, w, b, z_bias, ngp, nsib, p: int, *,
                        pe_pack=None, seed: int = 0, drop: float = 0.0,
                        alpha=None, need_dx: bool = True,
                        need_dzb: bool = True) -> dict:
    """Plain backward: torch.autograd.grad through `gcn_layer_train_plain`
    with the same seed, so the same masks. Returns {name: grad} for x
    (None unless need_dx), w, b, z_bias (None unless need_dzb) and, on the
    pe path, pe and wp."""
    tensors = [x, w, b, z_bias] + list(pe_pack or ())
    names = list(_GRAD_NAMES) + (list(_PE_NAMES) if pe_pack else [])
    leaves = [t.detach().requires_grad_(True) for t in tensors]
    with torch.enable_grad():
        out = gcn_layer_train_plain(
            *leaves[:4], ngp, nsib, p,
            pe_pack=tuple(leaves[4:]) if pe_pack is not None else None,
            seed=seed, drop=drop, alpha=alpha)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    res = dict(zip(names, grads))
    if not need_dx:
        res["x"] = None
    if not need_dzb:
        res["z_bias"] = None
    return res


# ------------------------------------------------------------------ launches

def _check(x, w, b, z_bias, ngp, nsib, p, pe_pack=None, g=None):
    bsz, n, din = x.shape
    dout = w.shape[-1]
    shapes = {"w": (w, (din, dout)), "b": (b, (dout,)),
              "z_bias": (z_bias, (n, dout)), "ngp": (ngp, (bsz,)),
              "nsib": (nsib, (bsz,))}
    if pe_pack is not None:
        pe, wp = pe_pack
        pos = pe.shape[-1]
        shapes.update(pe=(pe, (n, pos)), wp=(wp, (pos, dout)))
    if g is not None:
        shapes["g"] = (g, (bsz, n, dout))
    check_operands(x, shapes)
    check_star(x, p)
    if (bsz * n + 63) // 64 > 65535:
        raise ValueError(f"B * N = {bsz * n} rows exceed the dx grid "
                         "(4,194,240)")


def _args(x, w, b, z_bias, ngp, nsib, p, alpha, ptrs: dict, **ints):
    args = _GcnArgs()
    for name, t in dict(x=x, w=w, bias=b, z_bias=z_bias, ngp=ngp, nsib=nsib,
                        **ptrs).items():
        setattr(args, name, t.data_ptr() if t is not None else None)
    bsz, n, din = x.shape
    for name, v in dict(b=bsz, n=n, din=din, dout=w.shape[1], p=p,
                        has_alpha=int(alpha is not None), **ints).items():
        setattr(args, name, v)
    args.alpha = 0.0 if alpha is None else float(alpha)
    return args


def _fwd_cuda(what: str, x, w, b, z_bias, ngp, nsib, p, alpha, train=None):
    """Check, allocate and launch the forward; `train` = (pe_pack, seed,
    drop) selects the train form."""
    pe_pack = train[0] if train is not None else None
    _check(x, w, b, z_bias, ngp, nsib, p, pe_pack)
    ta = train_args(*train) if train is not None else TrainArgs()
    out = torch.empty((*x.shape[:2], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    args = _args(x, w, b, z_bias, ngp, nsib, p, alpha, {"out": out})
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.gcn_layer_fwd_f32(ctypes.byref(args), ctypes.byref(ta),
                                   int(train is not None), stream(x))
    raise_on(lib, rc, what, "gcn_error_string")
    return out


def gcn_layer_fwd(x, w, b, z_bias, ngp, nsib, p: int,
                  alpha=None) -> torch.Tensor:
    """One star-GCN layer, [B, N, Dout] (float32).

    x [B, N, Din]; w [Din, Dout] (W_h); b [Dout]; z_bias [N, Dout] (the
    position term pe @ W_p, or zeros); ngp/nsib [B] int32; p = anchor slot;
    alpha: fused leaky_relu slope, or None on the final layer."""
    ops = (x, w, b, z_bias, ngp, nsib, p)
    if not on_cuda(x, "gcn_layer_fwd"):
        return gcn_layer_fwd_plain(*ops, alpha)
    out = _fwd_cuda("gcn_layer_fwd", *ops, alpha)
    if x.shape[0]:
        gcn_layer_fwd.launches += 1
    return out


def gcn_layer_fwd_train(x, w, b, z_bias, ngp, nsib, p: int, *, pe_pack=None,
                        seed: int = 0, drop: float = 0.0,
                        alpha=None) -> torch.Tensor:
    """Train form of `gcn_layer_fwd`: feature dropout over x and, with
    pe_pack = (pe [N, pos], wp [pos, Dout]), the masked pe rows' term,
    masks drawn from `seed`."""
    ops = (x, w, b, z_bias, ngp, nsib, p)
    if not on_cuda(x, "gcn_layer_fwd_train"):
        return gcn_layer_train_plain(*ops, pe_pack=pe_pack, seed=seed,
                                     drop=drop, alpha=alpha)
    out = _fwd_cuda("gcn_layer_fwd_train", *ops, alpha,
                    train=(pe_pack, seed, drop))
    if x.shape[0]:
        gcn_layer_fwd_train.launches += 1
    return out


def _bwd_cuda(g, x, w, b, z_bias, ngp, nsib, p, pe_pack, seed, drop, alpha,
              need_dx, need_dzb) -> dict:
    _check(x, w, b, z_bias, ngp, nsib, p, pe_pack, g)
    ta = train_args(pe_pack, seed, drop)
    bsz, n, din = x.shape
    dout, pos = w.shape[1], ta.pos
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa
                                       device=x.device)
    grads = {"x": empty(bsz, n, din) if need_dx else None,
             "w": empty(din, dout), "b": empty(dout),
             "z_bias": empty(n, dout) if need_dzb else None}
    if pe_pack is not None:
        grads.update(pe=empty(n, pos), wp=empty(pos, dout))
    if bsz == 0:
        for t in grads.values():
            if t is not None:
                t.zero_()
        return grads
    m = bsz * n
    splits = product_splits(x, m, din + pos, dout)
    chunks = min(bsz, 64)
    pw = product_work(x, m, din + pos, dout, needs_staging(x, drop, pos),
                      0 if need_dx else din, splits)
    ldd = pw["wdp"]
    work = {"g": g, "dz": empty(m, ldd), "g2sum": empty(bsz, dout),
            "part_w": pw["part_w"], "part_b": empty(chunks, n * ldd),
            "pe_rows": empty(m, pos) if pos else None,
            "part_pe": empty(chunks, n * pos) if pos else None,
            "dx": grads["x"], "dw": grads["w"], "db": grads["b"],
            "dzb": grads["z_bias"], "dpe": grads.get("pe"),
            "dwp": grads.get("wp"), "xm": pw["xm"], "wt": pw["wt"]}
    args = _args(x, w, b, z_bias, ngp, nsib, p, alpha, work,
                 need_dx=int(need_dx), need_dzb=int(need_dzb),
                 splits=splits, chunks=chunks, kxp=pw["kxp"], ldd=ldd,
                 ntp=pw["ntp"])
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.gcn_layer_bwd_f32(ctypes.byref(args), ctypes.byref(ta),
                                   stream(x))
    raise_on(lib, rc, "gcn_layer_bwd", "gcn_error_string")
    return grads


def gcn_layer_bwd(g, x, w, b, z_bias, ngp, nsib, p: int, *, pe_pack=None,
                  seed: int = 0, drop: float = 0.0, alpha=None,
                  need_dx: bool = True, need_dzb: bool = True) -> dict:
    """Backward of `gcn_layer_fwd[_train]` for the incoming grad g
    [B, N, Dout]: {x (need_dx), w, b, z_bias (need_dzb), and with pe_pack
    pe, wp}."""
    kw = dict(pe_pack=pe_pack, seed=seed, drop=drop, alpha=alpha,
              need_dx=need_dx, need_dzb=need_dzb)
    if not on_cuda(x, "gcn_layer_bwd"):
        return gcn_layer_bwd_plain(g, x, w, b, z_bias, ngp, nsib, p, **kw)
    res = _bwd_cuda(g, x, w, b, z_bias, ngp, nsib, p, **kw)
    if x.shape[0]:
        gcn_layer_bwd.launches += 1
    return res


def bwd_pass_ms(call) -> dict:
    """Device ms of K5b's product passes in one `call` of gcn_layer_bwd on
    the card, by BWD_PASSES."""
    return dict(zip(BWD_PASSES, pass_times(_lib(), "gcn_bwd", call)))


WRAPPERS = {w.__name__: w for w in (gcn_layer_fwd, gcn_layer_fwd_train,
                                    gcn_layer_bwd)}
for _w in WRAPPERS.values():
    _w.launches = 0


# --------------------------------------------------- the differentiable layer

@dataclass(frozen=True)
class _LayerCfg:
    p: int
    seed: int
    drop: float
    alpha: float | None
    need_dx: bool


class _GcnLayerFn(torch.autograd.Function):
    """Forward: the train-form kernel (or the eval kernel when no dropout is
    on); backward: K5b. On CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, cfg, x, w, b, z_bias, ngp, nsib, *pe_pack):
        pe_pack = tuple(pe_pack) or None
        ctx.cfg = cfg
        ctx.save_for_backward(x, w, b, z_bias, ngp, nsib, *(pe_pack or ()))
        ops = (x, w, b, z_bias, ngp, nsib, cfg.p)
        if cfg.drop > 0:
            return gcn_layer_fwd_train(*ops, pe_pack=pe_pack, seed=cfg.seed,
                                       drop=cfg.drop, alpha=cfg.alpha)
        return gcn_layer_fwd(*ops, alpha=cfg.alpha)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        pe_pack = tuple(saved[6:]) or None
        needs = ctx.needs_input_grad
        grads = gcn_layer_bwd(g.contiguous(), *saved[:6], cfg.p,
                              pe_pack=pe_pack, seed=cfg.seed, drop=cfg.drop,
                              alpha=cfg.alpha,
                              need_dx=cfg.need_dx and needs[1],
                              need_dzb=needs[4])
        out = [None] + [grads[k] for k in _GRAD_NAMES] + [None, None]
        if pe_pack is not None:
            out += [grads[k] for k in _PE_NAMES]
        return tuple(out)


def gcn_layer(x, w, b, z_bias, ngp, nsib, p: int, *, pe_pack=None,
              seed: int = 0, drop: float = 0.0, alpha=None,
              need_dx: bool = True) -> torch.Tensor:
    """Differentiable star-GCN layer, [B, N, Dout] (the port of the
    `fused_gcn_layer` custom_vjp). need_dx=False: the caller guarantees x's
    grad is never used (layer 0's fixed input features) and the backward
    skips the dx product."""
    cfg = _LayerCfg(p, int(seed), float(drop),
                    None if alpha is None else float(alpha), bool(need_dx))
    return _GcnLayerFn.apply(cfg, x, w, b, z_bias, ngp, nsib,
                             *(pe_pack or ()))
