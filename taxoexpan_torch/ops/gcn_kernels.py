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

The bf16 form (the Pallas kernel called with x in bf16): x and w in bf16
together (a mix raises), b, z_bias and the pe path's rows float32; the
output, dx and dW in bf16, db, d z_bias, dpe and dW_p float32. Every
wrapper then launches the `*_bf16` kernel, which follows the reference's
roundings (pallas_gcn.py:69-78, :124-126, :163, :209-223): x times its
mask rounded to bf16, the pe rows times their float32 mask and W_p rounded
to bf16, the products on bf16 operands with float32 accumulation, z and
the star passes float32, the output rounded to bf16; g upcast, dz cast to
bf16 for dW and dx, dx times its float32 mask, rounded to bf16. The plain
versions compute the same roundings (`launch.bf16_operands`,
`_bwd_plain_bf16`). No model path reaches it: the JAX TaxoExpan passes no
dtype to GCN, nor does the port's; a direct call does.

On the card a call of either dtype takes a form by shape (`form`): at N <=
64 (every configuration) the valid-rows form (the forward packs the valid
rows of whole egonets into 64-row tiles and runs the star pass in the
product's epilogue, so z never reaches device memory; the backward
compacts the valid rows, recomputes z on them and writes dz once,
compacted, for dW and dx on those rows), else the two-pass form (the
layer's product as a projection over all B*N rows into z, `gcn_projection`
alone, then a star pass, `gcn_star` alone; neither is in WRAPPERS).
`use_form` picks one for timing and comparison. Both give the same
outputs, dx, db and d z_bias bits.

Dispatch is by the device of the tensors: on the CPU a wrapper runs its
plain version; on CUDA it launches the kernel or raises. Each wrapper
counts its launches in `<wrapper>.launches` (the float32 kernel) and
`<wrapper>.launches_bf16` (the bf16 kernel), and by form in
`<wrapper>.launches_by_form` (both dtypes), incremented only where that
kernel is launched. `gcn_layer` is the differentiable layer (the port of
the `fused_gcn_layer` custom_vjp): it saves the layer inputs and the seed,
and its backward replays the masks and recomputes z where leaky' needs it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import torch

from . import cuda_build, dropout, star
from .launch import (F, I, P, TrainArgs, bf16_operands, check_operands,
                     check_star, chunk_elems, count_launch, is_bf16,
                     needs_staging, on_cuda, pass_times, product_splits,
                     product_work, raise_on, round_bf16, round_up, stream,
                     train_args, weight_work)

_POINTERS = ("x", "w", "bias", "z_bias", "ngp", "nsib", "g", "out", "z",
             "g2sum", "part_w", "part_b", "pe_rows", "part_pe", "dx", "dw",
             "db", "dzb", "dpe", "dwp", "xm", "wcat", "biascat", "wt",
             "dzp", "row_off", "row_map", "row_info", "dzf", "bt")
_INTS = ("b", "n", "din", "dout", "p", "has_alpha", "need_dx", "need_dzb",
         "splits", "chunks", "kxp", "ldd", "ntp", "rows")


class _GcnArgs(ctypes.Structure):
    """GcnArgsT of ops/csrc/gcn.cu, field by field (either element type:
    its fields are pointers and ints)."""
    _fields_ = ([(name, P) for name in _POINTERS] +
                [(name, I) for name in _INTS] + [("alpha", F)])


_ARGS = ctypes.POINTER(_GcnArgs)
_TA = ctypes.POINTER(TrainArgs)
SIGNATURES = {
    # a float32 (_f32) and a bf16 (_bf16) form
    **{f"gcn_{name}_{sfx}": ([_ARGS, _TA, P], I)
       for name in ("layer_fwd", "projection", "layer_bwd")
       for sfx in ("f32", "bf16")},
    # z, ldz, bias, ngp, nsib, out, b, n, dout, p, has_alpha, alpha, stream
    "gcn_star_f32": ([P, I] + [P] * 4 + [I] * 5 + [F, P], I),
    "gcn_fwd_set_timing": ([I], I),
    "gcn_fwd_pass_ms": ([P], I),
    "gcn_bwd_set_timing": ([I], I),
    "gcn_bwd_pass_ms": ([P], I),
    "gcn_error_string": ([I], ctypes.c_char_p),
}
# what the pass times of `pass_times` measure, in order, by form
FWD_PASSES = {"two_pass": ("stage_pack", "projection", "star"),
              "valid_rows": ("rows", "stage_pack", "product_star")}
BWD_PASSES = {"two_pass": ("stage_pack", "projection", "dz", "dbias", "dw",
                           "dx"),
              "valid_rows": ("rows_stage_pack", "projection", "dz_rows",
                             "dbias", "dw", "dx")}
# rows after the valid ones, zero in X and dz (csrc/bwd_common.cuh:kRowPad)
ROW_PAD = 64
# rows of the forward's packed tiles (csrc/gcn.cu:kPackTile): the
# valid-rows form takes N <= PACK_TILE
PACK_TILE = 64
_FORCED: list = []   # `use_form`'s choice, innermost last


def form(x: torch.Tensor) -> str:
    """The form of a K5 layer call (forward or backward) on the card, for
    either dtype: "valid_rows" at N <= PACK_TILE (the forward packs the
    valid rows of whole egonets into 64-row tiles and runs the star pass in
    the product's epilogue; the backward compacts them, K4's way),
    "two_pass" otherwise (the projection over all B*N rows into z, then the
    star pass). Inside `use_form(name)` a call takes `name`."""
    if _FORCED:
        return _FORCED[-1]
    return "valid_rows" if x.shape[1] <= PACK_TILE else "two_pass"


@contextlib.contextmanager
def use_form(name: str):
    """The K5 calls inside, of either dtype, take the form `name`:
    "two_pass" (the form of every shape before the valid-rows form
    existed, so that both can be timed and their results compared on the
    same inputs) or "valid_rows" (N <= PACK_TILE)."""
    if name not in FWD_PASSES:
        raise ValueError(f"unknown K5 form {name!r}")
    _FORCED.append(name)
    try:
        yield
    finally:
        _FORCED.pop()


def _lib() -> ctypes.CDLL:
    return cuda_build.load("gcn", SIGNATURES)


def _entry(name: str, x) -> str:
    """The C entry point of `name` for x's dtype."""
    return f"gcn_{name}_{'bf16' if is_bf16(x) else 'f32'}"


# ------------------------------------------------------------ plain versions

def _leaky(v, alpha):
    return torch.where(v >= 0, v, alpha * v)


def _projection_bf16(x, w, z_bias, pe_pack, seed: int, drop: float):
    """A bf16 layer's z = X @ W + z_bias [B, N, Dout], float32, and its
    operands (`launch.bf16_operands`)."""
    bsz, n, _ = x.shape
    pe, wp = pe_pack if pe_pack is not None else (None, None)
    xs, wcat, fmask, pmask = bf16_operands(x, w, pe, wp, seed, drop)
    z = (xs @ wcat).reshape(bsz, n, -1) + z_bias[None]
    return z, (xs, wcat, fmask, pmask)


def gcn_projection_plain(x, w, z_bias, *, pe_pack=None, seed: int = 0,
                         drop: float = 0.0) -> torch.Tensor:
    """Plain version of `gcn_projection`: z = [x*m | pe*m_pe] @ [W_h; W_p]
    + z_bias, [B, N, Dout] float32 (the masks of ops/dropout.py when drop
    > 0; for a bf16 x the bf16 roundings, `_projection_bf16`)."""
    if is_bf16(x):
        return _projection_bf16(x, w, z_bias, pe_pack, seed, drop)[0]
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
    return z


def gcn_star_plain(z, b, ngp, nsib, p: int, alpha=None) -> torch.Tensor:
    """Plain version of `gcn_star`: act(norm * copy_src_sum(norm * z) + b),
    [B, N, Dout], from the projection z [B, N, Dout]."""
    norm = star.gcn_norm(ngp, nsib, p, z.shape[1])
    out = star.copy_src_sum(z * norm, ngp, nsib, p) * norm + b
    return out if alpha is None else _leaky(out, alpha)


def gcn_layer_train_plain(x, w, b, z_bias, ngp, nsib, p: int, *,
                          pe_pack=None, seed: int = 0, drop: float = 0.0,
                          alpha=None) -> torch.Tensor:
    """Plain PyTorch version of the train form (and, at drop 0, of the eval
    form), differentiable by autograd: [B, N, Dout] in x's dtype. pe_pack =
    (pe [N, pos], wp [pos, Dout]): the pe path (requires drop > 0). The
    masks come from ops/dropout.py, exactly the kernel's bits."""
    z = gcn_projection_plain(x, w, z_bias, pe_pack=pe_pack, seed=seed,
                             drop=drop)
    return gcn_star_plain(z, b, ngp, nsib, p, alpha).to(x.dtype)


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
    with the same seed, so the same masks (for a bf16 x pass by pass,
    `_bwd_plain_bf16`). Returns {name: grad} for x (None unless need_dx),
    w, b, z_bias (None unless need_dzb) and, on the pe path, pe and wp."""
    if is_bf16(x):
        return _bwd_plain_bf16(g, x, w, b, z_bias, ngp, nsib, p, pe_pack,
                               seed, drop, alpha, need_dx, need_dzb)
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


def _bwd_plain_bf16(g, x, w, b, z_bias, ngp, nsib, p, pe_pack, seed, drop,
                    alpha, need_dx, need_dzb) -> dict:
    """The plain backward of a bf16 layer, pass by pass as the bf16 kernel
    runs it (pallas_gcn.py:_bwd_kernel :129): z recomputed from the staged
    X and packed W; dz and db through the float32 star pass by autograd, g
    upcast (:163); d z_bias dz's float32 sum over egonets; dz rounded to
    bf16 (:209) for dW = X^T dz (the x rows rounded to bf16, :217, :384;
    the pe rows' dwp float32, :223) and dX = dz W^T (dx times its float32
    mask, rounded to bf16, :211-214; the pe columns times theirs, summed
    over egonets into dpe, float32, :220-221)."""
    bsz, n, din = x.shape
    z, (xs, wcat, fmask, pmask) = _projection_bf16(x, w, z_bias, pe_pack,
                                                   seed, drop)
    z = z.detach().requires_grad_(True)
    bias = b.detach().requires_grad_(True)
    with torch.enable_grad():
        out = gcn_star_plain(z, bias, ngp, nsib, p, alpha)
        dz, db = torch.autograd.grad(out, (z, bias), g.float())
    d16 = round_bf16(dz.reshape(bsz * n, -1))
    dw = xs.T @ d16
    dxs = d16 @ wcat.T
    dx = dxs[:, :din] if fmask is None else dxs[:, :din] * fmask
    res = {"x": dx.reshape(bsz, n, din).to(x.dtype) if need_dx else None,
           "w": dw[:din].to(w.dtype), "b": db,
           "z_bias": dz.sum(dim=0) if need_dzb else None}
    if pe_pack is not None:
        pos = pe_pack[0].shape[1]
        res.update(pe=(dxs[:, din:] * pmask).reshape(bsz, n, pos).sum(dim=0),
                   wp=dw[din:])
    return res


# ------------------------------------------------------------------ launches

def _check(x, w, b, z_bias, ngp, nsib, p, pe_pack=None, g=None):
    """Shapes, device, dtype and layout of the operands; b, ngp, nsib and p
    None for the projection alone."""
    bsz, n, din = x.shape
    dout = w.shape[-1]
    shapes = {"w": (w, (din, dout)), "z_bias": (z_bias, (n, dout))}
    if p is not None:
        shapes.update(b=(b, (dout,)), ngp=(ngp, (bsz,)), nsib=(nsib, (bsz,)))
    if pe_pack is not None:
        pe, wp = pe_pack
        pos = pe.shape[-1]
        shapes.update(pe=(pe, (n, pos)), wp=(wp, (pos, dout)))
    if g is not None:
        shapes["g"] = (g, (bsz, n, dout))
    check_operands(x, shapes, low=("w", "g"))
    check_star(x, 0 if p is None else p)
    if (bsz * n + 63) // 64 > 65535:
        raise ValueError(f"B * N = {bsz * n} rows exceed the dx grid "
                         "(4,194,240)")


def _args(x, w, b, z_bias, ngp, nsib, p, alpha, ptrs: dict, **ints):
    args = _GcnArgs()
    for name, t in dict(x=x, w=w, bias=b, z_bias=z_bias, ngp=ngp, nsib=nsib,
                        **ptrs).items():
        setattr(args, name, t.data_ptr() if t is not None else None)
    bsz, n, din = x.shape
    for name, v in dict(b=bsz, n=n, din=din, dout=w.shape[1],
                        p=p or 0, has_alpha=int(alpha is not None),
                        **ints).items():
        setattr(args, name, v)
    args.alpha = 0.0 if alpha is None else float(alpha)
    return args


def _empty(x, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=x.device)


def _projection_work(x, dout: int, drop: float,
                     pos: int) -> tuple[dict, dict]:
    """Workspaces of the projection (csrc/gcn.cu), as (pointers, widths):
    z [B*N, ldd], X staged where `needs_staging` says so, W [kxp, ldd] and
    z_bias [N, ldd] in its layouts."""
    bsz, n, din = x.shape
    kx = din + pos
    pw = product_work(x, bsz * n, kx, dout, needs_staging(x, drop, pos), kx,
                      0)
    ldd = pw["wdp"]
    ptrs = {"z": _empty(x, bsz * n, ldd), "xm": pw["xm"],
            "wcat": weight_work(x, pw["kxp"], ldd),
            "biascat": _empty(x, n, ldd)}
    return ptrs, {"kxp": pw["kxp"], "ldd": ldd}


def _packed_work(x, dout: int, pos: int) -> tuple[dict, dict]:
    """Workspaces of the forward's valid-rows form (csrc/gcn.cu), as
    (pointers, widths): X packed [rows + ROW_PAD, kxp] in x's dtype, W in
    the product's layout (`weight_work`: [kxp, ldd] in bf16, W^T as hi /
    lo planes in float32), z_bias [N, ldd], the egonets' first packed rows
    [B + 1] and the packed rows' tables [rows + ROW_PAD] (original row,
    slot and egonet), where rows bounds the packed rows: next fit into
    64-row tiles needs fewer than 64 B and fewer than 2 B*N + 64. No z
    workspace: the product's epilogue runs the star pass."""
    bsz, n, din = x.shape
    c = chunk_elems(x)
    kxp, ldd = round_up(din + pos, c), round_up(dout, c)
    rows = min(PACK_TILE * bsz, 2 * bsz * n + PACK_TILE)
    i32 = torch.int32
    ptrs = {"xm": _empty(x, rows + ROW_PAD, kxp, dtype=x.dtype),
            "wcat": weight_work(x, kxp, ldd),
            "biascat": _empty(x, n, ldd),
            "row_off": _empty(x, bsz + 1, dtype=i32),
            "row_map": _empty(x, rows + ROW_PAD, dtype=i32),
            "row_info": _empty(x, rows + ROW_PAD, dtype=i32)}
    return ptrs, {"kxp": kxp, "ldd": ldd, "rows": rows}


def _fwd_cuda(what: str, entry: str, x, w, b, z_bias, ngp, nsib, p, alpha,
              train=None):
    """Check, allocate and launch a forward entry point (the layer, or the
    projection alone when p is None); `train` = (pe_pack, seed, drop)
    selects the train form. Returns (out or None, z [B, N, Dout], or None
    from the valid-rows form)."""
    pe_pack = train[0] if train is not None else None
    _check(x, w, b, z_bias, ngp, nsib, p, pe_pack)
    ta = train_args(*train) if train is not None else TrainArgs()
    bsz, n = x.shape[:2]
    dout = w.shape[1]
    out = _empty(x, bsz, n, dout, dtype=x.dtype) if p is not None else None
    if p is not None and form(x) == "valid_rows":
        ptrs, widths = _packed_work(x, dout, ta.pos)
        z = None
    else:
        ptrs, widths = _projection_work(x, dout, train[2] if train else 0.0,
                                        ta.pos)
        z = ptrs["z"].reshape(bsz, n, widths["ldd"])[..., :dout]
    if bsz == 0:
        return out, z
    args = _args(x, w, b, z_bias, ngp, nsib, p, alpha, {"out": out, **ptrs},
                 **widths)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(ctypes.byref(args), ctypes.byref(ta),
                                 stream(x))
    raise_on(lib, rc, what, "gcn_error_string")
    return out, z


def gcn_layer_fwd(x, w, b, z_bias, ngp, nsib, p: int,
                  alpha=None) -> torch.Tensor:
    """One star-GCN layer, [B, N, Dout] in x's dtype.

    x [B, N, Din]; w [Din, Dout] (W_h), both float32 or both bf16; b
    [Dout]; z_bias [N, Dout] (the position term pe @ W_p, or zeros); ngp/
    nsib [B] int32; p = anchor slot; alpha: fused leaky_relu slope, or None
    on the final layer."""
    ops = (x, w, b, z_bias, ngp, nsib, p)
    if not on_cuda(x, "gcn_layer_fwd"):
        return gcn_layer_fwd_plain(*ops, alpha)
    out, _ = _fwd_cuda("gcn_layer_fwd", _entry("layer_fwd", x), *ops, alpha)
    _count(gcn_layer_fwd, x)
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
    out, _ = _fwd_cuda("gcn_layer_fwd_train", _entry("layer_fwd", x), *ops,
                       alpha, train=(pe_pack, seed, drop))
    _count(gcn_layer_fwd_train, x)
    return out


def _bwd_cuda(g, x, w, b, z_bias, ngp, nsib, p, pe_pack, seed, drop, alpha,
              need_dx, need_dzb) -> dict:
    _check(x, w, b, z_bias, ngp, nsib, p, pe_pack, g)
    ta = train_args(pe_pack, seed, drop)
    bsz, n, din = x.shape
    dout, pos = w.shape[1], ta.pos
    empty = functools.partial(_empty, x)
    grads = {"x": empty(bsz, n, din, dtype=x.dtype) if need_dx else None,
             "w": empty(din, dout, dtype=x.dtype), "b": empty(dout),
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
    # the valid-rows form: X and dz compacted, ROW_PAD zero rows after them
    compact = form(x) == "valid_rows"
    rows = m + ROW_PAD if compact else m
    pw = product_work(x, rows, din + pos, dout,
                      compact or needs_staging(x, drop, pos),
                      0 if need_dx else din, splits)
    ldd = pw["wdp"]
    act = alpha is not None   # z recomputed for leaky'
    i32 = torch.int32
    work = {"g": g, "z": empty(m, ldd) if act or not compact else None,
            "g2sum": empty(bsz, dout),
            "wcat": weight_work(x, pw["kxp"], ldd) if act else None,
            "biascat": empty(n, ldd) if act else None,
            "part_w": pw["part_w"], "part_b": empty(chunks, n * ldd),
            "pe_rows": empty(m, pos) if pos else None,
            "part_pe": empty(chunks, n * pos) if pos else None,
            "dx": grads["x"], "dw": grads["w"], "db": grads["b"],
            "dzb": grads["z_bias"], "dpe": grads.get("pe"),
            "dwp": grads.get("wp"), "xm": pw["xm"], "wt": pw["wt"],
            "bt": pw["bt"],
            # the products' dz: compacted (the valid-rows form) or cast to
            # bf16 (the bf16 two-pass form); the float32 two-pass form's
            # products read z
            "dzp": (empty(rows, ldd, dtype=x.dtype)
                    if compact or is_bf16(x) else None),
            "row_off": empty(bsz + 1, dtype=i32) if compact else None,
            "row_map": empty(rows, dtype=i32) if compact else None,
            # the bf16 valid-rows form's float32 dz for d z_bias
            "dzf": (empty(m, ldd)
                    if compact and need_dzb and is_bf16(x) else None)}
    args = _args(x, w, b, z_bias, ngp, nsib, p, alpha, work,
                 need_dx=int(need_dx), need_dzb=int(need_dzb),
                 splits=splits, chunks=chunks, kxp=pw["kxp"], ldd=ldd,
                 ntp=pw["ntp"])
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, _entry("layer_bwd", x))(
            ctypes.byref(args), ctypes.byref(ta), stream(x))
    raise_on(lib, rc, "gcn_layer_bwd", "gcn_error_string")
    return grads


def gcn_layer_bwd(g, x, w, b, z_bias, ngp, nsib, p: int, *, pe_pack=None,
                  seed: int = 0, drop: float = 0.0, alpha=None,
                  need_dx: bool = True, need_dzb: bool = True) -> dict:
    """Backward of `gcn_layer_fwd[_train]` for the incoming grad g
    [B, N, Dout] (in x's dtype): {x (need_dx), w, b, z_bias (need_dzb), and
    with pe_pack pe, wp}; x and w's grads in x's dtype, the others
    float32."""
    kw = dict(pe_pack=pe_pack, seed=seed, drop=drop, alpha=alpha,
              need_dx=need_dx, need_dzb=need_dzb)
    if not on_cuda(x, "gcn_layer_bwd"):
        return gcn_layer_bwd_plain(g, x, w, b, z_bias, ngp, nsib, p, **kw)
    res = _bwd_cuda(g, x, w, b, z_bias, ngp, nsib, p, **kw)
    _count(gcn_layer_bwd, x)
    return res


def gcn_projection(x, w, z_bias, *, pe_pack=None, seed: int = 0,
                   drop: float = 0.0) -> torch.Tensor:
    """The projection of the layer alone, z = [x*m | pe*m_pe] @ [W_h; W_p]
    + z_bias, [B, N, Dout]: the first launch of `gcn_layer_fwd[_train]`
    and of `gcn_layer_bwd` with an activation, exposed for testing it on
    its own (the plain version on the CPU; on the card the kernel, counted
    in `gcn_projection.launches[_bf16]`, its rows dout rounded up to a
    16-byte multiple of x's dtype apart). float32 in either form."""
    kw = dict(pe_pack=pe_pack, seed=seed, drop=drop)
    if not on_cuda(x, "gcn_projection"):
        return gcn_projection_plain(x, w, z_bias, **kw)
    _, z = _fwd_cuda("gcn_projection", _entry("projection", x), x, w, None,
                     z_bias, None, None, None, None,
                     train=(pe_pack, seed, drop))
    count_launch(gcn_projection, x)
    return z


gcn_projection.launches = gcn_projection.launches_bf16 = 0


def gcn_star(z, b, ngp, nsib, p: int, alpha=None) -> torch.Tensor:
    """The star pass of `gcn_layer_fwd[_train]` alone, out [B, N, Dout]
    from a projection z [B, N, Dout] (rows may be wider apart, as
    `gcn_projection`'s output on the card is: its last dimension
    unit-strided). Exposed for testing the pass on its own (the plain
    version on the CPU; on the card the kernel, counted in
    `gcn_star.launches`)."""
    if not on_cuda(z, "gcn_star"):
        return gcn_star_plain(z, b, ngp, nsib, p, alpha)
    bsz, n, dout = z.shape
    if z.dtype != torch.float32 or z.stride(2) != 1 or (
            bsz > 1 and z.stride(0) != n * z.stride(1)):
        raise ValueError("z must be float32 [B, N, Dout] with unit-strided, "
                         "evenly spaced rows")
    for name, t, shape, dtype in (("b", b, (dout,), torch.float32),
                                  ("ngp", ngp, (bsz,), torch.int32),
                                  ("nsib", nsib, (bsz,), torch.int32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != z.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{z.device}")
    check_star(z, p)
    out = _empty(z, bsz, n, dout)
    lib = _lib()
    with torch.cuda.device(z.device):
        rc = lib.gcn_star_f32(
            z.data_ptr(), z.stride(1), b.data_ptr(), ngp.data_ptr(),
            nsib.data_ptr(), out.data_ptr(), bsz, n, dout, p,
            int(alpha is not None), 0.0 if alpha is None else float(alpha),
            stream(z))
    raise_on(lib, rc, "gcn_star", "gcn_error_string")
    if bsz:
        gcn_star.launches += 1
    return out


gcn_star.launches = 0


def fwd_pass_ms(call, form: str = "two_pass") -> dict:
    """Device ms of K5f's launches in one `call` of gcn_layer_fwd[_train]
    on the card, by FWD_PASSES[form] (the form the call takes, `form`)."""
    return dict(zip(FWD_PASSES[form], pass_times(_lib(), "gcn_fwd", call)))


def bwd_pass_ms(call, form: str = "two_pass") -> dict:
    """Device ms of K5b's passes in one `call` of gcn_layer_bwd on the
    card, by BWD_PASSES[form]."""
    return dict(zip(BWD_PASSES[form], pass_times(_lib(), "gcn_bwd", call)))


def _count(wrapper, x) -> None:
    """One launch of `wrapper`'s kernel: by dtype (`count_launch`) and by
    form in `wrapper.launches_by_form`."""
    if x.shape[0]:
        count_launch(wrapper, x)
        key = form(x)
        wrapper.launches_by_form[key] = \
            wrapper.launches_by_form.get(key, 0) + 1


WRAPPERS = {w.__name__: w for w in (gcn_layer_fwd, gcn_layer_fwd_train,
                                    gcn_layer_bwd)}
for _w in WRAPPERS.values():
    _w.launches = _w.launches_bf16 = 0
    _w.launches_by_form = {}


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
