"""Plumbing shared by the kernel wrappers (`gat_kernels.py`, `gcn_kernels.py`):
the train-form argument struct, operand checks, device dispatch, the stream
and launch errors, the launch counters by dtype, and the bf16 layers'
product operands for the plain versions."""
from __future__ import annotations

import ctypes

import torch

from . import dropout

P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741
F = ctypes.c_float


class TrainArgs(ctypes.Structure):
    """gat::TrainArgs of ops/csrc/gat_common.cuh, field by field."""
    _fields_ = [("pe", P), ("wp", P), ("wpa1", P), ("wpa2", P),
                ("pos", I), ("seed", ctypes.c_uint),
                ("feat_thresh", ctypes.c_uint), ("feat_scale", F),
                ("feat_on", I), ("attn_thresh", ctypes.c_uint),
                ("attn_scale", F), ("attn_on", I), ("bits8", I)]


def train_args(pe_pack, seed: int, feat_drop: float, attn_drop: float = 0.0,
               bits: int = 32) -> TrainArgs:
    """The TrainArgs of a train-form launch. pe_pack: the pe rows and their
    weight rows, (pe, wp, wpa1, wpa2) for the GAT layers, (pe, wp) for the
    GCN layer, or None. bits: the dropout thresholds' width, 32 or 8
    (ops/dropout.py)."""
    if pe_pack is not None and feat_drop <= 0:
        raise ValueError("pe_pack requires feat_drop > 0 — with no input "
                         "dropout precompute the exact per-slot biases")
    ta = TrainArgs()
    if pe_pack is not None:
        for name, t in zip(("pe", "wp", "wpa1", "wpa2"), pe_pack):
            setattr(ta, name, t.data_ptr())
        ta.pos = pe_pack[0].shape[1]
    ta.seed = seed & dropout.MASK32
    ta.bits8 = int(dropout.check_bits(bits) == 8)
    if feat_drop > 0:
        ta.feat_thresh = dropout.keep_threshold(feat_drop, bits)
        ta.feat_scale = dropout.keep_scale(feat_drop, bits)
        ta.feat_on = 1
    if attn_drop > 0:
        ta.attn_thresh = dropout.keep_threshold(attn_drop, bits)
        ta.attn_scale = dropout.keep_scale(attn_drop, bits)
        ta.attn_on = 1
    return ta


def check_operands(x: torch.Tensor, shapes: dict, low: tuple = ()) -> None:
    """Every operand {name: (tensor, expected shape)} and x itself: shape,
    x's device, float32 (int32 for ngp / nsib), contiguous. x and the
    operands named in `low` may instead all be bfloat16 together (a layer
    whose compute dtype is bf16); a mix of the two raises."""
    x_dtype = torch.bfloat16 if low and x.dtype == torch.bfloat16 \
        else torch.float32
    for name, (t, want) in [("x", (x, tuple(x.shape)))] + list(shapes.items()):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name in ("ngp", "nsib"):
            want_dtype = torch.int32
        elif name == "x" or name in low:
            want_dtype = x_dtype
        else:
            want_dtype = torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"{want_dtype} here (x is {x.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def is_bf16(x: torch.Tensor) -> bool:
    return x.dtype == torch.bfloat16


def count_launch(wrapper, x: torch.Tensor, heads: int | None = None) -> None:
    """One launch of `wrapper`'s float32 or bf16 kernel, by x's dtype; with
    `heads` (a star-GAT layer's heads on this rank) also under
    "<heads>" or "<heads>[bf16]" in `wrapper.launches_by_heads`."""
    if x.shape[0]:
        bf16 = is_bf16(x)
        if bf16:
            wrapper.launches_bf16 += 1
        else:
            wrapper.launches += 1
        if heads is not None:
            key = f"{heads}[bf16]" if bf16 else str(heads)
            counts = wrapper.launches_by_heads
            counts[key] = counts.get(key, 0) + 1


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def bf16_operands(x, w, pe, wp, seed: int, drop: float, bits: int = 32):
    """A bf16 layer's product operands as its kernels stage and pack them,
    in float32 tensors holding bf16 values: X = [x*m | pe*m_pe] [B*N, din +
    pos] (x times its mask rounded to bf16, the product rounded; the pe
    rows [N, pos] times their float32 mask, rounded), W = [w; wp] (w [din,
    wd]; wp [pos, wd] rounded to bf16), and the float32 masks (x's [B*N,
    din], the pe rows' [B*N, pos]; None without dropout / a pe path) that
    dx and the pe rows' grads take. pe and wp are None without a pe path;
    `bits`: the masks' width (ops/dropout.py)."""
    b, n, din = x.shape
    xs = x.float().reshape(b * n, din)
    fmask = pmask = None
    if drop > 0:
        fmask = dropout.slot_mask(seed, dropout.STREAM_FEAT, b, n, din, drop,
                                  x.device, bits).reshape(b * n, din)
        xs = round_bf16(xs * round_bf16(fmask))
    cols, rows = [xs], [w.float()]
    if pe is not None:
        pos = pe.shape[1]
        pmask = dropout.slot_mask(seed, dropout.STREAM_PE, b, n, pos, drop,
                                  x.device, bits).reshape(b * n, pos)
        cols.append(round_bf16(pe.float().repeat(b, 1) * pmask))
        rows.append(round_bf16(wp))
    return torch.cat(cols, dim=1), torch.cat(rows, dim=0), fmask, pmask


def check_star(x: torch.Tensor, p: int) -> None:
    b, n = x.shape[:2]
    if not 0 <= p < n:
        raise ValueError(f"anchor slot p={p} outside [0, {n})")
    if b * n >= 1 << 32:
        raise ValueError("B * N must stay below 2**32 (32-bit dropout rows)")


def raise_on(lib, rc: int, what: str, err_fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({getattr(lib, err_fn)(rc).decode()})")


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (run the plain version), True for CUDA (launch
    the kernel); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def chunk_elems(x: torch.Tensor) -> int:
    """Elements of x's dtype in a 16-byte chunk, the products' copy unit
    (4 floats, csrc/gemm_tf32.cuh; 8 bf16, csrc/gemm_bf16.cuh): the row
    widths of every operand the tensor-core products read are multiples of
    it."""
    return 16 // x.element_size()


def round_up(v: int, k: int) -> int:
    return -(-v // k) * k


def product_splits(x: torch.Tensor, m: int, kx: int, wd: int) -> int:
    """Split-K count of the dW product (csrc/bwd_common.cuh) over m rows:
    about four waves of its 128 x 128 output tiles (one block an SM), at
    least 4096 rows a split."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles = -(-wd // 128) * -(-kx // 128)
    return max(1, min(-(-4 * sms // tiles), -(-m // 4096)))


def needs_staging(x: torch.Tensor, feat_drop: float, pos: int) -> bool:
    """Whether the products read the layer input X = [x*m | pe*m_pe] from a
    staged copy (masks, a pe path, or rows of x that are not 16-byte
    multiples) rather than from x itself."""
    return (feat_drop > 0 or pos > 0 or x.shape[-1] % chunk_elems(x) != 0
            or x.data_ptr() % 16 != 0)


def product_work(x: torch.Tensor, m: int, kx: int, wd: int, staged: bool,
                 kbeg: int, splits: int) -> dict:
    """Workspaces of the product passes (csrc/bwd_common.cuh:ProductWork):
    xm [m, kxp] (staged only), wt [wdp, ntp] (the dx product's W^T over
    the input columns [kbeg, kx)), both in x's dtype, part_w [splits, kx,
    wd] float32 (splits > 0: the dW product), and the widths (16-byte
    multiples of x's dtype)."""
    c = chunk_elems(x)
    kxp, wdp, ntp = round_up(kx, c), round_up(wd, c), round_up(kx - kbeg, c)
    empty = lambda *shape, dtype=x.dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    return {"xm": empty(m, kxp) if staged else None,
            "wt": empty(wdp, ntp) if ntp else None,
            "part_w": (empty(splits, kx, wd, dtype=torch.float32)
                       if splits else None),
            "kxp": kxp if staged else kx, "wdp": wdp, "ntp": ntp}


def pass_times(lib, prefix: str, call) -> list[float]:
    """Device milliseconds between the passes of one `call` of a kernel
    library's entry point (its `<prefix>_set_timing` / `<prefix>_pass_ms`
    C functions): events recorded on the stream between the launches."""
    rc = getattr(lib, f"{prefix}_set_timing")(1)
    if rc:
        raise RuntimeError(f"{prefix}_set_timing failed: CUDA error {rc}")
    try:
        call()
        out = (ctypes.c_float * 8)()
        count = getattr(lib, f"{prefix}_pass_ms")(out)
    finally:
        getattr(lib, f"{prefix}_set_timing")(0)
    return [float(v) for v in out[:count]]
