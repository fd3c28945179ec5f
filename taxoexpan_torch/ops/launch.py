"""Plumbing shared by the kernel wrappers (`gat_kernels.py`, `gcn_kernels.py`):
the train-form argument struct, operand checks, device dispatch, the stream
and launch errors."""
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


def check_operands(x: torch.Tensor, shapes: dict) -> None:
    """Every operand {name: (tensor, expected shape)} and x itself: shape,
    x's device, float32 (int32 for ngp / nsib), contiguous."""
    for name, (t, want) in [("x", (x, tuple(x.shape)))] + list(shapes.items()):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        want_dtype = torch.int32 if name in ("ngp", "nsib") else torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"{want_dtype} only")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


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


def round4(v: int) -> int:
    """v rounded up to a multiple of 4 floats (16 bytes): the row width of
    every operand the tensor-core products (csrc/gemm_tf32.cuh) read."""
    return (v + 3) // 4 * 4


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
    return (feat_drop > 0 or pos > 0 or x.shape[-1] % 4 != 0
            or x.data_ptr() % 16 != 0)


def product_work(x: torch.Tensor, m: int, kx: int, wd: int, staged: bool,
                 kbeg: int, splits: int) -> dict:
    """Workspaces of the product passes (csrc/bwd_common.cuh:ProductWork):
    xm [m, kxp] (staged only), wt [wdp, ntp] (the dx product's W^T over
    the input columns [kbeg, kx)), part_w [splits, kx, wd], and the
    widths."""
    kxp, wdp, ntp = round4(kx), round4(wd), round4(kx - kbeg)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa
                                       device=x.device)
    return {"xm": empty(m, kxp) if staged else None,
            "wt": empty(wdp, ntp) if ntp else None,
            "part_w": empty(splits, kx, wd),
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
