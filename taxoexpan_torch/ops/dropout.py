"""Counter-based dropout bits shared by the CUDA kernels and their plain
versions (replaces `_gen_masks`, taxoexpan_tpu/ops/pallas_gat.py:44-115).

The TPU kernels draw a per-tile stream from the chip's PRNG and replay it
in the backward with the same tiling. Hopper blocks are tiled differently
in the forward and the backward, so here the bit of one element is a pure
function of (seed, stream, row, column):

    fmix(h)       = murmur3's 32-bit finaliser
    stream_key    = fmix(fmix(seed) + (stream + 1) * 0x9E3779B9)
    row_key       = fmix(stream_key ^ row * 0x27D4EB2F)
    bits          = fmix(row_key + (col + 1) * 0x165667B1)

Every step is a 32-bit multiply (low word), xor, shift or add, so the torch
version below (int32 tensors holding the 32-bit words: products and sums
wrap modulo 2**32, right shifts are masked to be logical) reproduces the
CUDA bits exactly (`ops/csrc/gat_common.cuh`).

Streams (the JAX generation order, as stream ids):
    STREAM_FEAT   input-feature mask   row = b * N + slot, col = input column
    STREAM_PE     position-embedding mask, same rows, col = pe column
    attention(h, kind) = 2 + 5 * h + kind, row = egonet b, col = j:
        kind 0 gp -> anchor [B, P], 1 anchor self [B, 1], 2 anchor -> sib
        [B, S], 3 sib self [B, S], 4 gp self [B, P]

Keep rule of the JAX package (pallas_gat.py:98-102): keep iff
bits < floor((1 - rate) * 2**32), kept values scaled by 1 / (1 - rate).
Rows are 32-bit: B * N must stay below 2**32.

8-bit thresholds (TAXOEXPAN_DROPOUT_BITS=8, the opt-in of the JAX GAT
kernels, pallas_gat.py:73-97): an element compares one byte with
t8 = min(max(int((1 - rate) * 256), 1), 255) and is kept iff byte < t8,
scaled by 256 / t8, which keeps the mask unbiased at a keep rate of
t8 / 256. The element (row, col) takes byte col % 4 (bits 8 * (col % 4) and
up) of the word of (seed, stream, row, col // 4): four neighbouring columns
share one hash. So the row keys of both modes are the same, and a kernel
switches mode by its column index alone. The TPU kernel unpacks words along
rows ([rows / 4, cols] words bitcast to [rows, cols] bytes) and falls back
to 32 bits for a tile whose row count is not a multiple of 4; a column
split has no such case, so no fallback exists here. The GCN layer (K5)
always draws 32 bits, as pallas_gcn.py reads no switch.
"""
from __future__ import annotations

import ctypes
import os

import torch

MASK32 = 0xFFFFFFFF
STREAM_FEAT = 0
STREAM_PE = 1
ATTN_KINDS = 5
_GOLDEN = 0x9E3779B9
_ROW_MUL = 0x27D4EB2F
_COL_MUL = 0x165667B1


# (seed, stream, row, col) -> bits, pinned: a change of the generator
# changes every mask, and the kernels and plain versions must change as one
GOLDEN_BITS = (
    ((0, 0, 0, 0), 894628709),
    ((1, 0, 0, 0), 1957787082),
    ((0, 1, 0, 0), 351695598),
    ((0, 0, 1, 0), 3406888775),
    ((0, 0, 0, 1), 2122888683),
    ((123456789, 7, 262143, 249), 2899358386),
    ((2 ** 31 - 1, 12, 4095, 49), 1640409158),
    ((42, 0, 2 ** 32 - 1, 2 ** 32 - 1), 2423138199),
)
# the 8-bit mode's bytes, (seed, stream, row, col) -> byte, pinned likewise
GOLDEN_BYTES8 = (
    ((0, 0, 0, 0), 101),
    ((1, 0, 0, 1), 117),
    ((0, 1, 5, 2), 244),
    ((0, 0, 1, 3), 203),
    ((9, 3, 77, 4), 113),
    ((123456789, 7, 262143, 249), 163),
    ((2 ** 31 - 1, 12, 4095, 49), 170),
    ((42, 0, 2 ** 32 - 1, 2 ** 32 - 1), 148),
)


def attention_stream(head: int, kind: int) -> int:
    return 2 + ATTN_KINDS * head + kind


def check_bits(bits: int) -> int:
    if bits not in (8, 32):
        raise ValueError(f"dropout bits must be 8 or 32, got {bits!r}")
    return bits


def env_bits() -> int:
    """The threshold width TAXOEXPAN_DROPOUT_BITS selects, read as the JAX
    package reads it (pallas_gat.py:73): "8" gives 8, anything else 32."""
    return 8 if os.environ.get("TAXOEXPAN_DROPOUT_BITS", "32") == "8" else 32


def keep_threshold(rate: float, bits: int = 32) -> int:
    if check_bits(bits) == 8:
        return min(max(int((1.0 - rate) * 256.0), 1), 255)
    return int((1.0 - rate) * 4294967296.0) & MASK32


def keep_scale(rate: float, bits: int = 32) -> float:
    if check_bits(bits) == 8:
        return 256.0 / keep_threshold(rate, 8)
    return 1.0 / (1.0 - rate)


# ----------------------------------------------------------- python scalars

def _fmix_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def stream_key(seed: int, stream: int) -> int:
    return _fmix_int((_fmix_int(seed & MASK32)
                      + (stream + 1) * _GOLDEN) & MASK32)


def bits_int(seed: int, stream: int, row: int, col: int) -> int:
    """One element's bits, in plain Python integers (the test reference)."""
    rk = _fmix_int(stream_key(seed, stream) ^ ((row * _ROW_MUL) & MASK32))
    return _fmix_int((rk + (col + 1) * _COL_MUL) & MASK32)


def byte8_int(seed: int, stream: int, row: int, col: int) -> int:
    """One element's byte in the 8-bit mode, in plain Python integers."""
    return (bits_int(seed, stream, row, col >> 2) >> (8 * (col & 3))) & 0xFF


# ------------------------------------------------------------ torch tensors

def _s32(v: int) -> int:
    """The int32 whose bits are the 32-bit word v."""
    v &= MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _words(t: torch.Tensor) -> torch.Tensor:
    """An integer tensor's low 32 bits as int32 words."""
    return t.to(torch.int64).bitwise_and(MASK32).to(torch.int32) \
        if t.dtype != torch.int32 else t


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    """The logical right shift of the words h by k (0 < k < 32)."""
    return (h >> k) & ((1 << (32 - k)) - 1)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 16)
    h = h * _s32(0x85EBCA6B)
    h = h ^ _shr(h, 13)
    h = h * _s32(0xC2B2AE35)
    return h ^ _shr(h, 16)


def _keyed_words(key, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The bits of a stream key (an int, or an integer tensor of keys that
    broadcasts with rows and cols) at [broadcast of rows, cols], as int32
    words."""
    key = _s32(key) if isinstance(key, int) else _words(key)
    rk = _fmix(key ^ (_words(rows) * _s32(_ROW_MUL)))
    return _fmix(rk + (_words(cols) + 1) * _s32(_COL_MUL))


def _keyed_bits(key, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """`_keyed_words` as int64 in [0, 2**32)."""
    return _keyed_words(key, rows, cols).to(torch.int64) & MASK32


def _keyed_bytes8(key, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """The 8-bit mode's bytes, int32 in [0, 256)."""
    cols = _words(cols)
    word = _keyed_words(key, rows, _shr(cols, 2))
    return (word >> ((cols & 3) * 8)) & 0xFF


def _keep(key, rows, cols, rate: float, bits: int) -> torch.Tensor:
    """Where the draw is below the keep threshold (bool): an unsigned
    compare of the words (their sign bits flipped) or of the bytes."""
    thresh = keep_threshold(rate, bits)
    if check_bits(bits) == 8:
        return _keyed_bytes8(key, rows, cols) < thresh
    return (_keyed_words(key, rows, cols) ^ _s32(1 << 31)) < thresh - (1 << 31)


def bits_plain(seed: int, stream: int, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """Bits [broadcast of rows, cols] as int64 in [0, 2**32)."""
    return _keyed_bits(stream_key(seed, stream), rows, cols)


def bytes8_plain(seed: int, stream: int, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """The 8-bit mode's bytes [broadcast of rows, cols] as int64 in
    [0, 256)."""
    return _keyed_bytes8(stream_key(seed, stream), rows, cols).to(
        torch.int64)


def keep_mask(seed: int, stream: int, rows: torch.Tensor, cols: torch.Tensor,
              rate: float, bits: int = 32) -> torch.Tensor:
    """float32 mask over the broadcast of rows and cols: the keep scale
    (1 / (1 - rate); 256 / t8 with 8-bit thresholds) where kept, 0 where
    dropped."""
    keep = _keep(stream_key(seed, stream), rows, cols, rate, bits)
    return keep.to(torch.float32) * keep_scale(rate, bits)


def slot_mask(seed: int, stream: int, b: int, n: int, width: int,
              rate: float, device=None, bits: int = 32) -> torch.Tensor:
    """[B, N, width] mask of a per-slot stream (feature or pe columns):
    row = b * N + slot."""
    rows = torch.arange(b * n, device=device, dtype=torch.int64)
    cols = torch.arange(width, device=device, dtype=torch.int64)
    out = torch.empty((b * n, width), dtype=torch.float32, device=device)
    step = max(1, (1 << 24) // max(width, 1))     # bound the temporaries
    for r0 in range(0, b * n, step):
        out[r0:r0 + step] = keep_mask(seed, stream, rows[r0:r0 + step, None],
                                      cols[None, :], rate, bits)
    return out.reshape(b, n, width)


def attention_masks(seed: int, b: int, p: int, s: int, heads: int,
                    rate: float, device=None,
                    bits: int = 32) -> list[torch.Tensor]:
    """The five attention masks, each stacked over heads on the last axis:
    gp -> anchor [B, P, H], anchor self [B, 1, H], anchor -> sib [B, S, H],
    sib self [B, S, H], gp self [B, P, H]. All 5 * H streams are drawn in
    one pass over [5, H, B, max(P, S, 1)] and sliced to each kind's
    width."""
    widths = (p, 1, s, s, p)
    keys = torch.tensor([[_s32(stream_key(seed, attention_stream(h, kind)))
                          for h in range(heads)] for kind in range(5)],
                        dtype=torch.int32, device=device)[..., None, None]
    rows = torch.arange(b, device=device, dtype=torch.int32)[:, None]
    cols = torch.arange(max(widths), device=device,
                        dtype=torch.int32)[None, :]
    keep = _keep(keys, rows, cols, rate, bits).to(
        torch.float32) * keep_scale(rate, bits)
    return [keep[kind, :, :, :w].permute(1, 2, 0)
            for kind, w in enumerate(widths)]


# --------------------------------------------------- the CUDA generator

def _as_int32_bits(t: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 `t` as int32 (two's complement), for the
    kernel to read as uint32."""
    t = t.to(torch.int64) & MASK32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(
        torch.int32).contiguous()


def bits(seed: int, stream: int, rows: torch.Tensor, cols: torch.Tensor,
         width: int = 32) -> torch.Tensor:
    """The values compared with the keep threshold for (rows[i], cols[i])
    pairs (1-D int64 tensors of one length): 32-bit words, or with
    width=8 the 8-bit mode's bytes. The plain version on the CPU, the
    kernels' device generator on CUDA (`dropout_bits_u32` in gat_fwd.cu).
    Returns int64 in [0, 2**width)."""
    if rows.shape != cols.shape or rows.dim() != 1:
        raise ValueError("rows and cols must be 1-D and of one length")
    if rows.device.type == "cpu":
        draw = bytes8_plain if check_bits(width) == 8 else bits_plain
        return draw(seed, stream, rows, cols)
    if rows.device.type != "cuda":
        raise ValueError(f"dropout.bits: unsupported device {rows.device}")
    from . import cuda_build
    from .gat_kernels import FWD_SIGNATURES
    lib = cuda_build.load("gat_fwd", FWD_SIGNATURES)
    r32, c32 = (_as_int32_bits(t) for t in (rows, cols))
    out = torch.empty(rows.shape, dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        rc = lib.dropout_bits_u32(
            seed & MASK32, stream & MASK32, r32.data_ptr(), c32.data_ptr(),
            out.data_ptr(), rows.numel(), int(check_bits(width) == 8),
            torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout_bits_u32 launch failed: CUDA error {rc}")
    bits.launches += 1
    return out.to(torch.int64) & MASK32


bits.launches = 0
