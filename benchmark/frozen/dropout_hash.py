"""Dropout masks for the plain reference: a frozen copy of the counter hash
of `taxoexpan_torch/ops/dropout.py` at commit c6a9a8c (32-bit thresholds,
the only width a published configuration runs), and of the per-step seed
schedule of `training/trainer.py:step_generator` and
`models/propagation.py:_layer_seed`.

The bit of one element is a pure function of (seed, stream, row, column):

    fmix(h)     = murmur3's 32-bit finaliser
    stream_key  = fmix(fmix(seed) + (stream + 1) * 0x9E3779B9)
    row_key     = fmix(stream_key ^ row * 0x27D4EB2F)
    bits        = fmix(row_key + (col + 1) * 0x165667B1)

kept iff bits < floor((1 - rate) * 2**32), kept values scaled by
1 / (1 - rate). Streams: 0 the layer input's columns and 1 the position
embedding's (row = egonet * N + slot), 2 + 5 * head + kind the attention
weights (row = egonet, col = index within the kind: 0 gp -> anchor, 1 the
anchor's self-loop, 2 anchor -> sibling, 3 a sibling's self-loop, 4 a
grandparent's self-loop). `tests/test_bench_frozen.py` pins the bits.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
STREAM_FEAT = 0
STREAM_PE = 1
ATTN_KINDS = 5
_GOLDEN = 0x9E3779B9
_ROW_MUL = 0x27D4EB2F
_COL_MUL = 0x165667B1
STEP_STRIDE = 1_000_003


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
    """One element's bits in plain Python integers."""
    rk = _fmix_int(stream_key(seed, stream) ^ ((row * _ROW_MUL) & MASK32))
    return _fmix_int((rk + (col + 1) * _COL_MUL) & MASK32)


def _s32(v: int) -> int:
    v &= MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    return (h >> k) & ((1 << (32 - k)) - 1)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 16)
    h = h * _s32(0x85EBCA6B)
    h = h ^ _shr(h, 13)
    h = h * _s32(0xC2B2AE35)
    return h ^ _shr(h, 16)


def _words(key, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int32 words holding the 32-bit bits at the broadcast of rows and
    cols (int32 tensors); `key` an int or an int32 tensor of keys."""
    key = _s32(key) if isinstance(key, int) else key
    rk = _fmix(key ^ (rows * _s32(_ROW_MUL)))
    return _fmix(rk + (cols + 1) * _s32(_COL_MUL))


def _keep(key, rows, cols, rate: float) -> torch.Tensor:
    thresh = int((1.0 - rate) * 4294967296.0) & MASK32
    # unsigned compare of the words: flip the sign bits of both sides
    return (_words(key, rows, cols) ^ _s32(1 << 31)) < thresh - (1 << 31)


def bits(seed: int, stream: int, rows: torch.Tensor,
         cols: torch.Tensor) -> torch.Tensor:
    """Bits at the broadcast of rows and cols, int64 in [0, 2**32)."""
    return _words(stream_key(seed, stream), rows.to(torch.int32),
                  cols.to(torch.int32)).to(torch.int64) & MASK32


def slot_mask(seed: int, stream: int, b: int, n: int, width: int,
              rate: float, device) -> torch.Tensor:
    """[B, N, width] float32 mask (the keep scale or 0) of a per-slot stream:
    row = egonet * N + slot, col = column."""
    key = stream_key(seed, stream)
    scale = 1.0 / (1.0 - rate)
    cols = torch.arange(width, device=device, dtype=torch.int32)[None, :]
    out = torch.empty((b * n, width), dtype=torch.float32, device=device)
    step = max(1, (1 << 24) // max(width, 1))
    for r0 in range(0, b * n, step):
        r1 = min(b * n, r0 + step)
        rows = torch.arange(r0, r1, device=device, dtype=torch.int32)
        out[r0:r1] = _keep(key, rows[:, None], cols, rate).float() * scale
    return out.reshape(b, n, width)


def attention_mask(seed: int, head: int, kind: int, b: int, width: int,
                   rate: float, device) -> torch.Tensor:
    """[B, width] float32 mask of one attention stream."""
    key = stream_key(seed, 2 + ATTN_KINDS * head + kind)
    rows = torch.arange(b, device=device, dtype=torch.int32)[:, None]
    cols = torch.arange(width, device=device, dtype=torch.int32)[None, :]
    return _keep(key, rows, cols, rate).float() * (1.0 / (1.0 - rate))


def layer_seeds(run_seed: int, step_idx: int, layers: int) -> list[int]:
    """The dropout seed of each layer of one train step: a torch CPU
    generator seeded with (run seed << 32) | step index, one
    randint(0, 2**31 - 1) a layer in layer order (a single process: no rank
    folded in)."""
    gen = torch.Generator().manual_seed(
        ((run_seed & MASK32) << 32) | (step_idx & MASK32))
    return [int(torch.randint(0, 2_147_483_647, (1,), generator=gen))
            for _ in range(layers)]
