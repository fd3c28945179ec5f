"""Parameter initialisers (port of `taxoexpan_tpu/models/init.py`).

Same distributions as the JAX package (which follows the reference's torch
inits); the random streams differ, so only distributions are comparable:
- GATLayer: xavier_normal with gain 1.414 for fc and attn vectors
- nn.Linear default: U(-1/sqrt(fan_in), +) for weight and bias
- nn.Bilinear default: U(-1/sqrt(in1_features), +)
- nn.Embedding default: N(0, 1)
Weights are stored [in, out] (x @ W), as in the JAX package.
"""
from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def xavier_normal(gen: torch.Generator, shape, fan_in: int, fan_out: int,
                  gain: float = 1.414) -> torch.Tensor:
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen, dtype=torch.float32)


def linear_params(gen: torch.Generator, in_f: int, out_f: int,
                  bias: bool = True) -> dict:
    bound = 1.0 / math.sqrt(in_f)
    p = {"w": uniform(gen, (in_f, out_f), bound)}
    if bias:
        p["b"] = uniform(gen, (out_f,), bound)
    return p


def embedding_params(gen: torch.Generator, vocab: int, dim: int) -> dict:
    return {"emb": torch.randn((vocab, dim), generator=gen,
                               dtype=torch.float32)}


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
