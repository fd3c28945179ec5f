"""Matching modules MLP / PMLP / BIM / LBM / NTN (port of
`taxoexpan_tpu/models/matching.py`).

Each matcher scores (graph embedding, query embedding) pairs with `apply`;
`apply_all` scores all candidates against all queries, for BIM/LBM as one
(hg @ W) @ qf^T product.
"""
from __future__ import annotations

import math

import torch

from .init import apply_linear, linear_params, uniform

MATCH_KINDS = ("MLP", "BIM", "LBM", "NTN", "PMLP")


class Matcher:
    def __init__(self, kind: str, l_dim: int, r_dim: int, hidden_dim: int,
                 ntn_k: int = 4):
        if kind not in MATCH_KINDS:
            raise ValueError(f"Unacceptable Matching Method: {kind}")
        self.kind = kind
        self.l_dim = l_dim
        self.r_dim = r_dim
        self.hidden_dim = hidden_dim
        self.ntn_k = ntn_k

    def init(self, gen: torch.Generator) -> dict:
        if self.kind in ("MLP", "PMLP"):
            # Linear(l+r -> hidden), ReLU, Linear(hidden -> 1)
            return {"fc1": linear_params(gen, self.l_dim + self.r_dim,
                                         self.hidden_dim),
                    "fc2": linear_params(gen, self.hidden_dim, 1)}
        bound = 1.0 / math.sqrt(self.l_dim)
        if self.kind in ("BIM", "LBM"):
            # nn.Bilinear(l, r, 1, bias=False)
            return {"w": uniform(gen, (self.l_dim, self.r_dim), bound)}
        # NTN: u f(W[e1,e2] + V[e1;e2])
        return {
            "w": uniform(gen, (self.ntn_k, self.l_dim, self.r_dim), bound),
            "w_b": uniform(gen, (self.ntn_k,), bound),
            "v": linear_params(gen, self.l_dim + self.r_dim, self.ntn_k,
                               bias=False),
            "u": linear_params(gen, self.ntn_k, 1, bias=False),
        }

    def apply(self, params: dict, e1: torch.Tensor,
              e2: torch.Tensor) -> torch.Tensor:
        """e1: [B, l_dim], e2: [B, r_dim] -> scores [B]."""
        if self.kind in ("MLP", "PMLP"):
            x = torch.cat([e1, e2], dim=-1)
            h = torch.relu(apply_linear(params["fc1"], x))
            return apply_linear(params["fc2"], h)[..., 0]
        if self.kind in ("BIM", "LBM"):
            s = torch.einsum("bl,lr,br->b", e1, params["w"], e2)
            return torch.exp(s) if self.kind == "LBM" else s
        bilinear = torch.einsum("bl,klr,br->bk", e1, params["w"], e2)
        bilinear = bilinear + params["w_b"]
        lin = apply_linear(params["v"], torch.cat([e1, e2], dim=-1))
        return apply_linear(params["u"], torch.tanh(bilinear + lin))[..., 0]

    def apply_all(self, params: dict, hg: torch.Tensor,
                  qf: torch.Tensor) -> torch.Tensor:
        """hg: [C, l_dim] candidates, qf: [Q, r_dim] queries -> [Q, C]."""
        if self.kind in ("BIM", "LBM"):
            s = qf @ (hg @ params["w"]).T
            return torch.exp(s) if self.kind == "LBM" else s
        # MLP/NTN need the pairwise concat; broadcast then reuse `apply`
        c, q = hg.shape[0], qf.shape[0]
        e1 = hg[None, :, :].expand(q, c, hg.shape[1])
        e2 = qf[:, None, :].expand(q, c, qf.shape[1])
        return self.apply(params, e1.reshape(q * c, -1),
                          e2.reshape(q * c, -1)).reshape(q, c)
