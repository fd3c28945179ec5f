"""Graph readouts MR / WMR / CR / SUM / MAX / PATR (port of
`taxoexpan_tpu/models/readout.py`).

For GAT/PGAT the port's final layer can emit per-position-class pools,
and every readout that is a linear pool (MR, WMR, CR, SUM) is then a small
epilogue on them (`apply_pools`, ops/star.py:readout_from_pools). MAX and
PATR are not linear pools: they read the per-slot activation [B, N, out]
(`apply`), as the GCN/PGCN readouts do. PATR is the position-aware
attention readout (ops/star.py:readout_attention).
"""
from __future__ import annotations

import torch

from ..ops import star
from .init import embedding_params, linear_params

READOUT_KINDS = ("MR", "WMR", "CR", "SUM", "MAX", "PATR")
POOLED_KINDS = ("MR", "WMR", "CR", "SUM")


class Readout:
    def __init__(self, kind: str, out_dim: int, attention_dim: int = 100):
        if kind not in READOUT_KINDS:
            raise ValueError(f"Unacceptable readout method {kind!r}; the "
                             f"port has {READOUT_KINDS}")
        self.kind = kind
        self.out_dim = out_dim
        self.attention_dim = attention_dim
        # CR concatenates the three position-class pools
        self.l_dim = out_dim * 3 if kind == "CR" else out_dim

    def init(self, gen: torch.Generator) -> dict:
        if self.kind == "WMR":
            # nn.Embedding(3, 1) position weights
            return embedding_params(gen, 3, 1)
        if self.kind == "PATR":
            # the gate Linear(out -> attention_dim), the class embedding
            # [3, attention_dim] and the score Linear(attention_dim -> 1,
            # no bias)
            gate = linear_params(gen, self.out_dim, self.attention_dim)
            return {"w1": gate["w"], "b1": gate["b"],
                    "class_emb": embedding_params(
                        gen, 3, self.attention_dim)["emb"],
                    "w2": linear_params(gen, self.attention_dim, 1,
                                        bias=False)["w"]}
        return {}

    def apply_pools(self, params: dict, pools: torch.Tensor,
                    ngp: torch.Tensor, nsib: torch.Tensor) -> torch.Tensor:
        pw = params["emb"] if self.kind == "WMR" else None
        return star.readout_from_pools(pools, ngp, nsib, kind=self.kind,
                                       position_weights=pw)

    def apply(self, params: dict, h: torch.Tensor, ngp: torch.Tensor,
              nsib: torch.Tensor, p_slots: int) -> torch.Tensor:
        """Readout of the per-slot activation h [B, N, out_dim]."""
        if self.kind == "PATR":
            return star.readout_attention(h, ngp, nsib, p_slots, params)
        pw = params["emb"] if self.kind == "WMR" else None
        return star.readout(h, ngp, nsib, p_slots, kind=self.kind,
                            position_weights=pw)
