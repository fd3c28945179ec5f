"""Graph readouts MR / WMR / CR / SUM (port of
`taxoexpan_tpu/models/readout.py`).

The port's final GAT layer emits per-position-class pools, so for GAT/PGAT
every readout is a small epilogue on them (`apply_pools`,
ops/star.py:readout_from_pools). GCN/PGCN has no pooled final kernel: its
final layer writes the per-slot activation [B, N, out], which `apply`
reduces (ops/star.py:readout). MAX and PATR are not ported yet (see
ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..ops import star
from .init import embedding_params

READOUT_KINDS = ("MR", "WMR", "CR", "SUM")


class Readout:
    def __init__(self, kind: str, out_dim: int):
        if kind not in READOUT_KINDS:
            raise ValueError(f"Unacceptable or not yet ported readout method "
                             f"{kind!r}; the port has {READOUT_KINDS}")
        self.kind = kind
        self.out_dim = out_dim
        # CR concatenates the three position-class pools
        self.l_dim = out_dim * 3 if kind == "CR" else out_dim

    def init(self, gen: torch.Generator) -> dict:
        if self.kind == "WMR":
            # nn.Embedding(3, 1) position weights
            return embedding_params(gen, 3, 1)
        return {}

    def apply_pools(self, params: dict, pools: torch.Tensor,
                    ngp: torch.Tensor, nsib: torch.Tensor) -> torch.Tensor:
        pw = params["emb"] if self.kind == "WMR" else None
        return star.readout_from_pools(pools, ngp, nsib, kind=self.kind,
                                       position_weights=pw)

    def apply(self, params: dict, h: torch.Tensor, ngp: torch.Tensor,
              nsib: torch.Tensor, p_slots: int) -> torch.Tensor:
        """Readout of the per-slot activation h [B, N, out_dim]."""
        pw = params["emb"] if self.kind == "WMR" else None
        return star.readout(h, ngp, nsib, p_slots, kind=self.kind,
                            position_weights=pw)
