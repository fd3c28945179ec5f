"""The TaxoExpan composite model: propagate -> readout -> match (port of
`taxoexpan_tpu/models/taxoexpan.py`).

The model object holds static configuration; parameters are a plain dict
tree with the JAX package's keys and layouts (see weights.py). Ported so
far: GAT/PGAT propagation with pos_mode="bias" in float32, eval and train
(dropout) forms, the MR/WMR/CR/SUM readouts, every matcher, the raw-feature
channel and its structure-prior init, and the training forward
(`forward`: GroupBatch -> scores [G, C]). GCN/PGCN, MAX/PATR readouts,
auxiliary heads and bf16 wait for later work (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..ops import star
from .matching import Matcher
from .propagation import GAT
from .readout import Readout

PROPAGATION_KINDS = ("GAT", "PGAT")


class TaxoExpan:
    def __init__(self,
                 propagation_method: str = "PGAT",
                 readout_method: str = "WMR",
                 matching_method: str = "BIM",
                 *,
                 in_dim: int,
                 hidden_dim: int,
                 out_dim: int,
                 pos_dim: int = 0,
                 num_layers: int = 1,
                 heads: list[int] | None = None,
                 feat_drop: float = 0.1,
                 attn_drop: float = 0.1,
                 max_parents: int = 8,
                 expand_factor: int = 50,
                 raw_channel: bool = False):
        if propagation_method not in PROPAGATION_KINDS:
            raise ValueError(
                f"Unacceptable or not yet ported propagation method "
                f"{propagation_method!r}; the port has {PROPAGATION_KINDS}")
        if heads is None:
            raise ValueError("GAT/PGAT require a heads list")
        self.propagation_method = propagation_method
        self.readout_method = readout_method
        self.matching_method = matching_method
        self.in_dim = in_dim
        self.max_parents = max_parents
        self.expand_factor = expand_factor
        self.num_slots = max_parents + 1 + expand_factor
        pos_dim_eff = pos_dim if propagation_method == "PGAT" else 0
        self.propagate = GAT(in_dim, hidden_dim, out_dim, num_layers, heads,
                             pos_dim=pos_dim_eff, feat_drop=feat_drop,
                             attn_drop=attn_drop)
        self.readout = Readout(readout_method, out_dim)
        # optional raw-feature channel: the unit-normalised anchor+sibling
        # mean of the untransformed features appended to every summary
        self.raw_channel = bool(raw_channel)
        raw_dim = in_dim if self.raw_channel else 0
        self.matcher = Matcher(matching_method, self.readout.l_dim + raw_dim,
                               in_dim, hidden_dim)

    def init(self, gen: torch.Generator) -> dict:
        params = {"propagate": self.propagate.init(gen),
                  "readout": self.readout.init(gen),
                  "match": self.matcher.init(gen)}
        self._seed_raw_prior(params["match"])
        return params

    def _seed_raw_prior(self, match_params: dict) -> None:
        """Structure-prior init: with the raw channel on, add the identity to
        the raw-block rows of a bilinear matcher's weight, so the untrained
        model already scores like the `simple_structure sum/b0.0` heuristic.
        MLP/NTN keep their default init."""
        if not self.raw_channel or self.matcher.kind not in ("BIM", "LBM"):
            return
        w = match_params["w"]
        l_learned = self.readout.l_dim
        w[l_learned:] += torch.eye(self.in_dim, dtype=w.dtype,
                                   device=w.device)

    # ------------------------------------------------------------------ stages
    def encode(self, params: dict, feats: torch.Tensor, ngp: torch.Tensor,
               nsib: torch.Tensor, *, gen: torch.Generator | None = None,
               train: bool = False) -> torch.Tensor:
        """Egonet features [B, N, D] -> graph embeddings [B, l_dim].

        The final layer emits the readout class pools directly (head mean
        and masked class sums inside the kernel); the readout is a small
        epilogue on them. train=True turns dropout on, seeds from `gen`."""
        pools = self.propagate.apply(params["propagate"], feats, ngp, nsib,
                                     self.max_parents, gen=gen, train=train)
        hg = self.readout.apply_pools(params["readout"], pools, ngp, nsib)
        return self._append_raw(hg, feats, ngp, nsib)

    def _append_raw(self, hg: torch.Tensor, feats: torch.Tensor,
                    ngp: torch.Tensor, nsib: torch.Tensor) -> torch.Tensor:
        if not self.raw_channel:
            return hg
        rc = star.raw_star_channel(feats, ngp, nsib, self.max_parents)
        return torch.cat([hg, rc.to(hg.dtype)], dim=-1)

    def match(self, params: dict, hg: torch.Tensor,
              qf: torch.Tensor) -> torch.Tensor:
        return self.matcher.apply(params["match"], hg, qf)

    def match_all(self, params: dict, hg: torch.Tensor,
                  qf: torch.Tensor) -> torch.Tensor:
        return self.matcher.apply_all(params["match"], hg, qf)

    def gather_feats(self, feature_table: torch.Tensor,
                     node_ids: torch.Tensor, ngp: torch.Tensor,
                     nsib: torch.Tensor) -> torch.Tensor:
        """Device-side feature gather: [V, D] table + [B, N] ids ->
        [B, N, D] (contiguous), padded slots zeroed."""
        feats = feature_table[node_ids]
        mask = star.node_mask(ngp, nsib, self.max_parents, node_ids.shape[1])
        return feats * mask[..., None].to(feats.dtype)

    def forward(self, params: dict, batch, feature_table: torch.Tensor, *,
                gen: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        """GroupBatch (tensors on the model's device) -> scores [G, C], in
        the per-group layout the losses take."""
        ego = batch.ego
        feats = self.gather_feats(feature_table, ego.node_ids.long(),
                                  ego.ngp, ego.nsib)
        qf = (batch.query_feats if batch.query_feats is not None
              else feature_table[batch.query_ids.long()])
        g, c = batch.labels.shape
        hg = self.encode(params, feats, ego.ngp, ego.nsib, gen=gen,
                         train=train)
        scores = self.match(params, hg, qf.repeat_interleave(c, dim=0))
        return scores.reshape(g, c)
