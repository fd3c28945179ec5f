"""The TaxoExpan composite model: propagate -> readout -> match (port of
`taxoexpan_tpu/models/taxoexpan.py`).

The model object holds static configuration; parameters are a plain dict
tree with the JAX package's keys and layouts (see weights.py): every
propagation method (GCN, PGCN, GAT, PGAT) in either pos_mode ("bias" or
"concat", with the same parameters) in float32, GAT and PGAT also in bf16
(compute_dtype "bfloat16"; GCN and PGCN ignore it, as the JAX package's
TaxoExpan passes no dtype to GCN, taxoexpan.py:78), eval and train (dropout)
forms, every readout (MR, WMR, CR, SUM, MAX, PATR), every matcher, the
raw-feature channel and its structure-prior init, the training forward
(`forward`: GroupBatch -> scores [G, C]; `forward_with_feats` from features
the caller gathered, the partitioned feature table's path) and the
auxiliary MTL heads (`aux_heads`, `forward_heads[_with_feats]`). Residual
GAT layers are an option of `models.propagation.GAT` that no config key
reaches, as in the JAX package; a model whose `propagate` is such a GAT
takes the per-slot final layer.
"""
from __future__ import annotations

import torch

from ..ops import star
from .matching import Matcher
from .propagation import GAT, GCN
from .readout import POOLED_KINDS, Readout

PROPAGATION_KINDS = ("GCN", "PGCN", "GAT", "PGAT")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
                 hidden_drop: float = 0.1,
                 out_drop: float = 0.1,
                 max_parents: int = 8,
                 expand_factor: int = 50,
                 attention_dim: int = 100,
                 aux_heads: list | None = None,
                 raw_channel: bool = False,
                 compute_dtype: str = "float32",
                 pos_mode: str = "bias"):
        if propagation_method not in PROPAGATION_KINDS:
            raise ValueError(
                f"Unacceptable or not yet ported propagation method "
                f"{propagation_method!r}; the port has {PROPAGATION_KINDS}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype!r}")
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]
        self.propagation_method = propagation_method
        self.readout_method = readout_method
        self.matching_method = matching_method
        self.in_dim = in_dim
        self.max_parents = max_parents
        self.expand_factor = expand_factor
        self.num_slots = max_parents + 1 + expand_factor
        pos_dim_eff = pos_dim if propagation_method in ("PGCN", "PGAT") \
            else 0
        if propagation_method in ("GCN", "PGCN"):
            self.propagate = GCN(in_dim, hidden_dim, out_dim, num_layers,
                                 pos_dim=pos_dim_eff, in_dropout=feat_drop,
                                 hidden_dropout=hidden_drop,
                                 output_dropout=out_drop, pos_mode=pos_mode)
        else:
            if heads is None:
                raise ValueError("GAT/PGAT require a heads list")
            self.propagate = GAT(in_dim, hidden_dim, out_dim, num_layers,
                                 heads, pos_dim=pos_dim_eff,
                                 feat_drop=feat_drop, attn_drop=attn_drop,
                                 dtype=self.compute_dtype, pos_mode=pos_mode)
        self.readout = Readout(readout_method, out_dim,
                               attention_dim=attention_dim)
        # optional raw-feature channel: the unit-normalised anchor+sibling
        # mean of the untransformed features appended to every summary
        self.raw_channel = bool(raw_channel)
        raw_dim = in_dim if self.raw_channel else 0
        self.matcher = Matcher(matching_method, self.readout.l_dim + raw_dim,
                               in_dim, hidden_dim)
        # multi-task auxiliary heads: each {"readout": ..., "matcher": ...}
        # adds a (readout, matcher) pair over the shared propagation trunk;
        # training averages the per-head losses, evaluation uses the
        # primary head (taxoexpan_tpu/models/taxoexpan.py:113-126)
        self.aux_heads = []
        for spec in aux_heads or []:
            rd = Readout(spec.get("readout", "WMR"), out_dim,
                         attention_dim=attention_dim)
            mt = Matcher(spec.get("matcher", "BIM"), rd.l_dim + raw_dim,
                         in_dim, hidden_dim)
            self.aux_heads.append((rd, mt))

    def init(self, gen: torch.Generator) -> dict:
        params = {"propagate": self.propagate.init(gen),
                  "readout": self.readout.init(gen),
                  "match": self.matcher.init(gen)}
        self._seed_raw_prior(self.matcher, params["match"],
                             self.readout.l_dim)
        if self.aux_heads:
            params["aux"] = [{"readout": rd.init(gen), "match": mt.init(gen)}
                             for rd, mt in self.aux_heads]
            for (rd, mt), hp in zip(self.aux_heads, params["aux"]):
                self._seed_raw_prior(mt, hp["match"], rd.l_dim)
        return params

    def _seed_raw_prior(self, matcher: Matcher, match_params: dict,
                        l_learned: int) -> None:
        """Structure-prior init: with the raw channel on, add the identity to
        the raw-block rows of a bilinear matcher's weight, so the untrained
        model already scores like the `simple_structure sum/b0.0` heuristic.
        MLP/NTN keep their default init."""
        if not self.raw_channel or matcher.kind not in ("BIM", "LBM"):
            return
        w = match_params["w"]
        w[l_learned:] += torch.eye(self.in_dim, dtype=w.dtype,
                                   device=w.device)

    # ------------------------------------------------------------------ stages
    def encode(self, params: dict, feats: torch.Tensor, ngp: torch.Tensor,
               nsib: torch.Tensor, *, gen: torch.Generator | None = None,
               train: bool = False) -> torch.Tensor:
        """Egonet features [B, N, D] -> graph embeddings [B, l_dim].

        GAT/PGAT with a readout that is a linear pool (MR, WMR, CR, SUM)
        and a final layer that is not residual: the final layer emits the
        readout class pools directly (head mean and masked class sums
        inside the kernel) and the readout is a small epilogue on them.
        Otherwise (MAX, PATR; a residual final layer; every GCN/PGCN
        readout) the final layer writes the per-slot activation and the
        readout reduces it (taxoexpan_tpu/models/taxoexpan.py:195-211).
        train=True turns dropout on, seeds from `gen`."""
        prop = self.propagate
        if isinstance(prop, GAT) and self.readout_method in POOLED_KINDS \
                and not prop.residual_layers[-1]:
            pools = prop.apply(params["propagate"], feats, ngp, nsib,
                               self.max_parents, gen=gen, train=train)
            hg = self.readout.apply_pools(params["readout"], pools, ngp,
                                          nsib)
        else:
            hg = self.readout.apply(params["readout"],
                                    self._trunk(params, feats, ngp, nsib,
                                                gen, train),
                                    ngp, nsib, self.max_parents)
        return self._append_raw(hg, feats, ngp, nsib)

    def _trunk(self, params: dict, feats, ngp, nsib, gen, train):
        """The per-slot propagation output [B, N, out_dim]."""
        kw = {"pool_readout": False} if isinstance(self.propagate, GAT) \
            else {}
        return self.propagate.apply(params["propagate"], feats, ngp, nsib,
                                    self.max_parents, gen=gen, train=train,
                                    **kw)

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

    def _batch_inputs(self, batch, feature_table):
        """(egonet features, query features [G, D]) of a GroupBatch."""
        ego = batch.ego
        feats = self.gather_feats(feature_table, ego.node_ids.long(),
                                  ego.ngp, ego.nsib)
        qf = (batch.query_feats if batch.query_feats is not None
              else feature_table[batch.query_ids.long()])
        return feats, qf

    def forward(self, params: dict, batch, feature_table: torch.Tensor, *,
                gen: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        """GroupBatch (tensors on the model's device) -> scores [G, C], in
        the per-group layout the losses take."""
        feats, qf = self._batch_inputs(batch, feature_table)
        return self.forward_with_feats(params, batch, feats, qf, gen=gen,
                                       train=train)

    def forward_with_feats(self, params: dict, batch, ego_feats, qf, *,
                           gen: torch.Generator | None = None,
                           train: bool = False) -> torch.Tensor:
        """`forward` from features gathered by the caller: egonet features
        [B, N, D] (invalid slots zeroed) and query features [G, D], as the
        partitioned feature table gives them
        (taxoexpan_tpu/models/taxoexpan.py:242)."""
        ego = batch.ego
        hg = self.encode(params, ego_feats, ego.ngp, ego.nsib, gen=gen,
                         train=train)
        qf = qf.repeat_interleave(batch.labels.shape[1], dim=0)
        return self.match(params, hg, qf).reshape(batch.labels.shape)

    def forward_heads(self, params: dict, batch,
                      feature_table: torch.Tensor, *,
                      gen: torch.Generator | None = None,
                      train: bool = False) -> torch.Tensor:
        """Scores of every head over one shared per-slot propagation trunk,
        [1 + len(aux_heads), G, C], row 0 the primary readout and matcher
        (taxoexpan_tpu/models/taxoexpan.py:254-290): the MTL training
        path, whose loss is the mean of the per-head losses."""
        feats, qf = self._batch_inputs(batch, feature_table)
        return self.forward_heads_with_feats(params, batch, feats, qf,
                                             gen=gen, train=train)

    def forward_heads_with_feats(self, params: dict, batch, ego_feats, qf,
                                 *, gen: torch.Generator | None = None,
                                 train: bool = False) -> torch.Tensor:
        """`forward_heads` from features gathered by the caller, as
        `forward_with_feats` (taxoexpan_tpu/models/taxoexpan.py:266)."""
        ego = batch.ego
        h = self._trunk(params, ego_feats, ego.ngp, ego.nsib, gen, train)
        qf = qf.repeat_interleave(batch.labels.shape[1], dim=0)
        heads = [(self.readout, self.matcher, params["readout"],
                  params["match"])]
        heads += [(rd, mt, hp["readout"], hp["match"])
                  for (rd, mt), hp in zip(self.aux_heads,
                                          params.get("aux", []))]
        scores = []
        for rd, mt, rp, mp in heads:
            hg = rd.apply(rp, h, ego.ngp, ego.nsib, self.max_parents)
            hg = self._append_raw(hg, ego_feats, ego.ngp, ego.nsib)
            scores.append(mt.apply(mp, hg, qf).reshape(batch.labels.shape))
        return torch.stack(scores)
