"""Plain PyTorch reference of the TaxoExpan model the benchmark runs: the
position-enhanced star GAT and GCN layers, the WMR readout, the bilinear
matcher (BIM), InfoNCE and optax's AMSGrad, in float32 with TF32 off.

It follows the TaxoExpan paper (WWW 2020) and the reference
implementation's model_zoo.py, written directly on dense star egonets:
every egonet is a depth-1 star laid out as [0, P) grandparents | P anchor |
(P, N) siblings, whose in-edges are

    gp_i   <- gp_i             (self-loop)
    anchor <- anchor, gp_i     (valid grandparents only)
    sib_j  <- sib_j, anchor

A GAT layer: ft = [x | pe] @ fc split into heads; el = ft . attn_l,
er = ft . attn_r; each destination's weights are the softmax over its
in-edges of leaky_relu(el[src] + er[dst], 0.2); the output is the weighted
sum of the sources' ft. Hidden layers flatten the heads and apply
leaky_relu 0.01; the final layer's heads are averaged. A GCN layer:
z = [x | pe] @ w, out = d^-1/2 * sum over in-edges of d^-1/2 z + b, with d
the in-degree (self-loops included). pe is the position embedding of the
slot's class (0 grandparent, 1 anchor, 2 sibling), concatenated to the
layer's input. In training, dropout drops the layer input's columns, the
pe columns and (GAT) the attention weights after the softmax, with the
masks of `frozen/dropout_hash.py`.

Nothing here imports the program; the weights are the tree the benchmark
made (`benchmark/weights.py`), in the program's layout. The dense form
computes every slot, valid or not, and masks where the mathematics does.
"""
from __future__ import annotations

import torch

from ..frozen import dropout_hash as dh

LEAKY_ATTN = 0.2
LEAKY_HIDDEN = 0.01
B1, B2, EPS = 0.9, 0.999, 1e-8


def slot_masks(ngp: torch.Tensor, nsib: torch.Tensor, p: int, n: int):
    """(gp valid [B, P], sib valid [B, S], node valid [B, N]) bool."""
    dev = ngp.device
    gp = torch.arange(p, device=dev)[None, :] < ngp.long()[:, None]
    sib = torch.arange(n - p - 1, device=dev)[None, :] < nsib.long()[:, None]
    anchor = torch.ones((ngp.shape[0], 1), dtype=torch.bool, device=dev)
    return gp, sib, torch.cat([gp, anchor, sib], dim=1)


def gather(table: torch.Tensor, node_ids: torch.Tensor, ngp, nsib,
           p: int) -> torch.Tensor:
    """Egonet features [B, N, D], invalid slots zero."""
    feats = table[node_ids.long()]
    _, _, valid = slot_masks(ngp, nsib, p, node_ids.shape[1])
    return feats * valid[..., None].float()


def slot_pe(emb: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """[N, pos] position embedding of every slot."""
    cls = torch.full((n,), 2, dtype=torch.long, device=emb.device)
    cls[:p] = 0
    cls[p] = 1
    return emb[cls]


def _layer_input(x, pe, seed, drop):
    """[x * m | pe * m_pe] with the layer's feature masks (drop > 0) or
    [x | pe]."""
    b, n, din = x.shape
    pe = pe[None].expand(b, n, -1)
    if drop > 0:
        x = x * dh.slot_mask(seed, dh.STREAM_FEAT, b, n, din, drop, x.device)
        pe = pe * dh.slot_mask(seed, dh.STREAM_PE, b, n, pe.shape[-1], drop,
                               x.device)
    return torch.cat([x, pe], dim=-1)


def _leaky(v, alpha):
    return torch.where(v >= 0, v, alpha * v)


def gat_layer(x, lp: dict, pe, ngp, nsib, p: int, heads: int, *,
              seed: int = 0, feat_drop: float = 0.0, attn_drop: float = 0.0,
              final: bool = False):
    """One star-GAT layer: hidden [B, N, H*Dh] after leaky_relu 0.01, or
    final: the head-averaged per-slot output [B, N, Dh]."""
    b, n, _ = x.shape
    s = n - p - 1
    xin = _layer_input(x, pe, seed, feat_drop)
    ft = (xin @ lp["fc"]).reshape(b, n, heads, -1)
    el = (ft * lp["attn_l"]).sum(-1)                             # [B, N, H]
    er = (ft * lp["attn_r"]).sum(-1)
    gp_ok, _, _ = slot_masks(ngp, nsib, p, n)
    # the anchor's in-edges: grandparents, then its self-loop
    la = _leaky(torch.cat([el[:, :p], el[:, p:p + 1]], dim=1)
                + er[:, p:p + 1], LEAKY_ATTN)                    # [B, P+1, H]
    ok = torch.cat([gp_ok, torch.ones_like(gp_ok[:, :1])], dim=1)
    wa = torch.softmax(la.masked_fill(~ok[..., None], float("-inf")), dim=1)
    # a sibling's in-edges: the anchor, then its self-loop
    ls = _leaky(torch.stack([el[:, p:p + 1].expand(b, s, heads),
                             el[:, p + 1:]], dim=2)
                + er[:, p + 1:, None], LEAKY_ATTN)               # [B, S, 2, H]
    ws = torch.softmax(ls, dim=2)
    w_gp = torch.ones((b, p, heads), device=x.device)
    if attn_drop > 0:
        def m(kind, width):
            return torch.stack([dh.attention_mask(seed, h, kind, b, width,
                                                  attn_drop, x.device)
                                for h in range(heads)], dim=-1)
        wa = wa * torch.cat([m(0, p), m(1, 1)], dim=1)
        ws = ws * torch.stack([m(2, s), m(3, s)], dim=2)
        w_gp = w_gp * m(4, p)
    out_gp = w_gp[..., None] * ft[:, :p]
    out_anchor = (wa[..., None] * ft[:, :p + 1]).sum(dim=1, keepdim=True)
    out_sib = (ws[:, :, 0, :, None] * ft[:, p:p + 1]
               + ws[:, :, 1, :, None] * ft[:, p + 1:])
    out = torch.cat([out_gp, out_anchor, out_sib], dim=1)       # [B,N,H,Dh]
    if final:
        return out.mean(dim=2)
    return _leaky(out.reshape(b, n, -1), LEAKY_HIDDEN)


def gcn_layer(x, lp: dict, pe, ngp, nsib, p: int, *, seed: int = 0,
              drop: float = 0.0, final: bool = False):
    """One star-GCN layer [B, N, Dout]; hidden layers after leaky_relu
    0.01, the final one without activation."""
    b, n, _ = x.shape
    z = _layer_input(x, pe, seed, drop) @ lp["w"]
    gp_ok, sib_ok, valid = slot_masks(ngp, nsib, p, n)
    deg = torch.cat([torch.ones((b, p), device=x.device),
                     (1.0 + ngp.float())[:, None],
                     torch.full((b, n - p - 1), 2.0, device=x.device)],
                    dim=1) * valid.float()
    norm = torch.where(deg > 0, deg.clamp(min=1e-12).rsqrt(),
                       torch.zeros_like(deg))[..., None]
    zn = z * norm
    anchor = zn[:, p] + (zn[:, :p] * gp_ok[..., None].float()).sum(dim=1)
    agg = torch.cat([zn[:, :p], anchor[:, None], zn[:, p + 1:]
                     + zn[:, p:p + 1]], dim=1)
    out = agg * norm + lp["b"]
    return out if final else _leaky(out, LEAKY_HIDDEN)


def encode(params: dict, arch: dict, feats, ngp, nsib, p: int, *,
           seeds=None) -> torch.Tensor:
    """Egonet features [B, N, in] -> graph embeddings [B, out] (WMR). With
    `seeds` (one a layer) the train forward: dropout on at the arch's
    rates; without, the eval forward."""
    a = arch["args"]
    gat = a["propagation_method"] in ("GAT", "PGAT")
    layers = params["propagate"]["layers"]
    n = feats.shape[1]
    h = feats
    last = len(layers) - 1
    for l, lp in enumerate(layers):
        pe = slot_pe(params["propagate"]["pos_emb"][l]["emb"], p, n)
        seed = 0 if seeds is None else seeds[l]
        final = l == last
        if gat:
            drop = a.get("feat_drop", 0.1) if seeds is not None else 0.0
            adrop = a.get("attn_drop", 0.1) if seeds is not None else 0.0
            h = gat_layer(h, lp, pe, ngp, nsib, p, a["heads"][l], seed=seed,
                          feat_drop=drop, attn_drop=adrop, final=final)
        else:
            rate = (a.get("feat_drop", 0.1) if l == 0 else
                    a.get("out_drop", 0.1) if final else
                    a.get("hidden_drop", 0.1))
            h = gcn_layer(h, lp, pe, ngp, nsib, p,
                          seed=seed, drop=rate if seeds is not None else 0.0,
                          final=final)
    _, _, valid = slot_masks(ngp, nsib, p, n)
    w = torch.nn.functional.softplus(params["readout"]["emb"])[:, 0]
    cls = torch.full((n,), 2, dtype=torch.long, device=feats.device)
    cls[:p] = 0
    cls[p] = 1
    counts = (ngp + 1 + nsib).float()[:, None]
    return (h * (valid.float() * w[cls][None])[..., None]).sum(1) / counts


def bilinear(params: dict, hg: torch.Tensor, qf: torch.Tensor):
    """BIM scores of pairs: hg [B, l], qf [B, r] -> [B]."""
    return ((hg @ params["match"]["w"]) * qf).sum(-1)


def all_pairs(params: dict, hg: torch.Tensor, qf: torch.Tensor):
    """BIM scores of every query against every candidate: [Q, C]."""
    return qf @ (hg @ params["match"]["w"]).T


def info_nce(scores, cand_mask):
    """Cross-entropy against column 0 over each group's real candidates,
    summed over the groups that have one."""
    masked = scores.masked_fill(~cand_mask, float("-inf"))
    nll = torch.logsumexp(masked, dim=1) - scores[:, 0]
    return torch.where(cand_mask.any(1), nll, torch.zeros_like(nll)).sum()


def amsgrad_step(params: dict, grads: dict, state: dict, lr: float):
    """optax.amsgrad: mu, nu the moments, nu_max the largest bias-corrected
    second moment so far; update = mu_hat / (sqrt(nu_max) + eps)."""
    t = state["count"] + 1
    bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** t
    new = {"count": t, "mu": {}, "nu": {}, "nu_max": {}}
    out = {}
    for k, p in params.items():
        g = grads[k]
        mu = (1 - B1) * g + B1 * state["mu"][k]
        nu = (1 - B2) * (g * g) + B2 * state["nu"][k]
        nu_max = torch.maximum(state["nu_max"][k], nu / bc2.to(g.device))
        out[k] = p + ((mu / bc1.to(g.device))
                      / (torch.sqrt(nu_max) + EPS)) * -lr
        new["mu"][k], new["nu"][k], new["nu_max"][k] = mu, nu, nu_max
    return out, new


def flatten(tree, prefix=()) -> dict:
    """{key path string: leaf} of a weight tree."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flatten(tree[key], prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in flatten(t, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): tree}


def unflatten(flat: dict, template):
    """The tree of `template`'s layout holding `flat`'s leaves."""
    def go(t, prefix):
        if isinstance(t, dict):
            return {k: go(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v, prefix + (i,)) for i, v in enumerate(t)]
        return flat["/".join(map(str, prefix))]
    return go(template, ())
