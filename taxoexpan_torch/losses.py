"""Loss functions over grouped score matrices (port of
`taxoexpan_tpu/losses.py`).

All losses are SUMMED (reduction="sum" in the reference) over valid
candidates / groups; padded entries contribute 0. The learning rate's
meaning depends on that: info_nce_loss is a sum over groups, not a mean.
For bce / square_exp / margin_rank the model output is an energy (smaller =
better); for info_nce it is a similarity logit.

scores [G, C] float, labels [G, C] float (1.0 = positive), cand_mask
[G, C] bool.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _group_valid(cand_mask: torch.Tensor) -> torch.Tensor:
    return cand_mask.any(dim=1)


def info_nce_loss(scores, labels, cand_mask):
    """Cross-entropy against column 0 (the single positive), summed over
    valid groups. Requires the training layout (sampling_mode 1)."""
    masked = torch.where(cand_mask, scores,
                         torch.full_like(scores, NEG_INF))
    nll = torch.logsumexp(masked, dim=1) - scores[:, 0]
    return torch.where(_group_valid(cand_mask), nll,
                       torch.zeros_like(nll)).sum()


def bce_loss(scores, labels, cand_mask, beta: float = 1.0):
    """BCE-with-logits against the inverted target (energies), summed."""
    target = 1.0 - labels
    per = (torch.clamp(scores, min=0) - scores * target
           + torch.log1p(torch.exp(-scores.abs())))
    return torch.where(cand_mask, per, torch.zeros_like(per)).sum()


def square_exp_loss(scores, labels, cand_mask, beta: float = 1.0):
    """sum(pos^2) + beta * sum(exp(-neg))."""
    zeros = torch.zeros_like(scores)
    pos = torch.where(cand_mask & (labels == 1), scores, zeros)
    neg_term = torch.where(cand_mask & (labels == 0), torch.exp(-scores),
                           zeros)
    return (pos ** 2).sum() + beta * neg_term.sum()


def margin_rank_loss(scores, labels, cand_mask, margin: float = 1.0):
    """Sum over within-group (pos, neg) pairs of max(0, margin + s_pos -
    s_neg)."""
    pos_mask = cand_mask & (labels == 1)
    neg_mask = cand_mask & (labels == 0)
    pair = torch.clamp(margin + scores[:, :, None] - scores[:, None, :],
                       min=0.0)
    valid = pos_mask[:, :, None] & neg_mask[:, None, :]
    return torch.where(valid, pair, torch.zeros_like(pair)).sum()


def nll_loss(scores, labels, cand_mask):
    """NLL against column 0 on log-probability inputs."""
    return torch.where(_group_valid(cand_mask), -scores[:, 0],
                       torch.zeros_like(scores[:, 0])).sum()


LOSSES = {
    "info_nce_loss": info_nce_loss,
    "bce_loss": bce_loss,
    "square_exp_loss": square_exp_loss,
    "margin_rank_loss": margin_rank_loss,
    "nll_loss": nll_loss,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; available: {list(LOSSES)}")
    return LOSSES[name]
