#!/usr/bin/env python
"""simple_MLP baseline family in PyTorch: MLP, DeepSetMLP, DeepAPGMLP (the
port of `taxoexpan_tpu/baselines/simple_mlp.py`).

Re-implementation of baselines/simple_MLP (model.py:11-115, data_loader.py,
train.py, test.py): frozen pretrained embeddings + a 3-layer scorer over a
(parent, query) pair, optionally with DeepSet-encoded sibling and
grandparent sets (padded with a zero UNK row, data_loader.py:151-160).
Trained self-supervised on existing edges with queue-sampled negatives and
BCE loss, by the port's optax-exact Adam (`training/optim.Optimizer`);
evaluated by ranking every candidate parent for held-out leaves. The
scorers are `nn.Module`s whose parameters keep the JAX package's layout
(weights [in, out], x @ W), so `load_jax_params` carries JAX's parameters
across. Dropout draws from an explicit `torch.Generator`. The products are
plain torch GEMMs, as the JAX package leaves them to XLA.

    python -m taxoexpan_torch.baselines.simple_mlp --data ... \
        --model DeepSetMLP

Runs on CUDA unless `-d cpu` is given.
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch
from torch import nn

from ..data.taxonomy import Taxonomy, build_csr
from ..device import resolve_device
from ..metrics import (hit_at_1, hit_at_3, hit_at_5, macro_mr, micro_mr,
                       mrr_scaled_10, ranks_from_scores)
from ..models.init import linear_params
from ..training.optim import Optimizer
from ..tree import tree_leaves, tree_map
from ..weights import params_from_jax

MAX_SIBLINGS = 50       # data_loader.py SubGraphDataset cap (:145-179)
MAX_GRANDPARENTS = 20
DROP = 0.5              # the reference's dropout rate (model.py)
MODELS = ("MLP", "DeepSetMLP", "DeepAPGMLP")


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """Inverted dropout with keep bits from `gen`; identity unless
    training at a positive rate."""
    if not train or not rate:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1 - rate), torch.zeros((), device=x.device))


class Linear(nn.Module):
    """nn.Linear's init and function with the weight stored [in, out]."""

    def __init__(self, gen: torch.Generator, in_f: int, out_f: int):
        super().__init__()
        p = linear_params(gen, in_f, out_f)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class Head(nn.Module):
    """The 3-layer scorer (model.py:11-46): dropout on its input, then
    fc1, relu, fc2, relu, fc3 -> one energy a row."""

    def __init__(self, gen, in_dim: int, h1: int, h2: int):
        super().__init__()
        self.fc1 = Linear(gen, in_dim, h1)
        self.fc2 = Linear(gen, h1, h2)
        self.fc3 = Linear(gen, h2, 1)

    def forward(self, x, gen, train: bool, drop: float):
        x = dropout(x, drop, gen, train)
        h = torch.relu(self.fc1(x))
        h = torch.relu(self.fc2(h))
        return self.fc3(h)[..., 0]


class SetEncoder(nn.Module):
    """DeepSet (model.py:48-70): the sum of the (dropped) member
    embeddings, then fc1, relu, fc2."""

    def __init__(self, gen, d: int):
        super().__init__()
        self.fc1 = Linear(gen, d, 2 * d)
        self.fc2 = Linear(gen, 2 * d, d)

    def forward(self, ids, embed, gen, train: bool, drop: float):
        e = dropout(embed[ids], drop, gen, train)        # [B, K, D]
        return self.fc2(torch.relu(self.fc1(e.sum(dim=1))))


class EdgeScorer(nn.Module):
    """The energy of a (parent, query) pair: MLP over [parent, query],
    DeepSetMLP adds the parent's sibling set, DeepAPGMLP also its
    grandparent set."""

    def __init__(self, gen, kind: str, d: int, first_hidden: int,
                 second_hidden: int, drop: float = DROP):
        super().__init__()
        if kind not in MODELS:
            raise ValueError(f"unknown simple_MLP model {kind!r}")
        self.kind, self.drop = kind, drop
        in_mult = {"MLP": 2, "DeepSetMLP": 3, "DeepAPGMLP": 4}[kind]
        self.head = Head(gen, in_mult * d, first_hidden, second_hidden)
        if kind in ("DeepSetMLP", "DeepAPGMLP"):
            self.sib_enc = SetEncoder(gen, d)
        if kind == "DeepAPGMLP":
            self.gp_enc = SetEncoder(gen, d)

    def forward(self, embed, parents, children, siblings, gps,
                gen: torch.Generator | None = None, train: bool = False):
        parts = [embed[parents], embed[children]]
        if self.kind in ("DeepSetMLP", "DeepAPGMLP"):
            parts.append(self.sib_enc(siblings, embed, gen, train,
                                      self.drop))
        if self.kind == "DeepAPGMLP":
            parts.append(self.gp_enc(gps, embed, gen, train, self.drop))
        return self.head(torch.cat(parts, dim=-1), gen, train, self.drop)

    def param_tree(self) -> dict:
        """The parameters in the JAX package's tree layout ({"head":
        {"fc1": {"w", "b"}, ...}, "sib_enc": ..., "gp_enc": ...})."""
        def tree(module):
            return {name: tree(child) for name, child in
                    module.named_children()} or dict(
                module.named_parameters())
        return tree(self)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BCE on the inverted target (model.py bce_loss over energies),
    summed."""
    t = 1.0 - labels
    return (torch.clamp(logits, min=0) - logits * t
            + torch.log1p(torch.exp(-logits.abs()))).sum()


class SimpleMLPBaseline:
    def __init__(self, taxonomy: Taxonomy, model: str = "MLP",
                 first_hidden: int = 128, second_hidden: int = 64,
                 negative_size: int = 16, lr: float = 1e-3, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.kind = model
        self.taxo = taxonomy
        feats = np.asarray(taxonomy.features, np.float32)
        feats = feats / np.maximum(
            np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
        # UNK zero row for set padding (model.py:38-40)
        self.embed = torch.from_numpy(np.vstack(
            [feats, np.zeros((1, feats.shape[1]), np.float32)])).to(
            self.device)
        self.unk = feats.shape[0]
        self.model = EdgeScorer(torch.Generator().manual_seed(seed), model,
                                feats.shape[1], first_hidden,
                                second_hidden).to(self.device)
        self.optimizer = Optimizer("Adam", lr=lr)
        self.opt_state = self.optimizer.init(self.model.param_tree())
        self.drop_gen = torch.Generator(self.device).manual_seed(seed + 1)

        self.rng = random.Random(seed)
        self.negative_size = negative_size
        # training graph: edges among train nodes only
        train_set = set(int(t) for t in taxonomy.train_node_ids)
        keep = [(int(p), int(c)) for p, c in taxonomy.edges
                if int(p) in train_set and int(c) in train_set]
        self.train_edges = keep
        src = np.asarray([p for p, _ in keep], np.int32)
        dst = np.asarray([c for _, c in keep], np.int32)
        self.children = build_csr(taxonomy.num_nodes, src, dst)
        self.parents_csr = build_csr(taxonomy.num_nodes, dst, src)
        self.queue = [p for p, _ in keep] * 2
        self.pointer = 0

    def load_jax_params(self, tree: dict) -> None:
        """Take the JAX baseline's `params` (a tree of arrays)."""
        params = params_from_jax(tree, self.model.param_tree())
        with torch.no_grad():
            for p, v in zip(tree_leaves(self.model.param_tree()),
                            tree_leaves(params)):
                p.copy_(v)

    # ----------------------------------------------------------------- model
    def _ids(self, *arrays) -> list[torch.Tensor]:
        """Node id arrays as int64 tensors on the device (no copy for
        ones already there)."""
        return [torch.as_tensor(a).to(self.device, torch.int64)
                for a in arrays]

    def loss(self, parents, children, siblings, gps, labels,
             train: bool = True) -> torch.Tensor:
        logits = self.model(self.embed, *self._ids(parents, children,
                                                   siblings, gps),
                            self.drop_gen, train)
        return bce_loss(logits, torch.as_tensor(labels).to(self.device))

    def step(self, parents, children, siblings, gps, labels) -> torch.Tensor:
        """One Adam step on a batch; returns its loss (on the device)."""
        params = self.model.param_tree()
        for p in tree_leaves(params):
            p.grad = None
        loss = self.loss(parents, children, siblings, gps, labels)
        loss.backward()
        new, self.opt_state = self.optimizer.update(
            tree_map(lambda p: p.grad, params), self.opt_state,
            tree_map(lambda p: p.detach(), params))
        with torch.no_grad():
            for p, v in zip(tree_leaves(params), tree_leaves(new)):
                p.copy_(v)
        return loss.detach()

    # ------------------------------------------------------------------ data
    def _sets_for(self, parent: int, query: int):
        sibs = [c for c in self.children.neighbors(parent).tolist()
                if c != query][:MAX_SIBLINGS]
        gps = self.parents_csr.neighbors(parent).tolist()[:MAX_GRANDPARENTS]
        sibs = sibs + [self.unk] * (MAX_SIBLINGS - len(sibs))
        gps = gps + [self.unk] * (MAX_GRANDPARENTS - len(gps))
        return sibs, gps

    def _sample_batch(self, batch_edges):
        parents, childs, sibs, gps, labels = [], [], [], [], []
        for p, c in batch_edges:
            for anchor, lab in [(p, 1.0)] + [
                    (n, 0.0) for n in self._negatives(c)]:
                parents.append(anchor)
                childs.append(c)
                s, g = self._sets_for(anchor, c)
                sibs.append(s)
                gps.append(g)
                labels.append(lab)
        return (np.asarray(parents, np.int32), np.asarray(childs, np.int32),
                np.asarray(sibs, np.int32), np.asarray(gps, np.int32),
                np.asarray(labels, np.float32))

    def _negatives(self, query):
        if self.pointer == 0:
            self.rng.shuffle(self.queue)
        out = [x for x in self.queue[self.pointer:
                                     self.pointer + self.negative_size]
               if x != query]
        self.pointer += self.negative_size
        if self.pointer >= len(self.queue):
            self.pointer = 0
        return out

    # ----------------------------------------------------------------- train
    def train(self, epochs: int = 5, batch_size: int = 64,
              log=print) -> list[float]:
        """Returns each epoch's mean batch loss."""
        means = []
        for ep in range(epochs):
            self.rng.shuffle(self.train_edges)
            losses = [self.step(*self._sample_batch(
                self.train_edges[i:i + batch_size]))
                for i in range(0, len(self.train_edges), batch_size)]
            # one readback an epoch
            means.append(float(torch.stack(losses).mean()) if losses
                         else 0.0)
            log(f"[simple_MLP:{self.kind}] epoch {ep + 1}: "
                f"loss {means[-1]:.3f}")
        return means

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def scores(self, cand, sibs, gps, query: int) -> np.ndarray:
        """Eval-mode energies of `query` under every candidate."""
        cand, sibs, gps = self._ids(cand, sibs, gps)
        return self.model(self.embed, cand, torch.full_like(cand, int(query)),
                          sibs, gps, train=False).cpu().numpy()

    def evaluate(self) -> dict:
        taxo = self.taxo
        train_ids = [int(t) for t in taxo.train_node_ids]
        parents_full = taxo.parents
        # per-candidate sets, once
        cand = np.asarray(train_ids, np.int32)
        sibs = np.zeros((len(cand), MAX_SIBLINGS), np.int32)
        gps = np.zeros((len(cand), MAX_GRANDPARENTS), np.int32)
        for i, a in enumerate(cand):
            sibs[i], gps[i] = self._sets_for(int(a), -1)

        cand, sibs, gps = self._ids(cand, sibs, gps)   # once, on the device
        pos_of_train = {t: i for i, t in enumerate(train_ids)}
        all_ranks = []
        for q in taxo.test_node_ids:
            pos_idx = [pos_of_train[p] for p in
                       parents_full.neighbors(int(q)).tolist()
                       if int(p) in pos_of_train]
            if not pos_idx:
                continue
            scores = self.scores(cand, sibs, gps, int(q))
            # energy semantics: smaller = better (mode 0)
            all_ranks.append(ranks_from_scores(scores, pos_idx, mode=0))
        return {
            "model": self.kind,
            "num_queries": len(all_ranks),
            "macro_mr": macro_mr(all_ranks),
            "micro_mr": micro_mr(all_ranks),
            "hit_at_1": hit_at_1(all_ranks),
            "hit_at_3": hit_at_3(all_ranks),
            "hit_at_5": hit_at_5(all_ranks),
            "mrr_scaled_10": mrr_scaled_10(all_ranks),
        }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="MLP", choices=list(MODELS))
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("-d", "--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    b = SimpleMLPBaseline(Taxonomy.load(args.data), model=args.model,
                          lr=args.lr, device=args.device)
    b.train(epochs=args.epochs)
    result = b.evaluate()
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
