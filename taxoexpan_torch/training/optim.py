"""Optimizers and LR scheduling (port of `taxoexpan_tpu/train/optim.py`).

The JAX package builds `optax.inject_hyperparams(chain(...))`; this module
writes the same updates by hand on tensors, step for step:

    Adam   [clip_by_global_norm] [add_decayed_weights (L2 into the grad)]
           scale_by_adam or scale_by_amsgrad, scale by -lr
    AdamW  [clip] scale_by_adam, add_decayed_weights (decoupled), -lr
    SGD    [clip] [add_decayed_weights] trace(momentum), -lr

AMSGrad follows optax's rule, not torch's: optax keeps
nu_max = max(nu_max, nu_hat) over the BIAS-CORRECTED second moment and
updates mu_hat / (sqrt(nu_max) + eps), where `torch.optim.Adam(amsgrad=
True)` takes the max over the raw moment; the two diverge from step 2.

State is a dict: count (steps taken), lr (float32 value, the injected
hyperparameter), mu / nu / nu_max (Adam) or trace (SGD), trees shaped like
the params. `update` returns new tensors and leaves its inputs untouched.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import tree_leaves, tree_map

OPTIMIZERS = ("Adam", "AdamW", "SGD")
B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer:
    def __init__(self, opt_type: str = "Adam", lr: float = 1e-3,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 grad_clip: float = -1.0, momentum: float = 0.9):
        if opt_type not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {opt_type!r}; "
                             f"available: {OPTIMIZERS}")
        self.opt_type = opt_type
        self.lr = lr
        self.weight_decay = weight_decay
        # optax.adamw has no amsgrad form; the JAX builder ignores it there
        self.amsgrad = bool(amsgrad) and opt_type == "Adam"
        self.grad_clip = grad_clip
        self.momentum = momentum

    def init(self, params) -> dict:
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        state = {"count": 0, "lr": float(np.float32(self.lr))}
        if self.opt_type == "SGD":
            state["trace"] = zeros()
        else:
            state["mu"], state["nu"] = zeros(), zeros()
            if self.amsgrad:
                state["nu_max"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> tuple[object, dict]:
        """One step: (new params, new state)."""
        g = grads
        if self.grad_clip and self.grad_clip > 0:
            g = clip_by_global_norm(g, self.grad_clip)
        wd = self.weight_decay
        if wd and self.opt_type in ("Adam", "SGD"):   # L2 before the moments
            g = tree_map(lambda u, p: u + wd * p, g, params)
        count = state["count"] + 1
        new = {"count": count, "lr": state["lr"]}
        if self.opt_type == "SGD":
            trace = tree_map(lambda u, t: u + self.momentum * t, g,
                             state["trace"])
            new["trace"] = u = trace
        else:
            mu = tree_map(lambda u, m: (1 - B1) * u + B1 * m, g, state["mu"])
            nu = tree_map(lambda u, v: (1 - B2) * (u * u) + B2 * v, g,
                          state["nu"])
            # bias corrections in float32, as optax computes 1 - decay**count
            dev = tree_leaves(mu)[0].device
            bc1 = (1 - torch.tensor(B1, dtype=torch.float32) ** count).to(dev)
            bc2 = (1 - torch.tensor(B2, dtype=torch.float32) ** count).to(dev)
            new["mu"], new["nu"] = mu, nu
            if self.amsgrad:
                nu_max = tree_map(lambda m, v: torch.maximum(m, v / bc2),
                                  state["nu_max"], nu)
                new["nu_max"] = nu_max
                u = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v) + EPS),
                             mu, nu_max)
            else:
                u = tree_map(lambda m, v: (m / bc1)
                             / (torch.sqrt(v / bc2) + EPS), mu, nu)
            if wd and self.opt_type == "AdamW":   # decoupled weight decay
                u = tree_map(lambda x, p: x + wd * p, u, params)
        neg_lr = -state["lr"]
        params = tree_map(lambda p, x: p + x * neg_lr, params, u)
        return params, new


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: scale every grad by max_norm / norm when
    the global norm reaches max_norm."""
    norm = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(grads)))
    keep = norm < max_norm            # a device scalar: no host sync
    return tree_map(lambda x: torch.where(keep, x, (x / norm) * max_norm),
                    grads)


def get_lr(state: dict) -> float:
    return float(state["lr"])


def set_lr(state: dict, lr: float) -> dict:
    state["lr"] = float(np.float32(lr))
    return state


class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (the scheduler
    of every shipped config): multiply LR by `factor` after `patience`
    epochs without (threshold-relative) improvement."""

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 min_lr: float = 0.0, verbose: bool = False):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad_epochs = 0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float, opt_state: dict):
        """Update with a new monitored value; returns (opt_state, reduced)."""
        if self._improved(value):
            self.best = value
            self.num_bad_epochs = 0
            return opt_state, False
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            old = get_lr(opt_state)
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt_state = set_lr(opt_state, new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3e} -> {new:.3e}")
            self.num_bad_epochs = 0
            return opt_state, True
        return opt_state, False

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
