"""Checkpoint save / resume (port of `taxoexpan_tpu/train/checkpoint.py`).

The payload keys are the JAX package's: arch, optimizer, epoch, params,
opt_state, monitor_best, scheduler, config, pickled as numpy arrays in
plain dicts and lists. So the JAX package's `restore_params` and the
port's serving reader (`weights.restore_params`) both read the port's
files, and the port resumes from either package's files: its own optimizer
state (a dict, see training/optim.py) or a JAX checkpoint's optax state
(`weights.opt_state_from_jax`).
"""
from __future__ import annotations

import logging
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from ..weights import (load_jax_checkpoint, opt_state_from_jax,
                       params_from_jax, params_to, restore_params, to_numpy)

logger = logging.getLogger(__name__)


def save_checkpoint(path: str | Path, *, params, opt_state: dict,
                    epoch: int, monitor_best: float, config: dict,
                    scheduler_state: dict | None = None) -> None:
    state = {
        "arch": config.get("arch", {}),
        "optimizer": config.get("optimizer", {}),
        "epoch": int(epoch),
        "params": to_numpy(params),
        "opt_state": to_numpy(opt_state),
        "monitor_best": float(monitor_best),
        "scheduler": scheduler_state or {},
        "config": config,
    }
    # atomic: a sibling tmp file, fsync, then os.replace
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fout:
        pickle.dump(state, fout, pickle.HIGHEST_PROTOCOL)
        fout.flush()
        os.fsync(fout.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str | Path) -> dict:
    """Either package's checkpoint (optax classes as neutral tuples)."""
    return load_jax_checkpoint(path)


def restore_into(state: dict, *, model, optimizer, config: dict | None,
                 device: torch.device) -> tuple[dict, dict]:
    """(params, opt_state) on `device` from a checkpoint payload, with the
    reference's resume warnings when the arch or optimizer type changed
    (then the optimizer starts afresh)."""
    params = restore_params(state, model)
    fresh = optimizer.init(params)
    if config is not None:
        if state.get("arch") != config.get("arch"):
            logger.warning(
                "Warning: Architecture configuration given in config file is "
                "different from that of checkpoint.")
        if state.get("optimizer", {}).get("type") != \
                config.get("optimizer", {}).get("type"):
            logger.warning(
                "Warning: Optimizer type given in config file is different "
                "from that of checkpoint. Optimizer parameters not resumed.")
            return params_to(params, device), params_to(fresh, device)
    saved = state.get("opt_state")
    if isinstance(saved, dict) and "count" in saved:       # the port's own
        opt_state = {"count": int(saved["count"]),
                     "lr": float(np.float32(saved["lr"]))}
        for key in fresh:
            if key not in opt_state:
                opt_state[key] = params_from_jax(saved[key], params)
    else:
        opt_state = opt_state_from_jax(saved, params)
    if set(opt_state) != set(fresh):
        raise ValueError(f"checkpoint optimizer state has {sorted(opt_state)}"
                         f", this optimizer keeps {sorted(fresh)}")
    return params_to(params, device), params_to(opt_state, device)
