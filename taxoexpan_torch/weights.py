"""Weights carried across from the JAX package.

`params_from_jax` maps a JAX params tree (nested dicts and lists of numpy
arrays, as `taxoexpan_tpu/train/checkpoint.py` saves them) onto the port's
parameter dict by key path: `propagate.layers[i].{fc,attn_l,attn_r}`,
`propagate.pos_emb[i].emb`, `readout.emb`, `match.*` and, when present,
`aux`. Layouts stay the JAX ones (`fc` [in, H*Dh] head-major, `attn_*`
[H, Dh]); nothing is transposed.

`load_jax_checkpoint` reads a checkpoint that the JAX `train.py` wrote
without importing optax or JAX: its pickle references optax's NamedTuple
classes for the optimizer state, and a restricted unpickler maps those to
neutral tuple stand-ins. Serving needs only `state["params"]`.
`save_jax_checkpoint` writes the same payload format (without optimizer
state), so a port-made model can be served through the same reader.

`opt_state_from_jax` maps a JAX checkpoint's optimizer state (optax's
`inject_hyperparams` over Adam, AMSGrad or SGD with momentum, read as
`OpaqueState` tuples) onto the port's optimizer state, so a JAX run
resumes in the port (training/checkpoint.py).
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch

# numpy names a checkpoint of numpy arrays needs (array reconstruction for
# every pickle protocol, dtypes, numpy scalars)
_NUMPY_NAMES = frozenset({"_reconstruct", "_frombuffer", "ndarray", "dtype",
                          "scalar"})
_SAFE_GLOBALS = {
    ("builtins", "set"): set, ("builtins", "frozenset"): frozenset,
    ("builtins", "complex"): complex, ("builtins", "slice"): slice,
    ("builtins", "bytearray"): bytearray,
    ("collections", "OrderedDict"): dict,
}


class OpaqueState(tuple):
    """Stand-in for a JAX/optax class in a checkpoint (optimizer-state
    NamedTuples): keeps the positional fields as a tuple, runs no code of
    the original class."""

    qualname = "?"

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __repr__(self) -> str:
        return f"OpaqueState[{self.qualname}]{tuple.__repr__(self)}"


class _CheckpointUnpickler(pickle.Unpickler):
    """Allows numpy arrays and plain builtins; maps every `jax.*`,
    `jaxlib.*` and `optax.*` class to a fresh `OpaqueState` subclass and
    refuses everything else."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in ("jax", "jaxlib", "optax"):
            return type(name, (OpaqueState,),
                        {"qualname": f"{module}.{name}"})
        if root == "numpy" and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if (module, name) in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[(module, name)]
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}, which the port's "
            "reader does not load")


def load_jax_checkpoint(path: str | Path) -> dict:
    """The payload dict of a JAX checkpoint (`arch`, `params`, `config`,
    ...); optimizer-state classes come back as `OpaqueState` tuples."""
    with open(path, "rb") as fin:
        return _CheckpointUnpickler(fin).load()


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_jax_checkpoint(path: str | Path, params: dict,
                        config: dict) -> None:
    """Write `params` (port layout == JAX layout) as a checkpoint in the JAX
    package's payload format, atomically (sibling tmp file, then
    os.replace). No optimizer state: the file serves, it does not resume
    training."""
    state = {
        "arch": config.get("arch", {}),
        "optimizer": config.get("optimizer", {}),
        "epoch": 0,
        "params": to_numpy(params),
        "opt_state": None,
        "monitor_best": float("inf"),
        "scheduler": {},
        "config": config,
    }
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fout:
        pickle.dump(state, fout, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def _convert(template, saved, path: str):
    """Walk `template` (the port model's own init tree) and take each leaf
    of `saved` at the same key path, checking its shape."""
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"{path or 'params'}: expected a dict, "
                             f"checkpoint has {type(saved).__name__}")
        missing = set(template) - set(saved)
        extra = set(saved) - set(template)
        if missing or extra:
            raise ValueError(f"{path or 'params'}: keys differ from the "
                             f"model (missing {sorted(missing)}, extra "
                             f"{sorted(extra)}) — architecture mismatch")
        return {k: _convert(template[k], saved[k],
                            f"{path}.{k}" if path else k) for k in template}
    if isinstance(template, list):
        if not isinstance(saved, (list, tuple)) or \
                len(saved) != len(template):
            raise ValueError(f"{path}: expected a list of {len(template)}, "
                             f"checkpoint has {saved!r:.80}")
        return [_convert(t, s, f"{path}[{i}]")
                for i, (t, s) in enumerate(zip(template, saved))]
    arr = np.array(saved, dtype=np.float32)        # a writable copy
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{path}: checkpoint shape {arr.shape} != model "
                         f"shape {tuple(template.shape)} — architecture "
                         "mismatch")
    return torch.from_numpy(arr)


def _leaves_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _leaves_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def params_from_jax(tree: dict, template: dict) -> dict:
    """JAX params tree -> the port's parameter dict (float32 CPU tensors).

    `template` is the port model's `init(...)` output; every key path of it
    must exist in `tree` with the same shape, and `tree` may hold no other
    key except `aux` (auxiliary MTL heads, carried along unchecked: serving
    uses the primary head only)."""
    tree = dict(tree)
    aux = tree.pop("aux", None)
    params = _convert(template, tree, "")
    if aux is not None:
        params["aux"] = _leaves_to_torch(aux)
    return params


def restore_params(state: dict, model) -> dict:
    """The model parameters of a checkpoint payload, checked against
    `model`'s own parameter tree (the eval/infer path)."""
    template = model.init(torch.Generator().manual_seed(0))
    return params_from_jax(state["params"], template)


def params_to(params, device: torch.device):
    """The same tree with every tensor on `device` (other leaves, such as an
    optimizer state's step count, as they are)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device) if isinstance(params, torch.Tensor) else params


def _find_states(node, found: list) -> list:
    """Every OpaqueState in a nested optimizer state, depth first."""
    if isinstance(node, OpaqueState):
        found.append(node)
    if isinstance(node, (tuple, list)):
        for child in node:
            _find_states(child, found)
    elif isinstance(node, dict):
        for child in node.values():
            _find_states(child, found)
    return found


def opt_state_from_jax(saved, params: dict) -> dict:
    """The port's optimizer state (training/optim.py) from a JAX
    checkpoint's opt_state: InjectStatefulHyperparamsState(count,
    hyperparams, ...) around ScaleByAmsgradState(count, mu, nu, nu_max),
    ScaleByAdamState(count, mu, nu) or TraceState(trace). Moment trees are
    mapped by key path onto `params`' structure, like the params."""
    states = _find_states(saved, [])
    by_name = {s.qualname.rsplit(".", 1)[-1]: s for s in states}
    inject = by_name.get("InjectStatefulHyperparamsState",
                         by_name.get("InjectHyperparamsState"))
    if inject is None:
        raise ValueError("the checkpoint's optimizer state has no injected "
                         "learning rate (optax.inject_hyperparams)")
    out = {"lr": float(np.float32(inject[1]["learning_rate"]))}
    tree = lambda t: params_from_jax(t, params)  # noqa: E731
    if "ScaleByAmsgradState" in by_name:
        count, mu, nu, nu_max = by_name["ScaleByAmsgradState"]
        out.update(count=int(count), mu=tree(mu), nu=tree(nu),
                   nu_max=tree(nu_max))
    elif "ScaleByAdamState" in by_name:
        count, mu, nu = by_name["ScaleByAdamState"]
        out.update(count=int(count), mu=tree(mu), nu=tree(nu))
    elif "TraceState" in by_name:
        (trace,) = by_name["TraceState"]
        out.update(count=int(inject[0]), trace=tree(trace))
    else:
        raise ValueError(f"no optimizer state the port knows among "
                         f"{sorted(by_name)}")
    return out
