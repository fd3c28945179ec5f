"""Random weights made by the benchmark, on the device, from the seed.

The tree has the program's layout (its `propagate` / `readout` / `match`
keys and [in, out] weights, as `taxoexpan_torch/weights.py` documents it)
and the distributions of the reference implementation's initialisers:
xavier normal with gain 1.414 for a GAT layer's fc and attention vectors,
U(-1/sqrt(out), +) for a GCN layer's w and b, N(0, 1) for the embeddings,
U(-1/sqrt(l_dim), +) for the bilinear matcher. All normal leaves come from
one `randn` and all uniform ones from one `rand` of a generator on the
card, then are cut and scaled. Both sides, the program and the plain
reference, get this one tree.
"""
from __future__ import annotations

import math

import torch


def layer_shapes(arch: dict) -> list[tuple[int, int, int]]:
    """(input width with the pe columns, output width a head, heads) of each
    propagation layer; heads is 1 for GCN."""
    a = arch["args"]
    pos = a.get("pos_dim", 0) if a["propagation_method"] in (
        "PGAT", "PGCN") else 0
    n_hidden = a.get("num_layers", 1)
    if a["propagation_method"] in ("GAT", "PGAT"):
        heads = a["heads"]
        specs = [(a["in_dim"] + pos, a["hidden_dim"], heads[0])]
        specs += [(a["hidden_dim"] * heads[l - 1] + pos, a["hidden_dim"],
                   heads[l]) for l in range(1, n_hidden)]
        specs.append((a["hidden_dim"] * heads[-2] + pos, a["out_dim"],
                      heads[-1]))
        return specs
    specs = [(a["in_dim"] + pos, a["hidden_dim"], 1)]
    specs += [(a["hidden_dim"] + pos, a["hidden_dim"], 1)
              for _ in range(n_hidden - 1)]
    specs.append((a["hidden_dim"] + pos, a["out_dim"], 1))
    return specs


def _plan(arch: dict) -> list[tuple[tuple, str, tuple, float]]:
    """(key path, 'normal' | 'uniform', shape, scale) of every leaf."""
    a = arch["args"]
    gat = a["propagation_method"] in ("GAT", "PGAT")
    pos = a.get("pos_dim", 0) if a["propagation_method"] in (
        "PGAT", "PGCN") else 0
    plan = []
    for l, (din, dout, heads) in enumerate(layer_shapes(arch)):
        pre = ("propagate", "layers", l)
        if gat:
            hd = heads * dout
            plan.append((pre + ("fc",), "normal", (din, hd),
                         1.414 * math.sqrt(2.0 / (din + hd))))
            for key in ("attn_l", "attn_r"):
                plan.append((pre + (key,), "normal", (heads, dout),
                             1.414 * math.sqrt(2.0 / (hd + dout))))
        else:
            bound = 1.0 / math.sqrt(dout)
            plan.append((pre + ("w",), "uniform", (din, dout), bound))
            plan.append((pre + ("b",), "uniform", (dout,), bound))
        if pos:
            plan.append((("propagate", "pos_emb", l, "emb"), "normal",
                         (3, pos), 1.0))
    if a.get("readout_method", "WMR") != "WMR" or \
            a.get("matching_method", "BIM") != "BIM":
        raise ValueError("the benchmark's weights cover the WMR readout and "
                         "the BIM matcher")
    plan.append((("readout", "emb"), "normal", (3, 1), 1.0))
    plan.append((("match", "w"), "uniform", (a["out_dim"], a["in_dim"]),
                 1.0 / math.sqrt(a["out_dim"])))
    return plan


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make_params(arch: dict, seed: int, device) -> dict:
    """The weight tree of `arch` drawn from `seed` on `device`, float32."""
    plan = _plan(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    count = {"normal": 0, "uniform": 0}
    for _path, kind, shape, _scale in plan:
        count[kind] += math.prod(shape)
    pools = {"normal": torch.randn(count["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(count["uniform"], generator=gen,
                                   device=device) * 2.0 - 1.0}
    offset = {"normal": 0, "uniform": 0}
    tree: dict = {}
    for path, kind, shape, scale in plan:
        n = math.prod(shape)
        leaf = pools[kind][offset[kind]:offset[kind] + n].view(shape) * scale
        offset[kind] += n
        _put(tree, path, leaf.contiguous())
    tree["propagate"].setdefault("pos_emb", [])
    return tree


def same_layout(a, b, path: str = "") -> list[str]:
    """Where two weight trees differ in keys, lengths or leaf shapes."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(a)} vs {sorted(b)}"]
        return [d for k in a for d in same_layout(a[k], b[k],
                                                  f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: {len(a)} vs {len(b)} entries"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same_layout(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return [] if a.shape == b.shape else [
            f"{path}: shape {tuple(a.shape)} vs {tuple(b.shape)}"]
    return [f"{path}: {type(a).__name__} vs {type(b).__name__}"]
