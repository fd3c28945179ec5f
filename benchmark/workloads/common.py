"""What the workload drivers share: the seeds drawn from `--seed`, the
generated taxonomy in the program's form, and the weights."""
from __future__ import annotations

import numpy as np

from ..frozen import synthetic


def derive_seeds(seed: int) -> dict:
    """Independent 31-bit seeds of the run's parts, from `--seed` (any
    non-negative integer)."""
    names = ("data", "weights", "weights_b", "loader", "steps", "requests",
             "sample")
    state = np.random.SeedSequence(int(seed)).generate_state(len(names))
    return {n: int(v) & 0x7FFFFFFF for n, v in zip(names, state)}


def generate(traffic: dict, arch: dict, seed: int):
    """The taxonomy of the traffic's data block, at the configuration's
    input width."""
    d = traffic["data"]
    return synthetic.synthetic_taxonomy_v2(
        num_nodes=d["num_nodes"], dim=arch["args"]["in_dim"],
        max_children=d["max_children"], noise=d["noise"], seed=seed)


def program_taxonomy(tax):
    """The program's `Taxonomy` holding the generated arrays."""
    from taxoexpan_torch.data.taxonomy import Taxonomy
    return Taxonomy(name="benchmark", vocab=[f"node_{i}@@@{i}" for i in
                                             range(tax.num_nodes)],
                    features=tax.features, edges=tax.edges,
                    train_node_ids=list(tax.train_node_ids),
                    validation_node_ids=list(tax.validation_node_ids),
                    test_node_ids=list(tax.test_node_ids))


def unit_rows(x: np.ndarray) -> np.ndarray:
    """Rows scaled to unit L2 norm (the loaders' normalize_embed)."""
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


def sync(device) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
