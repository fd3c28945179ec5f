"""Factory functions assembling the port's components from a config tree
(port of the serving parts of `taxoexpan_tpu/builders.py`): the same config
keys and value semantics, so a JAX run's `config.json` drives the port.

Settings the port does not have yet raise instead of being ignored; the
training-only ones (dropout rates, optimizer, kernel choice) are not read.
"""
from __future__ import annotations

from .data.sampler import MaskedGraphSampler
from .data.taxonomy import Taxonomy
from .models import TaxoExpan


def build_taxonomy(data_path: str) -> Taxonomy:
    return Taxonomy.load(data_path)


def build_sampler(taxonomy: Taxonomy, loader_cfg: dict, mode: str,
                  test_topk: int = -1, seed: int = 0) -> MaskedGraphSampler:
    """From a `*_data_loader.args` config block."""
    return MaskedGraphSampler(
        taxonomy,
        mode=mode,
        sampling_mode=loader_cfg.get("sampling_mode", 1),
        negative_size=loader_cfg.get("negative_size", 32),
        expand_factor=loader_cfg.get("expand_factor", 64),
        cache_refresh_time=loader_cfg.get("cache_refresh_time", 128),
        normalize_embed=loader_cfg.get("normalize_embed", False),
        test_topk=loader_cfg.get("test_topk", test_topk),
        max_parents=loader_cfg.get("max_parents", "auto"),
        seed=seed)


def build_model(arch_cfg: dict, *, max_parents: int,
                expand_factor: int) -> TaxoExpan:
    """From the `arch.args` config block."""
    a = arch_cfg["args"] if "args" in arch_cfg else arch_cfg
    for key, ported in (("compute_dtype", "float32"), ("pos_mode", "bias")):
        if a.get(key, ported) != ported:
            raise ValueError(f"{key}={a[key]!r} is not ported yet; the "
                             f"port serves {key}={ported!r}")
    return TaxoExpan(
        a.get("propagation_method", "PGAT"),
        a.get("readout_method", "WMR"),
        a.get("matching_method", "BIM"),
        in_dim=a["in_dim"],
        hidden_dim=a["hidden_dim"],
        out_dim=a["out_dim"],
        pos_dim=a.get("pos_dim", 0),
        num_layers=a.get("num_layers", 1),
        heads=a.get("heads"),
        max_parents=max_parents,
        expand_factor=expand_factor,
        raw_channel=a.get("raw_channel", False))
