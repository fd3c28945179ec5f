"""Factory functions assembling the port's components from a config tree
(port of `taxoexpan_tpu/builders.py`): the same config keys and value
semantics, so a JAX run's `config.json` drives the port.

Settings the port does not have yet raise instead of being ignored
(bf16, pos_mode="concat"); the JAX kernel choice (`kernel`) is not read:
the port runs its kernels on CUDA and their plain versions on the CPU.
"""
from __future__ import annotations

from .data.loader import GroupBatchLoader
from .data.sampler import MaskedGraphSampler
from .data.taxonomy import Taxonomy
from .models import TaxoExpan
from .training.optim import Optimizer, PlateauScheduler


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
                             f"port runs {key}={ported!r}")
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
        feat_drop=a.get("feat_drop", 0.1),
        attn_drop=a.get("attn_drop", 0.1),
        hidden_drop=a.get("hidden_drop", 0.1),
        out_drop=a.get("out_drop", 0.1),
        max_parents=max_parents,
        expand_factor=expand_factor,
        attention_dim=a.get("attention_dim", 100),
        aux_heads=a.get("aux_heads"),
        raw_channel=a.get("raw_channel", False))


def build_loader(sampler: MaskedGraphSampler, loader_cfg: dict,
                 seed: int = 0) -> GroupBatchLoader:
    return GroupBatchLoader(
        sampler,
        batch_size=loader_cfg.get("batch_size", 32),
        shuffle=loader_cfg.get("shuffle", True),
        seed=seed,
        prefetch=min(int(loader_cfg.get("num_workers", 2)) or 0, 4))


def build_optimizer_from_config(opt_cfg: dict,
                                trainer_cfg: dict | None = None) -> Optimizer:
    """From `optimizer` + `trainer.grad_clip`."""
    args = opt_cfg.get("args", {})
    return Optimizer(opt_type=opt_cfg.get("type", "Adam"),
                     lr=args.get("lr", 1e-3),
                     weight_decay=args.get("weight_decay", 0.0),
                     amsgrad=args.get("amsgrad", False),
                     grad_clip=(trainer_cfg or {}).get("grad_clip", -1))


def build_scheduler(sched_cfg: dict | None) -> PlateauScheduler | None:
    """From `lr_scheduler`; only ReduceLROnPlateau, as in the JAX package."""
    if not sched_cfg:
        return None
    if sched_cfg.get("type") != "ReduceLROnPlateau":
        raise ValueError(
            f"unsupported lr_scheduler type {sched_cfg.get('type')!r}; "
            "use ReduceLROnPlateau or omit")
    a = sched_cfg.get("args", {})
    return PlateauScheduler(mode=a.get("mode", "min"),
                            factor=a.get("factor", 0.1),
                            patience=a.get("patience", 10),
                            threshold=a.get("threshold", 1e-4),
                            min_lr=a.get("min_lr", 0.0),
                            verbose=a.get("verbose", False))
