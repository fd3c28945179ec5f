"""Train a TaxoExpan model with the port (PyTorch, CUDA kernels).

    python -m taxoexpan_torch.train -c configs/config.mag.json
    python -m taxoexpan_torch.train -c ... --lr 1e-3 --ep 20 -d cpu
    python -m taxoexpan_torch.train -r saved/models/<name>/<ts>/checkpoint-epoch3.ckpt

The JAX `train.py`'s config files and override flags, minus its
multi-process ones; runs on CUDA unless `-d cpu` is given. Checkpoints hold
the JAX package's payload keys: the JAX package and the port's test_fast
serve them, and --resume takes a checkpoint of either package.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from . import builders
from .config import ConfigParser, CustomArg
from .device import resolve_device
from .training import Trainer
from .tree import tree_leaves

logger = logging.getLogger("taxoexpan_torch.train")

OPTIONS = [
    # data loader (self-supervision generation)
    CustomArg(["--train_data"], type=str,
              target=("train_data_loader", "args", "data_path")),
    CustomArg(["--validation_data"], type=str,
              target=("validation_data_loader", "args", "data_path")),
    CustomArg(["--bs", "--batch_size"], type=int,
              target=("train_data_loader", "args", "batch_size")),
    CustomArg(["--ns", "--negative_size"], type=int,
              target=("train_data_loader", "args", "negative_size")),
    CustomArg(["--ef", "--expand_factor"], type=int,
              target=("train_data_loader", "args", "expand_factor")),
    CustomArg(["--crt", "--cache_refresh_time"], type=int,
              target=("train_data_loader", "args", "cache_refresh_time")),
    CustomArg(["--nw", "--num_workers"], type=int,
              target=("train_data_loader", "args", "num_workers")),
    # trainer and optimizer
    CustomArg(["--loss"], type=str, target=("loss",)),
    CustomArg(["--ep", "--epochs"], type=int, target=("trainer", "epochs")),
    CustomArg(["--fve", "--full_validation_every"], type=int,
              target=("trainer", "full_validation_every")),
    CustomArg(["--v", "--verbose_level"], type=int,
              target=("trainer", "verbosity")),
    CustomArg(["--lr", "--learning_rate"], type=float,
              target=("optimizer", "args", "lr")),
    CustomArg(["--wd", "--weight_decay"], type=float,
              target=("optimizer", "args", "weight_decay")),
    # model architecture
    CustomArg(["--pm", "--propagation_method"], type=str,
              target=("arch", "args", "propagation_method")),
    CustomArg(["--rm", "--readout_method"], type=str,
              target=("arch", "args", "readout_method")),
    CustomArg(["--mm", "--matching_method"], type=str,
              target=("arch", "args", "matching_method")),
    CustomArg(["--in_dim"], type=int, target=("arch", "args", "in_dim")),
    CustomArg(["--hidden_dim"], type=int,
              target=("arch", "args", "hidden_dim")),
    CustomArg(["--out_dim"], type=int, target=("arch", "args", "out_dim")),
    CustomArg(["--pos_dim"], type=int, target=("arch", "args", "pos_dim")),
    CustomArg(["--num_heads"], type=int,
              target=("arch", "args", "heads", 0)),
    CustomArg(["--feat_drop"], type=float,
              target=("arch", "args", "feat_drop")),
    CustomArg(["--attn_drop"], type=float,
              target=("arch", "args", "attn_drop")),
]


def _refuse_unported(config) -> None:
    par = config.get("parallel", {}) or {}
    if int(par.get("dp", 1) or 1) > 1 or int(par.get("mp", 1) or 1) > 1 \
            or par.get("feature_mode", "replicated") != "replicated":
        raise ValueError(f"parallel={par!r}: the device mesh, tensor "
                         "parallelism and the partitioned feature table are "
                         "not ported yet; the port trains on one device")


def main(config: ConfigParser) -> dict:
    """Train as the config says; returns the last epoch's log."""
    device = resolve_device(config.args.device)
    _refuse_unported(config)
    taxonomy = builders.build_taxonomy(
        config["train_data_loader"]["args"]["data_path"])
    train_cfg = config["train_data_loader"]["args"]
    train_sampler = builders.build_sampler(taxonomy, train_cfg, "train")
    train_loader = builders.build_loader(train_sampler, train_cfg)

    valid_loader = None
    full_valid_sampler = None
    if "validation_data_loader" in config:
        val_cfg = dict(config["validation_data_loader"]["args"])
        # the validation batch layout shares the train sampler's static
        # grandparent-slot count
        val_cfg["max_parents"] = train_sampler.max_parents
        val_sampler = builders.build_sampler(taxonomy, val_cfg, "validation")
        valid_loader = builders.build_loader(val_sampler, val_cfg)
        if int(config["trainer"].get("full_validation_every", 0) or 0) > 0:
            fv_cfg = dict(val_cfg, sampling_mode=0)
            full_valid_sampler = builders.build_sampler(taxonomy, fv_cfg,
                                                        "validation")

    model = builders.build_model(
        config["arch"], max_parents=train_sampler.max_parents,
        expand_factor=train_sampler.expand_factor)
    params = model.init(torch.Generator().manual_seed(config.get("seed", 0)))
    logger.info("%s: %d parameters", type(model).__name__,
                sum(p.numel() for p in tree_leaves(params)))
    optimizer = builders.build_optimizer_from_config(config["optimizer"],
                                                     config["trainer"])
    trainer = Trainer(model, params, optimizer, optimizer.init(params),
                      loss_name=config["loss"],
                      metric_names=config["metrics"],
                      feature_table=train_sampler.node_features,
                      train_loader=train_loader,
                      valid_loader=valid_loader,
                      config=dict(config.config),
                      lr_scheduler=builders.build_scheduler(
                          config.get("lr_scheduler")),
                      save_dir=config.save_dir,
                      log_dir=config.log_dir,
                      rng_seed=config.get("seed", 0),
                      full_valid_sampler=full_valid_sampler,
                      device=device)
    if config.resume is not None:
        trainer.resume(config.resume)
    start = time.time()
    log = trainer.train()
    logger.info("Finish training in %.1f seconds", time.time() - start)
    return log


def parse_args(argv=None) -> ConfigParser:
    ap = argparse.ArgumentParser(
        description="Training taxonomy expansion model (PyTorch/CUDA port)")
    ap.add_argument("-c", "--config", default=None, type=str,
                    help="config file path")
    ap.add_argument("-r", "--resume", default=None, type=str,
                    help="path to latest checkpoint")
    ap.add_argument("-d", "--device", default="cuda", type=str,
                    help="torch device (cuda | cuda:N | cpu)")
    ap.add_argument("-s", "--suffix", default="", type=str,
                    help="suffix indicating this run")
    for opt in OPTIONS:
        ap.add_argument(*opt.flags, default=None, type=opt.type)
    return ConfigParser(ap.parse_args(argv), OPTIONS)


if __name__ == "__main__":
    main(parse_args())
