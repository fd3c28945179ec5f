"""Train a TaxoExpan model with the port (PyTorch, CUDA kernels).

    python -m taxoexpan_torch.train -c configs/config.mag.json
    python -m taxoexpan_torch.train -c ... --lr 1e-3 --ep 20 -d cpu
    python -m taxoexpan_torch.train -r saved/models/<name>/<ts>/checkpoint-epoch3.ckpt
    # one process a rank (here 2 ranks on this host); the config's
    # "parallel": {"dp": D, "mp": M} lays them out as D x M:
    python -m taxoexpan_torch.train -c ... --coordinator 127.0.0.1:29500 \
        --num_processes 2 --process_id 0   # and --process_id 1

The JAX `train.py`'s config files, override flags and multi-process flags
(also read from TAXOEXPAN_COORDINATOR / TAXOEXPAN_NUM_PROCESSES /
TAXOEXPAN_PROCESS_ID); runs on CUDA unless `-d cpu` is given, each rank on
card (its index among its host's ranks) % device_count. The `parallel`
block lays the processes out as dp x mp (parallel/mesh.py): dp ranks split
the group batch, mp ranks split the GAT layers' heads;
`parallel.feature_mode: "partitioned"` row-partitions the feature table
across the dp ranks, with the halo exchange TAXOEXPAN_HALO selects
(all_to_all, or ring: K6 on the card). Checkpoints hold the JAX package's
payload keys: the JAX package and the port's test_fast serve them, and
--resume takes a checkpoint of either package.
"""
from __future__ import annotations

import argparse
import logging
import time
from datetime import datetime

import torch

from . import builders
from .config import ConfigParser, CustomArg
from .parallel import distributed, mesh
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


def _parallel(config):
    """(process layout or None, feature mode) from the config's `parallel`
    block, as the JAX train.py:69-106 reads it: mp runs the GAT heads
    tensor-parallel; it falls back to 1 with a warning when it does not
    divide the processes or divides none of `arch.args.heads`. dp defaults
    to processes // mp; an explicit dp must make dp x mp = processes. With
    one process the table is replicated; partitioned, it is sharded over
    dp and replicated over mp."""
    par = config.get("parallel", {}) or {}
    world = distributed.world_size()
    mp = int(par.get("mp", 1) or 1)
    if mp > 1 and world % mp:
        logger.warning("parallel.mp=%d does not divide %d processes; "
                       "disabling tensor parallelism", mp, world)
        mp = 1
    if mp > 1:
        # a layer whose head count mp does not divide runs whole on every mp
        # rank; if that is every layer, mp only shrinks dp
        heads = config["arch"]["args"].get("heads") or []
        if heads and all(h % mp for h in heads):
            logger.warning(
                "parallel.mp=%d divides none of the head counts %s; all "
                "layers would replicate over mp (wasting ~%dx throughput) "
                "- disabling tensor parallelism, using dp only",
                mp, heads, mp)
            mp = 1
    layout = mesh.layout(int(par["dp"]) if par.get("dp") else None, mp)
    if layout is not None:
        logger.info("process layout: dp %d x mp %d", layout.dp.size,
                    layout.mp_size)
    feature_mode = par.get("feature_mode", "replicated")
    return layout, feature_mode if layout is not None else "replicated"


def main(config: ConfigParser) -> dict:
    """Train as the config says; returns the last epoch's log."""
    device = distributed.rank_device(config.args.device)
    layout, feature_mode = _parallel(config)
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
                      device=device, layout=layout,
                      feature_mode=feature_mode)
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
    # multi-process runs, see parallel/distributed.py and parallel/mesh.py
    ap.add_argument("--coordinator", default=None, type=str,
                    help="process-group rendezvous address host:port")
    ap.add_argument("--num_processes", default=None, type=int,
                    help="total process count (dp x mp ranks)")
    ap.add_argument("--process_id", default=None, type=int,
                    help="this process's rank in [0, num_processes)")
    for opt in OPTIONS:
        ap.add_argument(*opt.flags, default=None, type=opt.type)
    args = ap.parse_args(argv)
    # the process group comes first: the ranks share rank 0's run directory
    if distributed.maybe_initialize(args.coordinator, args.num_processes,
                                    args.process_id, args.device):
        run_id = distributed.broadcast_object(
            datetime.now().strftime(r"%m%d_%H%M%S"))
        return ConfigParser(args, OPTIONS, run_id=run_id,
                            primary=distributed.rank() == 0)
    return ConfigParser(args, OPTIONS)


if __name__ == "__main__":
    try:
        main(parse_args())
    finally:
        distributed.shutdown()
