"""Evaluate a trained checkpoint with the port: rank every test query against
all candidate positions (one-shot anchor encoding + all-pairs scoring).

    python -m taxoexpan_torch.test_fast --resume saved/.../model_best.ckpt

Reads checkpoints that the JAX package's train.py wrote, with the
`config.json` beside them. Runs on CUDA unless `-d cpu` is given. As the
JAX test_fast.py, it runs as several processes with --coordinator /
--num_processes / --process_id, and with -m / --mesh shards the anchor
encoding over them; process 0 writes the case study.

    python -m taxoexpan_torch.test_fast -r <ckpt> -m \
        --coordinator 127.0.0.1:29500 --num_processes 2 --process_id 0
"""
from __future__ import annotations

import argparse
import logging
import time

from . import builders
from .config import load_run_config, setup_logging
from .parallel import distributed, mesh
from .evaluation.ranker import TaxonomyRanker
from .weights import load_jax_checkpoint, restore_params

logger = logging.getLogger("taxoexpan_torch.test")


def main(args) -> dict:
    t0 = time.time()
    # the process group before the first device query; no-op unless
    # --coordinator / --num_processes (or the TAXOEXPAN_* variables) ask
    distributed.maybe_initialize(args.coordinator, args.num_processes,
                                 args.process_id, args.device)
    device = distributed.rank_device(args.device)
    layout = None
    if args.mesh:
        # anchor encoding sharded over every process (dp only, as the
        # JAX package's data_parallel_mesh)
        layout = mesh.layout()
        if layout is not None:
            logger.info("Sharding anchor encoding over %d processes",
                        layout.dp.size)
    state = load_jax_checkpoint(args.resume)
    config = load_run_config(args.resume, state)
    test_cfg = dict(config["test_data_loader"]["args"])
    if args.test_data:
        test_cfg["data_path"] = args.test_data
    taxonomy = builders.build_taxonomy(test_cfg["data_path"])
    test_cfg["sampling_mode"] = 0
    sampler = builders.build_sampler(taxonomy, test_cfg, "test",
                                     test_topk=args.topk)
    t_data = time.time()
    model = builders.build_model(config["arch"],
                                 max_parents=sampler.max_parents,
                                 expand_factor=sampler.expand_factor)
    params = restore_params(state, model)
    t_ckpt = time.time()

    rank_mode = 1 if config["loss"].startswith("info_nce") else 0
    encode_chunk = args.batch_size if args.batch_size > 0 else 4096
    # structure-prior blend (raw_channel models): a fixed --prior-lambda, or
    # --prior-select to calibrate it on the validation split first
    prior_lambda = args.prior_lambda
    if args.prior_select:
        lambdas = [float(x) for x in args.prior_select.split(",")]
        val_cfg = dict(config["validation_data_loader"]["args"],
                       sampling_mode=0, max_parents=sampler.max_parents,
                       expand_factor=sampler.expand_factor)
        val_sampler = builders.build_sampler(taxonomy, val_cfg, "validation")
        val_ranker = TaxonomyRanker(model, params, val_sampler,
                                    val_sampler.node_features,
                                    encode_chunk=encode_chunk, device=device,
                                    layout=layout)
        prior_lambda, curve = val_ranker.select_prior_lambda(
            lambdas, rank_mode, select_metric=args.prior_metric)
        logger.info("prior-blend selection on validation (%s): %s -> "
                    "lam=%.4g", args.prior_metric, curve, prior_lambda)
    ranker = TaxonomyRanker(model, params, sampler, sampler.node_features,
                            encode_chunk=encode_chunk, device=device,
                            layout=layout)
    logger.info("Number of queries: %d", len(sampler.node_list))
    ranker.encode_all_anchors()
    t_encode = time.time()
    result, cases = ranker.evaluate(config["metrics"], rank_mode,
                                    case_study=bool(args.case),
                                    prior_lambda=prior_lambda)
    logger.info("stage timing: data+sampler %.1fs, checkpoint %.1fs, "
                "encode %.1fs, rank %.1fs", t_data - t0, t_ckpt - t_data,
                t_encode - t_ckpt, time.time() - t_encode)
    if args.case and distributed.rank() == 0:
        # the metrics are the same on every process; one writes
        with open(args.case, "w") as fout:
            for row in cases:
                fout.write("\t".join(row) + "\n")
    logger.info("%s", result)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Testing taxonomy expansion model (PyTorch/CUDA port)")
    ap.add_argument("-td", "--test_data", default="", type=str,
                    help="test data path; defaults to the config's")
    ap.add_argument("-r", "--resume", required=True, type=str,
                    help="path to checkpoint")
    ap.add_argument("-d", "--device", default="cuda", type=str,
                    help="torch device (cuda | cuda:N | cpu)")
    ap.add_argument("-k", "--topk", default=-1, type=int,
                    help="retrieval-prefilter size, -1 = no retrieval stage")
    ap.add_argument("-b", "--batch_size", default=-1, type=int,
                    help="anchor-encoding chunk size; -1 = default 4096")
    ap.add_argument("-c", "--case", default="", type=str,
                    help="case study output TSV ('' = disabled)")
    ap.add_argument("--prior-lambda", dest="prior_lambda", default=None,
                    type=float,
                    help="structure-prior blend weight (raw_channel models)")
    ap.add_argument("--prior-select", dest="prior_select", default="",
                    type=str,
                    help="comma-separated lam grid calibrated on the "
                         "validation split (e.g. '0,0.25,1,4')")
    ap.add_argument("--prior-metric", dest="prior_metric",
                    default="combined_metrics", type=str,
                    help="selection metric for --prior-select")
    distributed.add_multiprocess_args(ap)
    return ap.parse_args(argv)


if __name__ == "__main__":
    setup_logging()
    try:
        main(parse_args())
    finally:
        distributed.shutdown()
