"""Inference on completely new taxons with the port.

Reads a TSV of `term \\t space-separated-embedding` lines, scores every novel
term against every node of the test working graph and writes the top-5
predicted parents per term.

    python -m taxoexpan_torch.infer --resume <ckpt> --taxon new.txt --save out.tsv

Novel embeddings are L2-normalised when the training loader normalised
its embeddings; `--sum_norm` divides by the row sum instead (the
reference's behaviour). Runs on CUDA unless `-d cpu` is given.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from . import builders
from .config import load_run_config, setup_logging
from .device import resolve_device
from .evaluation.ranker import TaxonomyRanker
from .weights import load_jax_checkpoint, restore_params

logger = logging.getLogger("taxoexpan_torch.infer")


def load_novel_taxons(path: str) -> tuple[list[str], np.ndarray]:
    """Parse `term \\t v1 v2 ...` lines; spaces in terms become
    underscores."""
    vocab, rows = [], []
    with open(path) as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            segs = line.split("\t")
            vocab.append("_".join(segs[0].split(" ")))
            rows.append([float(x) for x in segs[1].split(" ")])
    return vocab, np.asarray(rows, dtype=np.float32)


def normalize_novel(nf: np.ndarray, sum_norm: bool = False) -> np.ndarray:
    if sum_norm:
        return nf / nf.sum(axis=1, keepdims=True)
    return nf / np.maximum(np.linalg.norm(nf, axis=1, keepdims=True), 1e-12)


def main(args) -> list[list[int]]:
    device = resolve_device(args.device)
    state = load_jax_checkpoint(args.resume)
    config = load_run_config(args.resume, state)
    vocab, nf = load_novel_taxons(args.taxon)
    if config["train_data_loader"]["args"].get("normalize_embed", False):
        nf = normalize_novel(nf, args.sum_norm)

    test_cfg = dict(config["test_data_loader"]["args"])
    taxonomy = builders.build_taxonomy(test_cfg["data_path"])
    test_cfg["sampling_mode"] = 0
    sampler = builders.build_sampler(taxonomy, test_cfg, "test",
                                     test_topk=args.topk)
    model = builders.build_model(config["arch"],
                                 max_parents=sampler.max_parents,
                                 expand_factor=sampler.expand_factor)
    params = restore_params(state, model)
    # anchors = every node of the test working graph
    anchors = sorted(set(taxonomy.train_node_ids) |
                     set(taxonomy.test_node_ids))
    rank_mode = 1 if config["loss"].startswith("info_nce") else 0
    encode_chunk = args.batch_size if args.batch_size > 0 else 4096
    ranker = TaxonomyRanker(model, params, sampler, sampler.node_features,
                            encode_chunk=encode_chunk, anchors=anchors,
                            device=device)
    predictions = ranker.predict_parents(nf, rank_mode, topk=5,
                                         prior_lambda=args.prior_lambda)
    with open(args.save, "w") as fout:
        fout.write("Query\tPredicted parents\n")
        for term, parents in zip(vocab, predictions):
            names = ", ".join(taxonomy.vocab[p] for p in parents)
            fout.write(f"{term}\t{names}\n")
    logger.info("Wrote %d predictions to %s", len(vocab), args.save)
    return predictions


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Inference on novel taxons (PyTorch/CUDA port)")
    ap.add_argument("-r", "--resume", required=True, type=str)
    ap.add_argument("-t", "--taxon", required=True, type=str,
                    help="TSV of novel term + embedding")
    ap.add_argument("-s", "--save", required=True, type=str,
                    help="output TSV path")
    ap.add_argument("-d", "--device", default="cuda", type=str,
                    help="torch device (cuda | cuda:N | cpu)")
    ap.add_argument("-k", "--topk", default=-1, type=int)
    ap.add_argument("-b", "--batch_size", default=-1, type=int)
    ap.add_argument("--prior-lambda", dest="prior_lambda", default=None,
                    type=float,
                    help="structure-prior blend weight (raw_channel models)")
    ap.add_argument("--sum_norm", action="store_true",
                    help="normalize novel embeddings by row sum "
                         "(reference bug-compatible mode)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    setup_logging()
    main(parse_args())
