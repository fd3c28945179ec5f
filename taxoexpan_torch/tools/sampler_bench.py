"""Host-sampler throughput of the port's loader backends at the MAG-CS
batch shape (the port's form of scripts/sampler_bench.py). Host only: it
needs no card.

A train step of config.mag.json consumes 128 InfoNCE groups x 32
candidates = 4096 egonets. This measures, in batches and egonets a second:

  1. the native C++ batch fill alone (`NativeSampler.sample_train_batch`),
  2. the Python sampler's batch fill alone (the loader's "python" backend),
  3. the whole GroupBatchLoader with its prefetch thread under "auto",

on a dataset pickle (`--data`) or on a synthetic taxonomy with MAG-CS
statistics (`--nodes`, default 30000). Prints one JSON line.

    python -m taxoexpan_torch.tools.sampler_bench [--data <pickle>]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import native
from ..data.loader import GroupBatchLoader
from ..data.sampler import MaskedGraphSampler
from ..data.synthetic import synthetic_taxonomy
from ..data.taxonomy import Taxonomy


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", default=None,
                   help="dataset pickle (default: a synthetic taxonomy)")
    p.add_argument("--nodes", type=int, default=30000,
                   help="nodes of the synthetic taxonomy without --data")
    p.add_argument("--groups", type=int, default=128)
    p.add_argument("--negative-size", type=int, default=31)
    p.add_argument("--expand-factor", type=int, default=50)
    p.add_argument("--max-parents", type=int, default=13,
                   help="grandparent slots (13 + 1 + 50 = config.mag.json's "
                        "64 slots)")
    p.add_argument("--cache-refresh-time", type=int, default=64)
    p.add_argument("--batches", type=int, default=24,
                   help="batches timed for the native fill and the loader")
    p.add_argument("--python-batches", type=int, default=6,
                   help="batches timed for the Python fill (slower)")
    return p.parse_args(argv)


def rate(fn, batches: int, egonets_per_batch: int) -> dict:
    t0 = time.perf_counter()
    for _ in range(batches):
        fn()
    dt = time.perf_counter() - t0
    return {"batches": batches, "seconds": dt,
            "batches_per_s": batches / dt,
            "egonets_per_s": batches * egonets_per_batch / dt}


def main(argv=None) -> dict:
    args = parse_args(argv)
    taxo = Taxonomy.load(args.data) if args.data else synthetic_taxonomy(
        num_nodes=args.nodes, dim=16, max_children=40, seed=7)
    sampler = MaskedGraphSampler(
        taxo, mode="train", sampling_mode=1,
        negative_size=args.negative_size, expand_factor=args.expand_factor,
        cache_refresh_time=args.cache_refresh_time,
        max_parents=args.max_parents)
    egonets = args.groups * (1 + args.negative_size)
    node_list = np.asarray(sampler.node_list, np.int32)

    def query_batch(i: int) -> np.ndarray:
        # rotating slices, as an epoch would see them
        start = (i * args.groups) % max(len(node_list) - args.groups, 1)
        return node_list[start:start + args.groups]

    out = {"nodes": taxo.num_nodes, "queries": len(node_list),
           "egonets_per_batch": egonets}
    fill = native.NativeSampler(sampler, seed=0)
    fill.sample_train_batch(query_batch(0))      # warm the egonet cache
    step = iter(range(1, 1 << 30))
    out["native_fill"] = rate(
        lambda: fill.sample_train_batch(query_batch(next(step))),
        args.batches, egonets)

    py_loader = GroupBatchLoader(sampler, batch_size=args.groups,
                                 prefetch=0, backend="python")
    py_batches = iter(py_loader._batches())
    out["python_fill"] = rate(lambda: next(py_batches),
                              min(args.python_batches, len(py_loader)),
                              egonets)

    loader = GroupBatchLoader(sampler, batch_size=args.groups, prefetch=2,
                              backend="auto")
    it = iter(loader)
    next(it)                                     # the producer started
    out["loader_backend"] = loader.backend
    out["loader"] = rate(lambda: next(it),
                         min(args.batches, len(loader) - 2), egonets)
    for _ in it:                                 # the producer finishes
        pass
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
