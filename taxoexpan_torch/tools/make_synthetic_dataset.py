"""Generate a synthetic taxonomy dataset pickle (no external data needed),
with the port alone (the flags of scripts/make_synthetic_dataset.py).

The reference's MAG/SemEval datasets are external downloads; this produces
a learnable stand-in for smoke tests and benchmarks.

    python -m taxoexpan_torch.tools.make_synthetic_dataset \
        --out data/synth.pickle.bin --nodes 2000 --dim 64

--v2 selects the discriminative generator (synthetic_taxonomy_v2): rotated
ancestor cores make cosine-to-parent retrieval fail by construction while
the structural signal stays learnable.
"""
from __future__ import annotations

import argparse
import os

from ..data.synthetic import synthetic_taxonomy, synthetic_taxonomy_v2
from ..data.taxonomy import Taxonomy


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--nodes", type=int, default=2000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--max_children", type=int, default=10)
    p.add_argument("--noise", type=float, default=0.35,
                   help="per-edge feature drift; higher = less"
                        " trivially-informative embeddings")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--v2", action="store_true",
                   help="discriminative benchmark generator "
                        "(synthetic_taxonomy_v2); --noise becomes the "
                        "unit-norm SNR knob (try 0.5-1.5)")
    return p.parse_args(argv)


def main(argv=None) -> Taxonomy:
    args = parse_args(argv)
    gen = synthetic_taxonomy_v2 if args.v2 else synthetic_taxonomy
    taxo = gen(num_nodes=args.nodes, dim=args.dim,
               max_children=args.max_children, noise=args.noise,
               seed=args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    taxo.save(args.out)
    print(f"wrote {args.out}: {taxo.num_nodes} nodes, {taxo.num_edges} "
          f"edges, {len(taxo.train_node_ids)}/"
          f"{len(taxo.validation_node_ids)}/{len(taxo.test_node_ids)} split")
    return taxo


if __name__ == "__main__":
    main()
