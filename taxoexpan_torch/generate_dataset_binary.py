"""Generate a binary dataset pickle from raw .terms/.taxo/.embed files
with the port alone (the flags of the JAX package's
generate_dataset_binary.py; the reference's generate_dataset_binary.py:4-15):

    python -m taxoexpan_torch.generate_dataset_binary \
        --taxon_name computer_science --data_dir ./data/MAG_CS \
        [--embed_suffix word2vec] [--existing_partition]

The pickle lands beside the raw files as <taxon_name>.pickle.bin (with the
suffix: <taxon_name>.<embed_suffix>.pickle.bin).
"""
from __future__ import annotations

import argparse

from .data.taxonomy import Taxonomy


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Generate binary dataset")
    parser.add_argument("-t", "--taxon_name", required=True, type=str,
                        help="taxonomy name (file prefix)")
    parser.add_argument("-d", "--data_dir", required=True, type=str,
                        help="directory containing .terms/.taxo/.embed files")
    parser.add_argument("-es", "--embed_suffix", default="", type=str,
                        help="embed file suffix")
    parser.add_argument("-p", "--existing_partition", action="store_true",
                        help="use existing .terms.{train,validation,test}")
    return parser.parse_args(argv)


def main(argv=None) -> Taxonomy:
    args = parse_args(argv)
    taxo = Taxonomy.from_raw_dir(args.taxon_name, args.data_dir,
                                 embed_suffix=args.embed_suffix,
                                 existing_partition=args.existing_partition)
    print(f"Saved pickled dataset: {taxo.num_nodes} nodes, "
          f"{taxo.num_edges} edges, "
          f"{len(taxo.train_node_ids)}/{len(taxo.validation_node_ids)}/"
          f"{len(taxo.test_node_ids)} train/val/test")
    return taxo


if __name__ == "__main__":
    main()
