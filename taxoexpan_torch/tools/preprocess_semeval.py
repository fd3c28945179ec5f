"""Build a WordNet noun/verb taxonomy in .terms/.taxo/.embed format for
SemEval-2016 Task 14 experiments, with the port alone
(scripts/preprocess_semeval.py over the port's data/embeddings).

Script port of data_preprocessing/semeval-task14.ipynb: enumerate WordNet
synsets of the requested POS via nltk, take hypernym->hyponym pairs as
taxonomy edges, and embed each synset by mean-pooling token vectors of its
lemma (fallback: definition tokens) from a word2vec text-format file.
nltk + the wordnet corpus are required only for this script (gated import).

    python -m taxoexpan_torch.tools.preprocess_semeval --pos n \
        --embed wiki.en.vec \
        --name wordnet_noun --out data/semeval-2016-task-14
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.embeddings import load_word2vec_format, save_word2vec_format


def build_taxonomy_files(synsets, tokens, vectors, name: str,
                         out_dir: str) -> tuple[int, int]:
    """Pure build step: WordNet-style synsets -> .terms/.taxo/.embed files.

    `synsets` is any iterable of objects with the nltk Synset surface used
    here (name(), hyponyms(), lemmas()[0].name(), definition()) — the e2e
    test drives this with a stub mini-corpus so the pipeline is exercised
    without the external nltk download (semeval-task14.ipynb port)."""
    edges = []
    for s in synsets:
        edges.extend((s.name(), h.name()) for h in s.hyponyms())

    tok2row = {t: i for i, t in enumerate(tokens)}
    ids, vecs = [], []
    for s in synsets:
        words = s.lemmas()[0].name().replace("_", " ").split()
        rows = [tok2row[w] for w in words if w in tok2row]
        if not rows:
            rows = [tok2row[w] for w in s.definition().split()
                    if w in tok2row]
        if not rows:
            continue
        ids.append(s.name())
        vecs.append(vectors[rows].mean(axis=0))
    kept = set(ids)
    edges = [(a, b) for a, b in edges if a in kept and b in kept]

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.terms"), "w",
              encoding="utf-8") as f:
        for s in ids:
            f.write(f"{s}\t{s}\n")
    with open(os.path.join(out_dir, f"{name}.taxo"), "w",
              encoding="utf-8") as f:
        for a, b in edges:
            f.write(f"{a}\t{b}\n")
    save_word2vec_format(os.path.join(out_dir, f"{name}.terms.embed"),
                         ids, np.asarray(vecs, dtype=np.float32))
    return len(ids), len(edges)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pos", default="n", choices=["n", "v"])
    p.add_argument("--embed", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    try:
        from nltk.corpus import wordnet as wn
        list(wn.all_synsets(args.pos))
    except Exception as e:  # nltk or corpus missing
        raise SystemExit(
            "this script needs nltk with the wordnet corpus downloaded "
            f"(nltk.download('wordnet')): {e}")

    synsets = list(wn.all_synsets(args.pos))
    tokens, vectors = load_word2vec_format(args.embed)
    n_syn, n_edges = build_taxonomy_files(synsets, tokens, vectors,
                                          args.name, args.out)
    print(f"wrote {n_syn} synsets, {n_edges} edges")


if __name__ == "__main__":
    main()
