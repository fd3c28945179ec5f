"""Build .terms/.taxo/.embed files from raw MAG Field-of-Study dumps, with
the port alone (scripts/preprocess_mag.py over the port's data/embeddings).

Script port of data_preprocessing/mag-cs-fos.ipynb / mag-all-fos.ipynb
(the reference ships them as notebooks): parse `FieldsOfStudy.txt` (9-column
rows: tx_id, rank, norm_name, display_name, main_type, level, paper_count,
citation_count, create_date) and `FieldOfStudyChildren.txt` (parent \t child),
optionally restrict to the subtree under a root field (e.g. computer science),
and emit term embeddings by mean-pooling token vectors from a word2vec
text-format embedding file (the notebooks use fastText; any token->vector
text file works here).

    python -m taxoexpan_torch.tools.preprocess_mag --fos FieldsOfStudy.txt \
        --children FieldOfStudyChildren.txt --embed wiki.en.vec \
        --root-name "computer science" --name computer_science \
        --out data/MAG_CS
"""
from __future__ import annotations

import argparse
import os
from collections import deque

import numpy as np

from ..data.embeddings import load_word2vec_format, save_word2vec_format


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--fos", required=True, help="FieldsOfStudy.txt path")
    p.add_argument("--children", required=True,
                   help="FieldOfStudyChildren.txt path (parent \\t child)")
    p.add_argument("--embed", required=True,
                   help="token embedding file (word2vec text format)")
    p.add_argument("--root-name", default="",
                   help="restrict to the subtree under this field name")
    p.add_argument("--min-level", type=int, default=-1)
    p.add_argument("--name", required=True, help="output file prefix")
    p.add_argument("--out", required=True, help="output directory")
    args = p.parse_args(argv)

    tx2name: dict[str, str] = {}
    with open(args.fos, encoding="utf-8") as fin:
        for line in fin:
            line = line.rstrip("\n")
            if not line:
                continue
            segs = line.split("\t")
            if len(segs) != 9:
                raise ValueError(f"expected 9 columns: {line!r}")
            tx_id, _rank, norm_name, _disp, _mt, level = segs[:6]
            if args.min_level >= 0 and int(level) < args.min_level:
                continue
            tx2name[tx_id] = norm_name

    edges: list[tuple[str, str]] = []
    with open(args.children, encoding="utf-8") as fin:
        for line in fin:
            segs = line.strip().split("\t")
            if len(segs) == 2 and segs[0] in tx2name and segs[1] in tx2name:
                edges.append((segs[0], segs[1]))

    if args.root_name:
        root = next((t for t, n in tx2name.items() if n == args.root_name),
                    None)
        if root is None:
            raise SystemExit(f"root field {args.root_name!r} not found")
        children: dict[str, list[str]] = {}
        for a, b in edges:
            children.setdefault(a, []).append(b)
        keep = {root}
        dq = deque([root])
        while dq:
            for c in children.get(dq.popleft(), []):
                if c not in keep:
                    keep.add(c)
                    dq.append(c)
        tx2name = {t: n for t, n in tx2name.items() if t in keep}
        edges = [(a, b) for a, b in edges if a in keep and b in keep]

    # term embeddings: mean of token vectors (notebook approach)
    tokens, vectors = load_word2vec_format(args.embed)
    tok2row = {t: i for i, t in enumerate(tokens)}
    dim = vectors.shape[1]
    out_ids, out_vecs = [], []
    missing = 0
    for tx, name in tx2name.items():
        rows = [tok2row[w] for w in name.split() if w in tok2row]
        if not rows:
            missing += 1
            continue
        out_ids.append(tx)
        out_vecs.append(vectors[rows].mean(axis=0))
    kept = set(out_ids)
    edges = [(a, b) for a, b in edges if a in kept and b in kept]

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.name}.terms"), "w",
              encoding="utf-8") as f:
        for tx in out_ids:
            f.write(f"{tx}\t{tx2name[tx]}\n")
    with open(os.path.join(args.out, f"{args.name}.taxo"), "w",
              encoding="utf-8") as f:
        for a, b in edges:
            f.write(f"{a}\t{b}\n")
    save_word2vec_format(os.path.join(args.out, f"{args.name}.terms.embed"),
                         out_ids, np.asarray(out_vecs, dtype=np.float32))
    print(f"wrote {len(out_ids)} terms, {len(edges)} edges "
          f"({missing} terms dropped for missing embeddings, dim={dim})")


if __name__ == "__main__":
    main()
