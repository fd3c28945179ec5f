"""Word2vec text-format embedding IO, replacing the reference's gensim dependency.

The reference loads `.embed` files with
`gensim.models.KeyedVectors.load_word2vec_format` (data_loader/dataset.py:132)
and uses `kv.distances(query, pool)` for the retrieval pre-filter
(data_loader/dataset.py:321-325) and the embedding baselines
(baselines/simple_parent.py, baselines/simple_structure.py).

We implement the same file format (header line "<count> <dim>", then
"<token> <v1> ... <vdim>" rows) and the same cosine-distance semantics in
plain numpy.

Port copy of `taxoexpan_tpu/data/embeddings.py` (numpy only).
"""
from __future__ import annotations

import numpy as np


def load_word2vec_format(path: str) -> tuple[list[str], np.ndarray]:
    """Parse a word2vec text-format file -> (tokens, vectors [N, D] float32)."""
    tokens: list[str] = []
    with open(path, "r", encoding="utf-8") as fin:
        header = fin.readline().strip().split()
        if len(header) != 2:
            raise ValueError(f"Bad word2vec header in {path!r}: {header}")
        count, dim = int(header[0]), int(header[1])
        vectors = np.empty((count, dim), dtype=np.float32)
        for i, line in enumerate(fin):
            line = line.rstrip("\n")
            if not line:
                continue
            if i >= count:
                raise ValueError(f"More rows than header count={count} in {path!r}")
            # Tokens may contain spaces in some exports; vectors are the last
            # `dim` whitespace-separated fields.
            parts = line.split(" ")
            tok = " ".join(parts[: len(parts) - dim])
            tokens.append(tok)
            vectors[i] = np.asarray(parts[len(parts) - dim:], dtype=np.float32)
    if len(tokens) != count:
        raise ValueError(f"Header said {count} rows, found {len(tokens)} in {path!r}")
    return tokens, vectors


def save_word2vec_format(path: str, tokens: list[str], vectors: np.ndarray) -> None:
    vectors = np.asarray(vectors)
    with open(path, "w", encoding="utf-8") as fout:
        fout.write(f"{len(tokens)} {vectors.shape[1]}\n")
        for tok, vec in zip(tokens, vectors):
            fout.write(tok + " " + " ".join(f"{v:.6g}" for v in vec) + "\n")


class KeyedVectors:
    """Minimal gensim-KeyedVectors stand-in with cosine `distances`.

    Matches gensim semantics: distance(a, b) = 1 - cos(a, b)
    (used by data_loader/dataset.py:323 and baselines/simple_parent.py:38).
    """

    def __init__(self, tokens: list[str], vectors: np.ndarray):
        self.index_to_key = list(tokens)
        self.key_to_index = {t: i for i, t in enumerate(tokens)}
        self.vectors = np.asarray(vectors, dtype=np.float32)
        norms = np.linalg.norm(self.vectors, axis=1, keepdims=True)
        self._unit = self.vectors / np.maximum(norms, 1e-12)

    @classmethod
    def load(cls, path: str) -> "KeyedVectors":
        return cls(*load_word2vec_format(path))

    def __contains__(self, key: str) -> bool:
        return key in self.key_to_index

    def __getitem__(self, key: str) -> np.ndarray:
        return self.vectors[self.key_to_index[key]]

    def distances(self, key_or_vec, other_keys) -> np.ndarray:
        """Cosine distances from one key/vector to a list of keys."""
        if isinstance(key_or_vec, str):
            q = self._unit[self.key_to_index[key_or_vec]]
        else:
            q = np.asarray(key_or_vec, dtype=np.float32)
            q = q / max(np.linalg.norm(q), 1e-12)
        idx = np.asarray([self.key_to_index[k] for k in other_keys], dtype=np.int64)
        return 1.0 - self._unit[idx] @ q
