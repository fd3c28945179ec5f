"""Taxonomy store: CSR arrays over dense node ids, replacing networkx + DGLGraph.

Re-implements the data model of the reference's `MAGDataset`
(data_loader/dataset.py:40-203): parse `.terms` / `.taxo` / `.embed` text files,
remap tx_ids to dense node ids, build the parent->child edge list with node
features, and partition leaves into validation/test with `random.seed(47)`
(data_loader/dataset.py:167-179). We keep exactly the same partition semantics
(including the seed and the terms-file node ordering) so partitions are
reproducible against the reference, but the graph is stored as flat numpy CSR
arrays — the layout every downstream TPU-side component consumes.

Port copy of `taxoexpan_tpu/data/taxonomy.py` (numpy only): the port keeps
its own copy because importing anything under `taxoexpan_tpu.data` imports
JAX. It reads and writes the same dataset pickle format.
"""
from __future__ import annotations

import os
import pickle
import random
from dataclasses import dataclass, field

import numpy as np

from .embeddings import load_word2vec_format

PICKLE_FORMAT = "taxoexpan_tpu.v1"


@dataclass
class Taxon:
    """Node record; reference: data_loader/dataset.py:18-37."""
    tx_id: str
    rank: int = -1
    norm_name: str = "none"
    display_name: str = "None"
    main_type: str = ""
    level: int = -100
    p_count: int = 0
    c_count: int = 0
    create_date: str = "None"

    def __str__(self) -> str:
        return f"Taxon {self.tx_id} (name: {self.norm_name}, level: {self.level})"

    def __lt__(self, other: "Taxon") -> bool:
        if self.level < other.level:
            return True
        return self.rank < other.rank


class _CSR:
    """Adjacency in CSR form: neighbors of node i are `indices[indptr[i]:indptr[i+1]]`."""

    __slots__ = ("indptr", "indices")

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.indptr = indptr
        self.indices = indices

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    def degree(self, i: int) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def build_csr(num_nodes: int, src: np.ndarray, dst: np.ndarray) -> _CSR:
    """Group `dst` by `src` into CSR. Stable (preserves edge order per source)."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(src, kind="stable")
    return _CSR(indptr, dst[order].copy())


@dataclass
class Taxonomy:
    """A taxonomy DAG with dense node ids, features, and train/val/test splits.

    Fields mirror the reference's pickled payload
    (data_loader/dataset.py:185-192): name, graph, vocab, and the three node-id
    partitions — but the graph is `edges [E, 2] (parent, child)` plus features
    `[V, D]`, instead of a DGLGraph.
    """
    name: str
    vocab: list[str]                     # "norm_name@@@node_id" per node
    features: np.ndarray                 # [V, D] float32
    edges: np.ndarray                    # [E, 2] int32, parent -> child
    train_node_ids: list[int]
    validation_node_ids: list[int]
    test_node_ids: list[int]
    _children: _CSR | None = field(default=None, repr=False)
    _parents: _CSR | None = field(default=None, repr=False)

    # ------------------------------------------------------------------ basic
    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def children(self) -> _CSR:
        if self._children is None:
            self._children = build_csr(self.num_nodes, self.edges[:, 0], self.edges[:, 1])
        return self._children

    @property
    def parents(self) -> _CSR:
        if self._parents is None:
            self._parents = build_csr(self.num_nodes, self.edges[:, 1], self.edges[:, 0])
        return self._parents

    def term_names(self) -> list[str]:
        return [v.split("@@@")[0] for v in self.vocab]

    # ------------------------------------------------------------------- IO
    def save(self, path: str) -> None:
        data = {
            "format": PICKLE_FORMAT,
            "name": self.name,
            "vocab": self.vocab,
            "features": np.asarray(self.features, dtype=np.float32),
            "edges": np.asarray(self.edges, dtype=np.int32),
            "train_node_ids": list(map(int, self.train_node_ids)),
            "validation_node_ids": list(map(int, self.validation_node_ids)),
            "test_node_ids": list(map(int, self.test_node_ids)),
        }
        with open(path, "wb") as fout:
            pickle.dump(data, fout, pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path: str) -> "Taxonomy":
        with open(path, "rb") as fin:
            data = pickle.load(fin)
        if data.get("format") != PICKLE_FORMAT:
            raise ValueError(
                f"{path!r} is not a taxoexpan_tpu dataset pickle (format="
                f"{data.get('format')!r}); re-generate with generate_dataset_binary.py")
        return cls(
            name=data["name"], vocab=data["vocab"], features=data["features"],
            edges=data["edges"], train_node_ids=data["train_node_ids"],
            validation_node_ids=data["validation_node_ids"],
            test_node_ids=data["test_node_ids"])

    # ------------------------------------------------------------------ raw
    @classmethod
    def from_raw_dir(cls, name: str, dir_path: str, embed_suffix: str = "",
                     existing_partition: bool = False,
                     save_pickle: bool = True) -> "Taxonomy":
        """Build from `.terms` / `.taxo` / `.embed` files.

        Mirrors data_loader/dataset.py:82-194: node ids are assigned in
        `.terms` file order; `.taxo` rows are `parent_tx_id \t child_tx_id`;
        the embedding file keys rows by tx_id; partitions are either read from
        `.terms.{train,validation,test}` files or sampled as 10%/10% of leaves
        with random.seed(47).
        """
        node_file = os.path.join(dir_path, f"{name}.terms")
        edge_file = os.path.join(dir_path, f"{name}.taxo")
        if embed_suffix == "":
            embed_file = os.path.join(dir_path, f"{name}.terms.embed")
            out_pickle = os.path.join(dir_path, f"{name}.pickle.bin")
        else:
            embed_file = os.path.join(dir_path, f"{name}.terms.{embed_suffix}.embed")
            out_pickle = os.path.join(dir_path, f"{name}.{embed_suffix}.pickle.bin")

        tx_ids: list[str] = []
        names: list[str] = []
        with open(node_file, "r", encoding="utf-8") as fin:
            for line in fin:
                line = line.strip()
                if not line:
                    continue
                segs = line.split("\t")
                if len(segs) != 2:
                    raise ValueError(f"Wrong number of segmentations: {line!r}")
                tx_ids.append(segs[0])
                names.append(segs[1])
        tx_id2node_id = {tx: i for i, tx in enumerate(tx_ids)}
        vocab = [f"{names[i]}@@@{i}" for i in range(len(tx_ids))]

        edge_list: list[tuple[int, int]] = []
        with open(edge_file, "r", encoding="utf-8") as fin:
            for line in fin:
                line = line.strip()
                if not line:
                    continue
                segs = line.split("\t")
                if len(segs) != 2:
                    raise ValueError(f"Wrong number of segmentations: {line!r}")
                edge_list.append((tx_id2node_id[segs[0]], tx_id2node_id[segs[1]]))
        edges = np.asarray(edge_list, dtype=np.int32).reshape(-1, 2)

        tokens, vectors = load_word2vec_format(embed_file)
        tok2row = {t: i for i, t in enumerate(tokens)}
        features = np.zeros((len(tx_ids), vectors.shape[1]), dtype=np.float32)
        for node_id, tx in enumerate(tx_ids):
            features[node_id] = vectors[tok2row[tx]]

        if existing_partition:
            def _load_ids(suffix: str) -> list[int]:
                out = []
                with open(os.path.join(dir_path, f"{name}.terms.{suffix}")) as fin:
                    for line in fin:
                        line = line.strip()
                        if line:
                            out.append(tx_id2node_id[line])
                return out
            train_ids = _load_ids("train")
            val_ids = _load_ids("validation")
            test_ids = _load_ids("test")
        else:
            # 10% / 10% of leaves for val/test, seed 47 — dataset.py:167-179.
            out_deg = np.bincount(edges[:, 0], minlength=len(tx_ids)) if len(edge_list) \
                else np.zeros(len(tx_ids), dtype=np.int64)
            leaf_node_ids = [i for i in range(len(tx_ids)) if out_deg[i] == 0]
            rng = random.Random()
            rng.seed(47)
            rng.shuffle(leaf_node_ids)
            validation_size = int(len(leaf_node_ids) * 0.1)
            test_size = int(len(leaf_node_ids) * 0.1)
            val_ids = leaf_node_ids[:validation_size]
            test_ids = leaf_node_ids[validation_size:validation_size + test_size]
            held = set(val_ids) | set(test_ids)
            train_ids = [i for i in range(len(tx_ids)) if i not in held]

        taxo = cls(name=name, vocab=vocab, features=features, edges=edges,
                   train_node_ids=train_ids, validation_node_ids=val_ids,
                   test_node_ids=test_ids)
        if save_pickle:
            taxo.save(out_pickle)
        return taxo
