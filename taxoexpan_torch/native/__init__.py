"""The native C++ ego-batch sampler: its build and ctypes binding (the
port's copy of `taxoexpan_tpu/native`, over the port's own `sampler.cpp`).

The library is built with g++ at first use into `native/_build/` (listed
in .gitignore) and named by a hash of its source and flags, so an edited
source rebuilds and an unchanged one loads the existing file. Processes
that build at once (test workers, ranks) take a file lock, and each writes
a file of its own that it then moves into place, so no process ever loads
a half-written library. A failed build raises with the compiler's output;
the loader's "auto" backend turns that into the Python sampler and says
so (`GroupBatchLoader.backend`). Nothing here builds at import time.

The library is loaded with `ctypes.CDLL`, which releases the GIL for the
length of every call: the loader's producer thread builds a whole batch
in C++ while the main thread queues the card's kernels.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtesampler-{digest}.so"


def build() -> Path:
    """Build the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():             # built by another process meanwhile
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native sampler build failed "
                               f"({' '.join(cmd)}): {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native sampler build failed (exit "
                               f"{proc.returncode}, {' '.join(cmd)}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises if it cannot
    be)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.te_sampler_create.restype = ctypes.c_void_p
    lib.te_sampler_create.argtypes = [
        i64p, i32p, i64p, i32p, i64, i32p, i64, i32, ctypes.c_uint64]
    lib.te_sampler_set_masks.restype = None
    lib.te_sampler_set_masks.argtypes = [ctypes.c_void_p, i32p, i64, i64p,
                                         i32p]
    lib.te_sampler_destroy.restype = None
    lib.te_sampler_destroy.argtypes = [ctypes.c_void_p]
    lib.te_sample_train_batch.restype = i32
    lib.te_sample_train_batch.argtypes = [
        ctypes.c_void_p, i32p, i32, i32, i32, i32, i32p, i32p, i32p, f32p,
        u8p]
    lib.te_sample_eval_batch.restype = i32
    lib.te_sample_eval_batch.argtypes = [
        ctypes.c_void_p, i32p, i32, i32p, i32p, i32, i32, i32, i32, i32p,
        i32p, i32p, f32p, u8p]
    lib.te_build_anchor_egonets.restype = i32
    lib.te_build_anchor_egonets.argtypes = [
        ctypes.c_void_p, i32p, i32, i32, i32, i32p, i32p, i32p]
    _lib = lib
    return lib


class NativeSampler:
    """The training and sampled-validation hot path of a
    `MaskedGraphSampler` in C++: its working-graph CSR, masks and
    parameters, with an RNG of its own seeded by `seed`."""

    def __init__(self, py_sampler, seed: int = 0):
        lib = get_lib()
        self.lib = lib
        self.py = s = py_sampler
        # the CSR and mask arrays live as long as the handle: the C++
        # side keeps pointers into them
        self._child_indptr = np.ascontiguousarray(s.children.indptr,
                                                  np.int64)
        self._child_idx = np.ascontiguousarray(s.children.indices, np.int32)
        self._par_indptr = np.ascontiguousarray(s.parents.indptr, np.int64)
        self._par_idx = np.ascontiguousarray(s.parents.indices, np.int32)
        train_ids = np.ascontiguousarray(sorted(s.all_positions), np.int32)
        self.handle = lib.te_sampler_create(
            self._child_indptr, self._child_idx, self._par_indptr,
            self._par_idx, np.int64(s.taxonomy.num_nodes), train_ids,
            np.int64(len(train_ids)), np.int32(s.cache_refresh_time),
            np.uint64(seed))
        qids = np.ascontiguousarray(s.node_list, np.int32)
        indptr = np.zeros(len(qids) + 1, np.int64)
        rows = []
        for i, q in enumerate(s.node_list):
            m = np.asarray(sorted(s.node2masks[q]), np.int32)
            rows.append(m)
            indptr[i + 1] = indptr[i] + len(m)
        indices = np.ascontiguousarray(
            np.concatenate(rows) if rows else np.zeros(0, np.int32))
        lib.te_sampler_set_masks(self.handle, qids, np.int64(len(qids)),
                                 indptr, indices)
        self._masks_keepalive = (qids, indptr, indices)

    def _outputs(self, rows: int):
        n = self.py.max_parents + 1 + self.py.expand_factor
        return (np.zeros((rows, n), np.int32), np.zeros((rows,), np.int32),
                np.zeros((rows,), np.int32), np.zeros((rows,), np.float32),
                np.zeros((rows,), np.uint8))

    def sample_train_batch(self, query_ids: np.ndarray):
        """A full [G, 1 + negative_size] train group batch: (node_ids
        [G*C, N], ngp [G*C], nsib [G*C], labels [G, C], cand_mask [G, C]),
        the positive in column 0."""
        s = self.py
        g = len(query_ids)
        c = 1 + s.negative_size
        node_ids, ngp, nsib, labels, mask = self._outputs(g * c)
        rc = self.lib.te_sample_train_batch(
            self.handle, np.ascontiguousarray(query_ids, np.int32),
            np.int32(g), np.int32(s.negative_size),
            np.int32(s.expand_factor), np.int32(s.max_parents),
            node_ids, ngp, nsib, labels, mask)
        if rc != 0:
            raise RuntimeError(f"native sampler failed with code {rc}")
        return (node_ids, ngp, nsib, labels.reshape(g, c),
                mask.reshape(g, c).astype(bool))

    def sample_eval_batch(self, query_ids: np.ndarray):
        """A full validation [G, max_query_parents + negative_size] group
        batch (sampling_mode 0: one positive per parent in the leading
        columns, at most negative_size negatives after them); the return
        of sample_train_batch."""
        s = self.py
        g = len(query_ids)
        max_pos = s.max_query_parents
        c = max_pos + s.negative_size
        node_ids, ngp, nsib, labels, mask = self._outputs(g * c)
        # the true parents from the full taxonomy (node2parents): the
        # validation queries' in-edges are not in the working graph's CSR
        parent_list = np.zeros((g, max_pos), np.int32)
        parent_counts = np.zeros((g,), np.int32)
        for i, q in enumerate(np.asarray(query_ids)):
            ps = s.node2parents[int(q)]
            parent_counts[i] = len(ps)
            parent_list[i, :len(ps)] = ps
        rc = self.lib.te_sample_eval_batch(
            self.handle, np.ascontiguousarray(query_ids, np.int32),
            np.int32(g), parent_list, parent_counts,
            np.int32(s.negative_size), np.int32(max_pos),
            np.int32(s.expand_factor), np.int32(s.max_parents), node_ids,
            ngp, nsib, labels, mask)
        if rc != 0:
            raise RuntimeError(f"native eval sampler failed with code {rc}")
        return (node_ids, ngp, nsib, labels.reshape(g, c),
                mask.reshape(g, c).astype(bool))

    def build_anchor_egonets(self, anchors: np.ndarray):
        """Query-independent egonets of `anchors`: (node_ids [K, N], ngp,
        nsib)."""
        s = self.py
        k = len(anchors)
        node_ids, ngp, nsib, _labels, _mask = self._outputs(k)
        rc = self.lib.te_build_anchor_egonets(
            self.handle, np.ascontiguousarray(anchors, np.int32),
            np.int32(k), np.int32(s.expand_factor),
            np.int32(s.max_parents), node_ids, ngp, nsib)
        if rc != 0:
            raise RuntimeError(f"native egonet build failed with code {rc}")
        return node_ids, ngp, nsib

    def __del__(self):
        handle, self.handle = getattr(self, "handle", None), None
        if handle:
            self.lib.te_sampler_destroy(handle)
