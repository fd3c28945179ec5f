"""Port parity, the host data path: the port's native C++ sampler
(`taxoexpan_torch/native`) against the JAX package's
(`taxoexpan_tpu/native`), the loader's backends, the library's build
(failure raised, concurrent builds) and the split loader.

Both packages' samplers run from fresh handles seeded alike on the same
small synthetic taxonomy, each through its own library (two CDLLs in one
process, loaded from two paths). Comparisons are exact: the same C++
logic on the same inputs gives the same arrays, bit for bit."""
import threading

import numpy as np
import pytest

from taxoexpan_torch import native as tnative
from taxoexpan_torch.data.loader import GroupBatchLoader as TLoader
from taxoexpan_torch.data.sampler import MaskedGraphSampler as TSampler
from taxoexpan_torch.data.split_loader import SplitBatchLoader as TSplit
from taxoexpan_torch.data.synthetic import synthetic_taxonomy as t_synth
from taxoexpan_tpu import native as jnative
from taxoexpan_tpu.data.loader import GroupBatchLoader as JLoader
from taxoexpan_tpu.data.sampler import MaskedGraphSampler as JSampler
from taxoexpan_tpu.data.split_loader import SplitBatchLoader as JSplit
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy as j_synth

# expand_factor below the taxonomy's largest out-degree, so the siblings of
# over-full anchors are drawn (the RNG's stream); a short cache refresh
SAMPLER = dict(negative_size=5, expand_factor=6, cache_refresh_time=8,
               seed=0)
NATIVE_SEED = 1


@pytest.fixture(scope="module")
def taxonomies():
    jt = j_synth(num_nodes=400, dim=8, seed=2)
    tt = t_synth(num_nodes=400, dim=8, seed=2)
    np.testing.assert_array_equal(tt.edges, jt.edges)
    assert np.diff(tt.children.indptr).max() > SAMPLER["expand_factor"]
    return jt, tt


def _samplers(taxonomies, mode: str):
    jt, tt = taxonomies
    sm = 1 if mode == "train" else 0
    return (JSampler(jt, mode=mode, sampling_mode=sm, **SAMPLER),
            TSampler(tt, mode=mode, sampling_mode=sm, **SAMPLER))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("what", ["train", "eval", "anchors"])
def test_native_sampler_matches_jax(taxonomies, what):
    """3 consecutive train batches, 2 eval batches (validation queries,
    the true parents from the full taxonomy) or the anchor egonets, from
    fresh handles of both packages' libraries with the same seed."""
    js, ts = _samplers(taxonomies,
                       "train" if what != "eval" else "validation")
    jn = jnative.NativeSampler(js, seed=NATIVE_SEED)
    tn = tnative.NativeSampler(ts, seed=NATIVE_SEED)
    # two libraries, loaded from two paths, each called through its handle
    assert jn.lib is not tn.lib and jn.lib._name != tn.lib._name
    assert tn.lib._name == str(tnative.library_path())
    queries = np.asarray(ts.node_list, np.int32)
    if what == "anchors":
        anchors = np.asarray(sorted(ts.all_positions), np.int32)
        _assert_same(tn.build_anchor_egonets(anchors),
                     jn.build_anchor_egonets(anchors))
        return
    calls = 3 if what == "train" else 2
    for i in range(calls):
        q = queries[16 * i:16 * (i + 1)]
        if what == "train":
            got, want = tn.sample_train_batch(q), jn.sample_train_batch(q)
        else:
            got, want = tn.sample_eval_batch(q), jn.sample_eval_batch(q)
        _assert_same(got, want)
        assert got[4].any()                 # candidates were drawn


@pytest.mark.parametrize("mode", ["train", "validation"])
def test_native_loader_epoch_matches_jax(taxonomies, mode):
    """One epoch of GroupBatchLoader(backend="native") in both packages,
    batch for batch (the final partial batch padded), the port's through
    its prefetch thread."""
    js, ts = _samplers(taxonomies, mode)
    jl = JLoader(js, batch_size=16, seed=3, prefetch=0, backend="native")
    tl = TLoader(ts, batch_size=16, seed=3, backend="native")
    assert tl.backend == "native" and jl.native is not None
    n = 0
    for jb, tb in zip(jl, tl):
        for name in ("labels", "cand_mask", "query_ids"):
            np.testing.assert_array_equal(getattr(tb, name),
                                          getattr(jb, name))
        for name in ("node_ids", "ngp", "nsib"):
            np.testing.assert_array_equal(getattr(tb.ego, name),
                                          getattr(jb.ego, name))
        n += 1
    assert n == len(tl) == len(jl) > 1
    assert len(ts) % 16, "the epoch should end with a padded batch"


def test_loader_backends(taxonomies):
    """"auto" takes the native sampler where g++ builds it (here);
    "python" keeps the Python sampler; an unknown name raises."""
    _js, ts = _samplers(taxonomies, "train")
    auto = TLoader(ts, batch_size=8)
    assert auto.backend == "native" and auto.native is not None
    py = TLoader(ts, batch_size=8, backend="python")
    assert py.backend == "python" and py.native is None
    with pytest.raises(ValueError, match="backend"):
        TLoader(ts, batch_size=8, backend="c++")


def test_native_build_failure_raises(taxonomies, tmp_path, monkeypatch):
    """A build that fails raises under "native" with the compiler's
    message (a missing compiler; a source that does not compile), and
    "auto" then says it took the Python sampler."""
    _js, ts = _samplers(taxonomies, "train")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        TLoader(ts, batch_size=8, backend="native")
    assert TLoader(ts, batch_size=8).backend == "python"
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "CXX", "g++")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        TLoader(ts, batch_size=8, backend="native")
    assert not list((tmp_path / "build").glob("*.so*"))


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Builds started at once into an empty directory: one compiles under
    the lock, the others find its library; every caller gets the same
    complete file, and no temporary file is left."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(tnative.build())
        except Exception as e:         # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(paths)) == 1 and paths[0].exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        sorted([".lock", paths[0].name])


# ------------------------------------------------------------ split loader

@pytest.mark.parametrize("split", [0.25, 7])
def test_split_loader_matches_jax(split):
    """The split and both loaders' batches, epoch after epoch, for a
    float (fraction) and an int (count) validation split."""
    data = [f"item{i}" for i in range(30)]
    jl = JSplit(data, batch_size=4, validation_split=split, seed=5)
    tl = TSplit(data, batch_size=4, validation_split=split, seed=5)
    np.testing.assert_array_equal(tl.train_idx, jl.train_idx)
    np.testing.assert_array_equal(tl.valid_idx, jl.valid_idx)
    assert len(tl.valid_idx) == 7          # int(30 * 0.25) == 7
    jv, tv = jl.split_validation(), tl.split_validation()
    for _epoch in range(2):
        assert list(tl) == list(jl)
        assert list(tv) == list(jv)
    assert len(tl) == len(jl) and tl.n_samples == jl.n_samples


def test_split_loader_refuses_oversized_split():
    data = list(range(10))
    for split_loader in (JSplit, TSplit):
        with pytest.raises(ValueError, match="larger than"):
            split_loader(data, batch_size=4, validation_split=10)
    assert TSplit(data, batch_size=4).split_validation() is None
