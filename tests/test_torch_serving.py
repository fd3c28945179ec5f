"""The port reads what the JAX package writes: a checkpoint saved by the JAX
`save_checkpoint` with AMSGrad optimizer state loads without optax, and the
port's command-line entry points (`python -m taxoexpan_torch.test_fast`,
`python -m taxoexpan_torch.infer`) serve it on the CPU with the JAX
ranker's results."""
import json
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from taxoexpan_torch import infer as t_infer
from taxoexpan_torch import test_fast as t_test_fast
from taxoexpan_torch.data.synthetic import synthetic_taxonomy
from taxoexpan_torch.weights import (OpaqueState, _CheckpointUnpickler,
                                     load_jax_checkpoint)
from taxoexpan_tpu import builders as jbuilders
from taxoexpan_tpu.evaluation import TaxonomyRanker as JRanker
from taxoexpan_tpu.train.checkpoint import save_checkpoint

LOADER = {"expand_factor": 6, "normalize_embed": True, "sampling_mode": 0}
ARCH = {"type": "TaxoExpan", "args": {
    "propagation_method": "PGAT", "readout_method": "WMR",
    "matching_method": "BIM", "in_dim": 16, "hidden_dim": 8, "out_dim": 8,
    "pos_dim": 4, "num_layers": 1, "heads": [2, 1]}}
METRICS = ["macro_mr", "hit_at_1", "mrr_scaled_10"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A dataset pickle, a JAX checkpoint with AMSGrad state and its
    config.json, as the JAX train.py leaves them."""
    d = tmp_path_factory.mktemp("run")
    synthetic_taxonomy(num_nodes=80, dim=16, seed=2).save(
        str(d / "data.pickle.bin"))
    loader = dict(LOADER, data_path=str(d / "data.pickle.bin"))
    config = {"name": "tiny", "arch": ARCH, "loss": "info_nce_loss",
              "metrics": METRICS, "optimizer": {"type": "Adam", "args": {
                  "lr": 1e-3, "amsgrad": True}},
              "train_data_loader": {"args": loader},
              "validation_data_loader": {"args": loader},
              "test_data_loader": {"args": loader}}
    (d / "config.json").write_text(json.dumps(config))
    taxonomy = jbuilders.build_taxonomy(loader["data_path"])
    sampler = jbuilders.build_sampler(taxonomy, loader, "test")
    model = jbuilders.build_model(ARCH, max_parents=sampler.max_parents,
                                  expand_factor=sampler.expand_factor)
    params = jax.jit(model.init)(jax.random.PRNGKey(5))
    opt_state = optax.amsgrad(1e-3).init(params)
    save_checkpoint(d / "model_best.ckpt", params=params,
                    opt_state=opt_state, epoch=3, monitor_best=1.5,
                    config=config)
    return d, model, params, sampler, taxonomy


def test_checkpoint_reader_needs_no_optax(run_dir):
    d, _, params, _, _ = run_dir
    state = load_jax_checkpoint(d / "model_best.ckpt")
    assert state["epoch"] == 3
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat:
        node = state["params"]
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # the optimizer state comes back as neutral tuples, never optax's classes
    leaves = [x for x in state["opt_state"] if isinstance(x, tuple)]
    assert leaves and all(isinstance(x, OpaqueState) for x in leaves)
    with open(d / "model_best.ckpt", "rb") as fin:
        unpickler = _CheckpointUnpickler(fin)
        cls = unpickler.find_class("optax._src.transform",
                                   "ScaleByAmsgradState")
        assert cls is not optax.ScaleByAmsgradState
        assert issubclass(cls, OpaqueState)
        with pytest.raises(pickle.UnpicklingError):
            unpickler.find_class("os", "system")


def test_cli_test_fast_and_infer(run_dir, tmp_path):
    d, model, params, sampler, taxonomy = run_dir
    ckpt = str(d / "model_best.ckpt")
    got = t_test_fast.main(t_test_fast.parse_args(
        ["-r", ckpt, "-d", "cpu", "-c", str(tmp_path / "case.tsv")]))
    want, _ = JRanker(model, params, sampler, sampler.node_features
                      ).evaluate(METRICS, 1)
    assert got == pytest.approx(want, rel=1e-12)
    assert (tmp_path / "case.tsv").read_text().startswith("Test node index")

    novel = sampler.node_features[sampler.node_list[:3]] * 2.0 + 0.01
    with open(tmp_path / "novel.txt", "w") as fout:
        for i, row in enumerate(novel):
            fout.write(f"new term {i}\t{' '.join(map(str, row))}\n")
    preds = t_infer.main(t_infer.parse_args(
        ["-r", ckpt, "-t", str(tmp_path / "novel.txt"), "-d", "cpu",
         "-s", str(tmp_path / "out.tsv")]))
    anchors = sorted(set(taxonomy.train_node_ids) |
                     set(taxonomy.test_node_ids))
    unit = novel / np.linalg.norm(novel, axis=1, keepdims=True)
    want = JRanker(model, params, sampler, sampler.node_features,
                   anchors=anchors).predict_parents(unit, 1, topk=5)
    assert preds == want
    lines = (tmp_path / "out.tsv").read_text().splitlines()
    assert lines[1].startswith("new_term_0\t")
