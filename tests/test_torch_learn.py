"""End to end on the port's CPU path (the learn test of tests/test_e2e.py:
36-145, run through `taxoexpan_torch`): self-supervised training on a
synthetic taxonomy beats random ranking and its loss falls; checkpoints
round-trip and training resumes from one; the evaluation engine ranks
every candidate and `predict_parents` finds true parents.

The JAX test's setup: a 400-node synthetic taxonomy, PGAT / WMR / LBM at in
16, hidden and out 32, pos 8, heads [2, 1], AMSGrad at lr 5e-3 with grad
clip 5, ReduceLROnPlateau (factor 0.5, patience 3), 16 groups of 1 + 7
candidates a step, 12 epochs; its bars (validation macro_mr < 5 of about
8.5 at random, hit@1 > 0.15; test macro_mr below a quarter of the
candidates, mrr_scaled_10 > 0.2; a true parent in some top-5). One change:
dropout 0 where the JAX test has 0.1, since the plain versions regenerate
every dropout mask from ops/dropout.py's hash in int64 tensor operations,
which doubles this CPU run's time (the dropout paths are held elsewhere:
tests/test_torch_train_ops.py, test_torch_variants.py). One torch
thread; the port's Python sampler backend, as the JAX test's loader."""
import os

import numpy as np
import pytest
import torch

from taxoexpan_torch import builders
from taxoexpan_torch.data.synthetic import synthetic_taxonomy
from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
from taxoexpan_torch.training import checkpoint as ckpt_mod
from taxoexpan_torch.training.optim import PlateauScheduler
from taxoexpan_torch.training.trainer import Trainer
from taxoexpan_torch.tree import tree_leaves

ARCH = {
    "args": {
        "propagation_method": "PGAT", "readout_method": "WMR",
        "matching_method": "LBM", "in_dim": 16, "hidden_dim": 32,
        "out_dim": 32, "pos_dim": 8, "num_layers": 1, "heads": [2, 1],
        "feat_drop": 0.0, "attn_drop": 0.0, "hidden_drop": 0.0,
        "out_drop": 0.0,
    }
}
LOADER_CFG = {"batch_size": 16, "negative_size": 7, "expand_factor": 8,
              "cache_refresh_time": 16, "normalize_embed": True,
              "num_workers": 0, "sampling_mode": 1, "shuffle": True,
              "backend": "python"}
VAL_CFG = {**LOADER_CFG, "sampling_mode": 0, "negative_size": 16,
           "shuffle": False}
EPOCHS = 12


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _train(tmp_path_factory.mktemp("run"))
    finally:
        torch.set_num_threads(threads)


def _train(save_dir):
    taxo = synthetic_taxonomy(num_nodes=400, dim=16, seed=3)
    train_sampler = builders.build_sampler(taxo, LOADER_CFG, "train")
    train_loader = builders.build_loader(train_sampler, LOADER_CFG)
    val_cfg = {**VAL_CFG, "max_parents": train_sampler.max_parents}
    val_sampler = builders.build_sampler(taxo, val_cfg, "validation")
    val_loader = builders.build_loader(val_sampler, val_cfg)
    model = builders.build_model(ARCH,
                                 max_parents=train_sampler.max_parents,
                                 expand_factor=train_sampler.expand_factor)
    params = model.init(torch.Generator().manual_seed(0))
    optimizer = builders.build_optimizer_from_config(
        {"type": "Adam", "args": {"lr": 5e-3, "amsgrad": True}},
        {"grad_clip": 5.0})
    config = {"arch": ARCH, "optimizer": {"type": "Adam"},
              "trainer": {"epochs": EPOCHS, "save_period": 1,
                          "monitor": "min val_macro_mr", "early_stop": 20,
                          "tensorboardX": False}}
    trainer = Trainer(model, params, optimizer, optimizer.init(params),
                      loss_name="info_nce_loss",
                      metric_names=["macro_mr", "micro_mr", "hit_at_1",
                                    "hit_at_3", "mrr_scaled_10"],
                      feature_table=train_sampler.node_features,
                      train_loader=train_loader, valid_loader=val_loader,
                      config=config,
                      lr_scheduler=PlateauScheduler(mode="min", factor=0.5,
                                                    patience=3),
                      save_dir=save_dir, device="cpu")
    losses = []
    train_epoch = trainer._train_epoch

    def recorded(epoch):
        log = train_epoch(epoch)
        losses.append(log["loss"])
        return log
    trainer._train_epoch = recorded
    log = trainer.train()
    trainer._train_epoch = train_epoch
    return dict(taxo=taxo, trainer=trainer, model=model, log=log,
                losses=losses, save_dir=save_dir,
                train_sampler=train_sampler)


def test_training_beats_random(trained):
    # validation groups have <= 1 + 16 candidates -> random macro_mr ~ 8.5
    val_mr = trained["log"]["val_macro_mr"]
    assert val_mr < 5.0, f"val_macro_mr={val_mr} did not beat random (~8.5)"
    assert trained["log"]["val_hit_at_1"] > 0.15


def test_loss_decreased(trained):
    losses = trained["losses"]
    assert len(losses) == EPOCHS and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_checkpoint_roundtrip(trained):
    files = os.listdir(trained["save_dir"])
    assert "model_best.ckpt" in files
    assert any(f.startswith("checkpoint-epoch") for f in files)
    state = ckpt_mod.load_checkpoint(trained["save_dir"] / "model_best.ckpt")
    assert state["epoch"] >= 1
    t = trained["trainer"]
    params, opt_state = ckpt_mod.restore_into(
        state, model=t.model, optimizer=t.optimizer, config=t.config,
        device=torch.device("cpu"))
    live, rest = tree_leaves(t.params), tree_leaves(params)
    assert len(live) == len(rest)
    assert all(a.shape == b.shape for a, b in zip(live, rest))
    assert opt_state["count"] > 0


def test_resume_continues(trained):
    t = trained["trainer"]
    ckpts = sorted(f for f in os.listdir(trained["save_dir"])
                   if f.startswith("checkpoint-epoch"))
    t.resume(trained["save_dir"] / ckpts[-1])
    assert t.start_epoch >= 2


def _test_ranker(trained):
    test_cfg = {**VAL_CFG, "max_parents": trained["train_sampler"].max_parents}
    sampler = builders.build_sampler(trained["taxo"], test_cfg, "test")
    return sampler, TaxonomyRanker(trained["model"], trained["trainer"].params,
                                   sampler, sampler.node_features,
                                   encode_chunk=128, query_chunk=32,
                                   device="cpu")


def test_eval_engine(trained):
    sampler, ranker = _test_ranker(trained)
    result, cases = ranker.evaluate(
        ["macro_mr", "hit_at_1", "mrr_scaled_10"], rank_mode=1,
        case_study=True)
    n_cand = len(sampler.candidate_positions)
    # random macro_mr ~ n_cand / 2; trained must be far better
    assert result["macro_mr"] < n_cand / 4, (result, n_cand)
    assert result["mrr_scaled_10"] > 0.2
    assert len(cases) == len(sampler.node_list) + 1   # header + per query
    assert cases[0][0] == "Test node index"


def test_infer_predictions(trained):
    sampler, ranker = _test_ranker(trained)
    # "novel" terms = features of real test nodes -> top-5 should often
    # contain the true parent
    queries = sampler.node_list[:20]
    qf = sampler.node_features[np.asarray(queries)]
    preds = ranker.predict_parents(qf, rank_mode=1, topk=5)
    hits = sum(any(p in sampler.node2parents[q] for p in topk)
               for q, topk in zip(queries, preds))
    assert hits >= 1, "top-5 predictions never contained a true parent"
