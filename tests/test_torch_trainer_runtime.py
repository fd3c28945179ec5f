"""The port's training runtime around the epochs, the counterpart of the
JAX trainer's (`taxoexpan_tpu/train/trainer.py`): the profiler window
(`profile_dir`, batches `_profile_window` of epoch 1, one Chrome trace,
rank-suffixed under data parallelism), the background checkpoint writer
(the same arrays as a foreground save, the files in epoch order with
model_best, at most two writes in flight, `resume` waiting for a write),
the validation prefetch (the metrics and the loss of the inline path,
exactly; none on full-validation epochs) and the parameter histograms
(named as the JAX trainer names them for the same parameter tree).

A tiny PGAT (in 16, hidden 8, out 8, pos 4) on a 60-node synthetic
taxonomy, on the CPU, one torch thread. Comparisons are exact: the same
computation on the same inputs in one process."""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch.data.synthetic import synthetic_taxonomy
from taxoexpan_torch.parallel import distributed
from taxoexpan_torch.parallel.mesh import DataParallel, Layout
from taxoexpan_torch.training import checkpoint as tckpt
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer
from taxoexpan_torch.tree import tree_leaves
from taxoexpan_tpu import builders as jbuilders

ARCH = {"propagation_method": "PGAT", "readout_method": "WMR",
        "matching_method": "BIM", "in_dim": 16, "hidden_dim": 8,
        "out_dim": 8, "pos_dim": 4, "num_layers": 1, "heads": [2, 1],
        "feat_drop": 0.1, "attn_drop": 0.1}
TRAIN_CFG = {"sampling_mode": 1, "batch_size": 6, "negative_size": 3,
             "expand_factor": 4, "normalize_embed": True,
             "cache_refresh_time": 16}
VALID_CFG = dict(TRAIN_CFG, sampling_mode=0, negative_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def taxonomy():
    return synthetic_taxonomy(num_nodes=60, dim=16, seed=4)


def _trainer(taxonomy, save_dir, **kw) -> Trainer:
    """A fresh trainer of the tiny model: params from seed 0, loaders
    seeded alike, so that two such trainers run the same computation."""
    train_s = tbuilders.build_sampler(taxonomy, TRAIN_CFG, "train")
    valid_s = tbuilders.build_sampler(
        taxonomy, dict(VALID_CFG, max_parents=train_s.max_parents),
        "validation")
    model = tbuilders.build_model({"args": ARCH},
                                  max_parents=train_s.max_parents,
                                  expand_factor=train_s.expand_factor)
    params = model.init(torch.Generator().manual_seed(0))
    opt = toptim.Optimizer(lr=1e-2, amsgrad=True)
    return Trainer(model, params, opt, opt.init(params),
                   loss_name="info_nce_loss",
                   metric_names=["macro_mr", "hit_at_1", "mrr_scaled_10"],
                   feature_table=train_s.node_features,
                   train_loader=tbuilders.build_loader(train_s, TRAIN_CFG),
                   valid_loader=tbuilders.build_loader(valid_s, VALID_CFG),
                   config={"trainer": {"epochs": 2}}, save_dir=save_dir,
                   device="cpu", **kw)


def _trace_names(path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}


# ---------------------------------------------------------- profiler window

def test_profiler_window_writes_one_trace(taxonomy, tmp_path):
    """The window inside a short epoch: one Chrome trace of its steps under
    profile_dir, written when the window closes; no trace in epoch 2."""
    trainer = _trainer(taxonomy, tmp_path / "run",
                       profile_dir=tmp_path / "prof")
    assert trainer._profile_window == (10, 15)   # the JAX trainer's
    trainer._profile_window = (1, 2)
    assert len(trainer.train_loader) > 3
    trainer._train_epoch(1)
    traces = sorted(p.relative_to(tmp_path / "prof")
                    for p in (tmp_path / "prof").rglob("*") if p.is_file())
    assert [str(p) for p in traces] == ["trace.json"]
    assert "aten::mm" in _trace_names(tmp_path / "prof" / "trace.json")
    stamp = (tmp_path / "prof" / "trace.json").stat().st_mtime_ns
    trainer._train_epoch(2)
    assert (tmp_path / "prof" / "trace.json").stat().st_mtime_ns == stamp
    assert trainer._profiler is None


def test_profiler_trace_is_rank_suffixed_under_dp(taxonomy, tmp_path,
                                                  monkeypatch):
    """Under data parallelism rank r writes profile_dir/rank<r>/trace.json;
    a window longer than the epoch closes at the epoch's end."""
    monkeypatch.setattr(distributed, "all_reduce_sum",
                        lambda t, dp: t.clone())
    trainer = _trainer(taxonomy, tmp_path / "run",
                       profile_dir=tmp_path / "prof",
                       layout=Layout.data_parallel(
                           DataParallel(size=2, rank=1, backend="gloo")))
    trainer.valid_loader = None
    trainer._profile_window = (2, 10_000)
    trainer._train_epoch(1)
    files = [p for p in (tmp_path / "prof").rglob("*") if p.is_file()]
    assert files == [tmp_path / "prof" / "rank1" / "trace.json"]
    assert "aten::mm" in _trace_names(files[0])


# ---------------------------------------------------- background checkpoints

def _host(tree):
    return [x.detach().numpy().copy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in tree_leaves(tree)]


def _assert_same_arrays(path, params, opt_state):
    state = tckpt.load_checkpoint(path)
    for got, want in ((state["params"], params),
                      (state["opt_state"], opt_state)):
        got, want = tree_leaves(got), tree_leaves(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_background_checkpoints_match_foreground_in_order(taxonomy, tmp_path,
                                                          monkeypatch):
    """Each write lands the arrays the params and optimizer state held when
    it was asked for (clones: a later in-place change does not reach the
    file), the same arrays a foreground save writes; the files land in
    epoch order with model_best after its epoch's file; never more than
    two writes in flight; train's end joins them."""
    trainer = _trainer(taxonomy, tmp_path / "run")
    written, gate = [], threading.Event()
    save = tckpt.save_checkpoint

    def slow_save(path, **kw):     # the first write waits for the gate
        if not written:
            gate.wait(5)
        written.append(path.name)
        save(path, **kw)
    monkeypatch.setattr(tckpt, "save_checkpoint", slow_save)
    expect = {}
    for epoch, best in ((1, True), (2, False), (3, True)):
        trainer._train_epoch(epoch)
        expect[epoch] = (_host(trainer.params), _host(trainer.opt_state))
        trainer._save_checkpoint(epoch, save_best=best)
        assert len(trainer._ckpt_pending) <= 2
        if epoch == 1:    # in place, while its write waits for the gate
            tree_leaves(trainer.params)[0].data.add_(7.0)
        if epoch == 2:
            gate.set()
    trainer._join_ckpt()
    monkeypatch.setattr(tckpt, "save_checkpoint", save)
    assert written == ["checkpoint-epoch1.ckpt", "model_best.ckpt",
                       "checkpoint-epoch2.ckpt", "checkpoint-epoch3.ckpt",
                       "model_best.ckpt"]
    run = tmp_path / "run"
    for epoch in (1, 2, 3):
        _assert_same_arrays(run / f"checkpoint-epoch{epoch}.ckpt",
                            *expect[epoch])
    _assert_same_arrays(run / "model_best.ckpt", *expect[3])
    # a foreground save of the same state writes the same arrays
    sched = dict(epoch=3, monitor_best=trainer.mnt_best,
                 config=trainer.config)
    tckpt.save_checkpoint(tmp_path / "fg.ckpt", params=trainer.params,
                          opt_state=trainer.opt_state, **sched)
    fg, bg = (tckpt.load_checkpoint(p) for p in (
        tmp_path / "fg.ckpt", run / "checkpoint-epoch3.ckpt"))
    assert fg["epoch"] == bg["epoch"] == 3
    for key in ("params", "opt_state"):
        for a, b in zip(tree_leaves(fg[key]), tree_leaves(bg[key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not list(run.glob("*.tmp"))


def test_resume_waits_for_a_write_in_flight(taxonomy, tmp_path, monkeypatch):
    """`resume` joins the writes in flight first, so it reads the whole
    file of the epoch just saved."""
    trainer = _trainer(taxonomy, tmp_path / "run")
    save = tckpt.save_checkpoint

    def slow_save(path, **kw):
        time.sleep(0.3)
        save(path, **kw)
    monkeypatch.setattr(tckpt, "save_checkpoint", slow_save)
    trainer._train_epoch(1)
    want = _host(trainer.params)
    trainer._save_checkpoint(1)
    path = tmp_path / "run" / "checkpoint-epoch1.ckpt"
    assert not path.exists() and trainer._ckpt_pending
    trainer.resume(path)
    assert trainer.start_epoch == 2 and not trainer._ckpt_pending
    for a, b in zip(_host(trainer.params), want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ validation prefetch

def test_valid_prefetch_matches_inline(taxonomy, tmp_path, monkeypatch):
    """Two trainers from the same params and seeds, one epoch each: the
    prefetched sampled validation gives exactly the inline path's metrics
    (and the same loss); a full-validation epoch starts no prefetch."""
    logs = []
    for prefetch in (True, False):
        trainer = _trainer(taxonomy, tmp_path / f"run{prefetch}")
        started = []
        start = trainer._start_valid_prefetch
        monkeypatch.setattr(trainer, "_start_valid_prefetch", lambda: (
            started.append(1) or (start() if prefetch else None)))
        logs.append(trainer._train_epoch(1))
        assert started == [1] and trainer._valid_prefetch is None
    assert logs[0]["val_metrics"] == logs[1]["val_metrics"]
    assert logs[0]["loss"] == logs[1]["loss"]
    # inline, called on its own: the validation loader's next pass
    assert trainer._valid_epoch(2)["val_metrics"] != logs[1]["val_metrics"]

    trainer.full_validation_every = 1
    monkeypatch.setattr(trainer, "_full_valid",
                        lambda epoch: {"val_metrics": [1.0, 1.0, 1.0]})
    started.clear()
    log = trainer._train_epoch(2)
    assert started == [] and log["full_validation"]


# ------------------------------------------------------- param histograms

class _Recorder:
    """A tensorboard writer that records the histograms' names."""

    def __init__(self):
        self.writer = self
        self.histograms = []

    def set_step(self, step, mode="train"):
        pass

    def add_scalar(self, tag, value):
        pass

    def add_histogram(self, tag, values):
        assert isinstance(values, np.ndarray)
        self.histograms.append(tag)


def test_histogram_names_match_jax_key_paths(taxonomy, tmp_path):
    """After a sampled validation, one histogram a parameter leaf, named by
    its key path joined with "/", as the JAX trainer names the leaves of
    the JAX model's parameter tree (trainer.py:512-517); none without a
    tensorboard writer."""
    trainer = _trainer(taxonomy, tmp_path / "run")
    trainer._valid_epoch(1)        # no writer: no histograms, no error
    trainer.writer = _Recorder()
    trainer._valid_epoch(1)
    jm = jbuilders.build_model({"args": ARCH},
                               max_parents=trainer.model.max_parents,
                               expand_factor=trainer.model.expand_factor)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                template)[0]]
    assert trainer.writer.histograms == want
    assert len(want) == len(tree_leaves(trainer.params))
