"""Port parity, the training path: losses, optimizers (optax's rules, AMSGrad
on the bias-corrected moment), the plateau scheduler, the loader, two train
steps of the model, the carry-over of a JAX optimizer state, and
`python -m taxoexpan_torch.train -d cpu` end to end, each against the JAX
package on the same numpy inputs.

Tolerances: losses and their grads 1e-5 (float32, one reduction);
optimizer steps 1e-6 (elementwise float32 updates, sums only in the clip
norm); two model train steps 1e-4 (float32 through two GAT layers and a
matcher, twice) wherever the step's grad is above 1e-6 — below that,
AMSGrad's g / (|g| + 1e-8) turns float32 rounding of a near-zero grad into
a step anywhere in [-lr, lr], so there the params agree to 2 * lr per
step; loader batches and ranks exact."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch import losses as tlosses
from taxoexpan_torch import test_fast as t_test_fast
from taxoexpan_torch import train as t_train
from taxoexpan_torch.data.synthetic import synthetic_taxonomy as t_synth
from taxoexpan_torch.training import checkpoint as tckpt
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer, batch_to
from taxoexpan_torch.tree import tree_leaves
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import builders as jbuilders
from taxoexpan_tpu import losses as jlosses
from taxoexpan_tpu.data.egobatch import EgoBatch as JEgo
from taxoexpan_tpu.data.egobatch import GroupBatch as JGroup
from taxoexpan_tpu.data.loader import GroupBatchLoader as JLoader
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy as j_synth
from taxoexpan_tpu.train import checkpoint as jckpt
from taxoexpan_tpu.train import optim as joptim

ARCH = {"propagation_method": "PGAT", "readout_method": "WMR",
        "matching_method": "BIM", "in_dim": 16, "hidden_dim": 8,
        "out_dim": 8, "pos_dim": 4, "num_layers": 1, "heads": [2, 1]}
TRAIN_CFG = {"sampling_mode": 1, "batch_size": 6, "negative_size": 5,
             "expand_factor": 6, "normalize_embed": True,
             "cache_refresh_time": 16}


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
def taxonomies():
    jt = j_synth(num_nodes=150, dim=16, seed=3)
    tt = t_synth(num_nodes=150, dim=16, seed=3)
    np.testing.assert_array_equal(tt.features, jt.features)
    return jt, tt


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_losses_and_grads(rng, name):
    g, c = 5, 7
    scores = rng.normal(size=(g, c)).astype(np.float32)
    labels = np.zeros((g, c), np.float32)
    labels[:, 0] = 1.0
    labels[1, 1] = 1.0
    mask = np.ones((g, c), bool)
    mask[2, 4:] = False
    mask[4] = False                            # an empty padding group
    want, want_g = jax.jit(jax.value_and_grad(jlosses.get_loss(name)))(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask))
    s = torch.from_numpy(scores).requires_grad_(True)
    got = tlosses.get_loss(name)(s, torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, s)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------------- optimizers

@pytest.mark.parametrize("kw", [
    dict(opt_type="Adam"),
    dict(opt_type="Adam", amsgrad=True),
    dict(opt_type="Adam", amsgrad=True, grad_clip=0.5, weight_decay=0.01),
    dict(opt_type="AdamW", weight_decay=0.05),
    dict(opt_type="SGD", weight_decay=0.01, grad_clip=1.0),
], ids=["adam", "amsgrad", "amsgrad_clip_l2", "adamw", "sgd_clip_l2"])
def test_optimizer_matches_optax(rng, kw):
    """Five steps on a small tree, grads of changing scale (so AMSGrad's
    max over the bias-corrected moment matters), the LR set at step 3."""
    shapes = {"a": {"w": (3, 4)}, "b": [(5,), (2, 2)]}
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    jopt = joptim.build_optimizer(lr=1e-2, **kw)
    topt = toptim.Optimizer(lr=1e-2, **kw)
    jstate = jopt.init(params)
    jp = params
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    tstate = topt.init(tp)
    jstep = jax.jit(lambda g, s, p: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*jopt.update(g, s, p)))
    for step in range(5):
        scale = [1.0, 0.01, 3.0, 0.2, 0.5][step]
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
            params)
        if step == 3:
            jstate = joptim.set_lr(jstate, 3e-3)
            tstate = toptim.set_lr(tstate, 3e-3)
        jp, jstate = jstep(grads, jstate, jp)
        tp, tstate = topt.update(
            jax.tree_util.tree_map(torch.from_numpy, grads), tstate, tp)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert toptim.get_lr(tstate) == joptim.get_lr(jstate)


def test_amsgrad_update_bits_pinned():
    """Three AMSGrad steps equal, bit for bit, the update written with the
    bias corrections made on the host and copied to the params' device
    (1 - tensor(B, float32) ** count); the device-made corrections of
    `optim.bias_corrections` hold the same float32 values."""
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((6, 3), generator=gen),
              "b": torch.randn((7,), generator=gen)}
    opt = toptim.Optimizer(lr=1e-2, amsgrad=True)
    state = opt.init(params)
    mu = nu = nu_max = {k: torch.zeros_like(v) for k, v in params.items()}
    want = params
    for count, scale in enumerate((1.0, 0.01, 3.0), start=1):
        grads = {k: torch.randn(v.shape, generator=gen) * scale
                 for k, v in params.items()}
        params, state = opt.update(grads, state, params)
        bc1 = 1 - torch.tensor(toptim.B1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(toptim.B2, dtype=torch.float32) ** count
        assert [t.item() for t in toptim.bias_corrections(count, "cpu")] \
            == [bc1.item(), bc2.item()]
        mu = {k: (1 - toptim.B1) * grads[k] + toptim.B1 * mu[k] for k in mu}
        nu = {k: (1 - toptim.B2) * (grads[k] * grads[k]) + toptim.B2 * nu[k]
              for k in nu}
        nu_max = {k: torch.maximum(nu_max[k], nu[k] / bc2) for k in nu}
        neg_lr = -float(np.float32(1e-2))
        want = {k: want[k] + ((mu[k] / bc1) / (torch.sqrt(nu_max[k])
                                               + toptim.EPS)) * neg_lr
                for k in want}
        for k in want:
            assert torch.equal(params[k], want[k]), (count, k)
            assert torch.equal(state["nu_max"][k], nu_max[k])


def test_plateau_scheduler_matches_jax():
    jsched = joptim.PlateauScheduler(mode="min", factor=0.5, patience=1)
    tsched = toptim.PlateauScheduler(mode="min", factor=0.5, patience=1)
    jstate = joptim.build_optimizer(lr=1e-3).init({"w": jnp.zeros(2)})
    tstate = toptim.Optimizer(lr=1e-3).init({"w": torch.zeros(2)})
    for v in [5.0, 4.0, 4.0, 4.1, 3.0, 3.0, 3.0, 3.0, 2.9997]:
        jstate, jr = jsched.step(v, jstate)
        tstate, tr = tsched.step(v, tstate)
        assert jr == tr
        assert toptim.get_lr(tstate) == joptim.get_lr(jstate)
        assert tsched.state_dict() == jsched.state_dict()


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("mode,cfg", [
    ("train", TRAIN_CFG),
    ("validation", dict(TRAIN_CFG, sampling_mode=0, negative_size=9)),
])
def test_loader_batches_equal_jax(taxonomies, mode, cfg):
    jt, tt = taxonomies
    js = jbuilders.build_sampler(jt, cfg, mode)
    ts = tbuilders.build_sampler(tt, cfg, mode)
    jl = JLoader(js, batch_size=cfg["batch_size"], seed=2, backend="python")
    tl = tbuilders.build_loader(ts, dict(cfg, backend="python"), seed=2)
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


# ---------------------------------------------------- model train steps

@pytest.fixture(scope="module")
def models_and_batch(taxonomies):
    """Both models (dropout 0), the JAX init carried over to the port, one
    train batch: built once for the tests below."""
    jt, tt = taxonomies
    ts = tbuilders.build_sampler(tt, TRAIN_CFG, "train")
    arch = {"args": dict(ARCH, feat_drop=0.0, attn_drop=0.0)}
    jm = jbuilders.build_model(dict(arch, args=dict(arch["args"],
                                                    kernel="xla")),
                               max_parents=ts.max_parents,
                               expand_factor=ts.expand_factor)
    tm = tbuilders.build_model(arch, max_parents=ts.max_parents,
                               expand_factor=ts.expand_factor)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(11))
    tp = params_from_jax(_np_tree(jp), tm.init(torch.Generator()))
    batch = next(iter(tbuilders.build_loader(ts, TRAIN_CFG, seed=1)))
    return jm, jp, tm, tp, batch, ts.node_features


def test_two_train_steps_match_jax(models_and_batch, tmp_path):
    """Two AMSGrad steps of the whole model (dropout 0) through the port's
    Trainer.train_step against the JAX step (kernel="xla"), from the same
    carried-over params."""
    jm, jp, tm, tp, batch, table = models_and_batch
    jopt = joptim.build_optimizer(lr=1e-2, amsgrad=True)
    jbatch = JGroup(ego=JEgo(*(jnp.asarray(a) for a in (
        batch.ego.node_ids, batch.ego.ngp, batch.ego.nsib))),
        query_ids=jnp.asarray(batch.query_ids), query_feats=None,
        labels=jnp.asarray(batch.labels),
        cand_mask=jnp.asarray(batch.cand_mask))

    @jax.jit
    def jax_step(params, state):
        def loss_fn(p):
            scores = jm.forward(p, jbatch, jnp.asarray(table),
                                rng=jax.random.PRNGKey(0), train=True)
            return jlosses.info_nce_loss(scores, jbatch.labels,
                                         jbatch.cand_mask)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss, grads

    topt = toptim.Optimizer(lr=1e-2, amsgrad=True)
    trainer = Trainer(tm, tp, topt, topt.init(tp), loss_name="info_nce_loss",
                      metric_names=["macro_mr"], feature_table=table,
                      train_loader=None, save_dir=tmp_path, device="cpu")
    dev_batch = batch_to(batch, torch.device("cpu"))
    jstate = jopt.init(jp)
    tiny = [np.zeros(x.shape, bool) for x in jax.tree_util.tree_leaves(jp)]
    for step in range(2):
        jp, jstate, jloss, jgrads = jax_step(jp, jstate)
        tloss = trainer.train_step(dev_batch, step)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
        for i, (a, b, g) in enumerate(zip(
                tree_leaves(trainer.params), jax.tree_util.tree_leaves(jp),
                jax.tree_util.tree_leaves(jgrads))):
            tiny[i] |= np.abs(np.asarray(g)) < 1e-6
            diff = np.abs(a.numpy() - np.asarray(b))
            assert (diff[~tiny[i]] <= 1e-4 + 1e-4 * np.abs(
                np.asarray(b))[~tiny[i]]).all()
            assert (diff[tiny[i]] <= 2 * 1e-2 * (step + 1)).all()
        assert sum(t.sum() for t in tiny) < 0.05 * sum(t.size for t in tiny)


def test_opt_state_from_jax_resumes_amsgrad(models_and_batch, tmp_path):
    """A JAX checkpoint after two AMSGrad steps resumes in the port: step 3
    equals JAX's step 3."""
    jm, jp, tm, tp, _batch, _table = models_and_batch
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * s).astype(np.float32), jp)
        for s in (1.0, 0.05, 0.7)]
    jopt = joptim.build_optimizer(lr=1e-3, amsgrad=True)
    jstep = jax.jit(lambda g, s, p: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*jopt.update(g, s, p)))
    jstate = jopt.init(jp)
    for g in grads[:2]:
        jp, jstate = jstep(g, jstate, jp)
    config = {"arch": {"args": ARCH}, "optimizer": {"type": "Adam"}}
    jckpt.save_checkpoint(tmp_path / "jax.ckpt", params=jp,
                          opt_state=jstate, epoch=2, monitor_best=1.0,
                          config=config)
    topt = toptim.Optimizer(lr=1e-3, amsgrad=True)
    params, state = tckpt.restore_into(
        tckpt.load_checkpoint(tmp_path / "jax.ckpt"), model=tm,
        optimizer=topt, config=config, device=torch.device("cpu"))
    assert state["count"] == 2 and state["lr"] == joptim.get_lr(jstate)
    jp, jstate = jstep(grads[2], jstate, jp)
    params, state = topt.update(
        params_from_jax(_np_tree(grads[2]), params), state, params)
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------ the CLI end to end

def test_cli_train_resume_and_serve(taxonomies, tmp_path):
    """`python -m taxoexpan_torch.train -d cpu` (its main, in this process)
    trains 2 epochs with dropout on (sampled validation, then full-catalog
    validation), resumes from the epoch-1 checkpoint, and writes
    checkpoints that the JAX package's restore_params reads and the port's
    test_fast serves."""
    _jt, tt = taxonomies
    tt.save(str(tmp_path / "data.pickle.bin"))
    loader = dict(TRAIN_CFG, data_path=str(tmp_path / "data.pickle.bin"),
                  num_workers=2)
    config = {
        "name": "tiny", "seed": 0,
        "arch": {"type": "TaxoExpan", "args": ARCH},
        "train_data_loader": {"args": loader},
        "validation_data_loader": {"args": dict(loader, sampling_mode=0,
                                                negative_size=12)},
        "test_data_loader": {"args": dict(loader, sampling_mode=0)},
        "optimizer": {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}},
        "loss": "info_nce_loss",
        "metrics": ["macro_mr", "hit_at_1", "mrr_scaled_10"],
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "factor": 0.5,
                                  "patience": 3}},
        "trainer": {"epochs": 2, "save_dir": str(tmp_path / "saved"),
                    "save_period": 1, "monitor": "min val_macro_mr",
                    "early_stop": 10, "tensorboardX": False,
                    "full_validation_every": 2}}
    (tmp_path / "config.json").write_text(json.dumps(config))
    cfg = t_train.parse_args(["-c", str(tmp_path / "config.json"),
                              "-d", "cpu"])
    log = t_train.main(cfg)
    assert log["epoch"] == 2 and log["full_validation"]
    assert np.isfinite(log["loss"]) and log["val_macro_mr"] >= 1
    run = cfg.save_dir
    best = run / "model_best.ckpt"
    assert best.exists() and (run / "checkpoint-epoch1.ckpt").exists()

    # the JAX package reads the port's checkpoint
    state = jckpt.load_checkpoint(best)
    jm = jbuilders.build_model({"args": ARCH}, max_parents=3,
                               expand_factor=6)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jparams = jckpt.restore_params(state, template)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    tree_leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert state["epoch"] == 2 and state["opt_state"]["count"] > 0

    # resume from epoch 1 and train epoch 2 again
    cfg2 = t_train.parse_args(["-r", str(run / "checkpoint-epoch1.ckpt"),
                               "-d", "cpu"])
    log2 = t_train.main(cfg2)
    assert log2["epoch"] == 2

    # the port serves it
    metrics = t_test_fast.main(t_test_fast.parse_args(
        ["-r", str(best), "-d", "cpu"]))
    assert set(config["metrics"]) <= set(metrics)
    assert all(np.isfinite(metrics[m]) for m in config["metrics"])
