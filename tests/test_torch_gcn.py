"""Port parity, the GCN/PGCN slice: the star ops `in_degrees` /
`copy_src_sum` and the generic path's edges and segment operations; the K5
wrappers' plain versions and the differentiable `gcn_layer` against the
Pallas kernel `fused_gcn_layer` (interpret mode, jitted) and jax.vjp
through it; the pe-dropout path against a JAX concat reference fed the
port's own masks; GCN `encode` and PGCN `forward` against the JAX model
(kernel="xla"); one PGCN train step at dropout 0 against the JAX step (and
its optimizer state carried over by `opt_state_from_jax`); the port's
generic segment path against its star path; and the PGCN command lines on
the CPU.

Inputs are made with numpy from a seed and handed to both sides, at the
sizes of tests/test_pallas_gcn.py. Tolerances: forwards rtol 1e-4 /
atol 1e-5, grads rtol 2e-4 / atol 2e-5 (that file's; float32, sums in
another order); model outputs 1e-4 (test_torch_model.py's)."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch import infer as t_infer
from taxoexpan_torch import test_fast as t_test_fast
from taxoexpan_torch import train as t_train
from taxoexpan_torch.data.egobatch import (EgoBatch, GroupBatch,
                                           ego_batch_edges, slot_mask)
from taxoexpan_torch.data.synthetic import synthetic_taxonomy
from taxoexpan_torch.models import TaxoExpan as TorchTaxoExpan
from taxoexpan_torch.models.generic import forward_generic
from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gcn_kernels as gk
from taxoexpan_torch.ops import segment as tseg
from taxoexpan_torch.ops import star as tstar
from taxoexpan_torch.training import checkpoint as tckpt
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer, batch_to
from taxoexpan_torch.tree import tree_leaves
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import losses as jlosses
from taxoexpan_tpu.data.egobatch import EgoBatch as JEgo
from taxoexpan_tpu.data.egobatch import GroupBatch as JGroup
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from taxoexpan_tpu.data.egobatch import ego_batch_edges as j_ego_edges
from taxoexpan_tpu.ops import segment as jseg
from taxoexpan_tpu.ops import star as jstar
from taxoexpan_tpu.ops.pallas_gcn import fused_gcn_layer
from taxoexpan_tpu.train import checkpoint as jckpt
from taxoexpan_tpu.train import optim as joptim

FTOL = dict(rtol=1e-4, atol=1e-5)
GTOL = dict(rtol=2e-4, atol=2e-5)
MTOL = dict(rtol=1e-4, atol=1e-4)
P, S = 3, 8
N = P + 1 + S
DIN, DOUT, POS = 6, 8, 5
B = 8
FEAT_DROP, SEED = 0.4, 777


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer_inputs(rng):
    """x (invalid slots zeroed as gather_feats leaves them; an empty and a
    full egonet first), W_h, W_p, b, pe rows, ngp, nsib."""
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.asarray(jstar.node_mask(jnp.asarray(ngp), jnp.asarray(nsib),
                                       P, N))
    x = rng.normal(size=(B, N, DIN)).astype(np.float32) * valid[..., None]
    w = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    return (x, w(DIN, DOUT), w(POS, DOUT), w(DOUT), w(N, POS) / 0.3, ngp,
            nsib)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **tol)


@jax.jit
def _jax_ops(x, ngp, nsib, src, dst, emask, nmask, logits, gids):
    h = x.reshape(B * N, DIN)
    return (jstar.in_degrees(ngp, nsib, P, N),
            jstar.copy_src_sum(x, ngp, nsib, P),
            jseg.in_degrees(dst, B * N, emask),
            jseg.edge_softmax(logits, dst, B * N, emask),
            jseg.spmm(h, src, dst, B * N, mask=emask),
            *(jseg.segment_readout(h, gids, B, node_mask=nmask, op=op)
              for op in ("sum", "mean", "max")))


def test_star_and_segment_ops_match_jax(rng):
    """in_degrees, copy_src_sum and gcn_norm of the star form; the segment
    operations of the generic path over ego_batch_edges' flat edges."""
    x, *_, ngp, nsib = _layer_inputs(rng)
    ego = EgoBatch(np.zeros((B, N), np.int32), ngp, nsib)
    src, dst, emask = ego_batch_edges(ego, P, S)
    for a, e in zip((src, dst, emask), j_ego_edges(JEgo(ego.node_ids, ngp,
                                                        nsib), P, S)):
        np.testing.assert_array_equal(a, e)
    nmask = slot_mask(ngp, nsib, P, S).reshape(-1)
    logits = rng.normal(size=(len(src), 2)).astype(np.float32)
    gids = np.repeat(np.arange(B), N)
    want = _jax_ops(x, ngp, nsib, src, dst, emask, nmask, logits, gids)
    tx, tg, ts, tsrc, tdst, tem, tnm, tl, tgi = _t(
        x, ngp, nsib, src, dst, emask, nmask, logits, gids)
    th = tx.reshape(B * N, DIN)
    got = (tstar.in_degrees(tg, ts, P, N), tstar.copy_src_sum(tx, tg, ts, P),
           tseg.in_degrees(tdst, B * N, tem),
           tseg.edge_softmax(tl, tdst, B * N, tem),
           tseg.spmm(th, tsrc, tdst, B * N, mask=tem),
           *(tseg.segment_readout(th, tgi, B, node_mask=tnm, op=op)
             for op in ("sum", "mean", "max")))
    for a, e in zip(got, want):
        _close(a, e, FTOL)
    deg = np.asarray(want[0])
    _close(tstar.gcn_norm(tg, ts, P, N)[..., 0],
           np.where(deg > 0, 1 / np.sqrt(np.maximum(deg, 1e-12)), 0), FTOL)


@functools.partial(jax.jit, static_argnames="alpha")
def _jax_k5(x, w_h, w_p, b, pe, ngp, nsib, cot, alpha):
    """fused_gcn_layer in interpret mode with the position term z_bias =
    pe @ W_p outside the kernel, and its VJP for (x, W_h, b, pe, W_p)."""
    def f(x, w_h, b, pe, w_p):
        return fused_gcn_layer(x, w_h, b, pe @ w_p, None, (ngp, nsib, SEED),
                               P, alpha, 0.0, True, True)
    out, vjp = jax.vjp(f, x, w_h, b, pe, w_p)
    return out, vjp(cot)


@pytest.mark.parametrize("pos", [False, True], ids=["gcn", "pgcn"])
@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_k5_matches_jax_kernel(rng, pos, alpha):
    """The plain version, the CPU wrapper and `gcn_layer` (forward and
    grads of x, W_h, b and, through z_bias, of pe and W_p) against the
    Pallas kernel; need_dx=False leaves x without a grad."""
    x, w_h, w_p, b, pe, ngp, nsib = _layer_inputs(rng)
    if not pos:
        pe = np.zeros_like(pe)               # z_bias = 0: the GCN layer
    cot = rng.normal(size=(B, N, DOUT)).astype(np.float32)
    want, want_g = _jax_k5(x, w_h, w_p, b, pe, ngp, nsib, cot, alpha)
    tx, th, tp, tb, tpe, tg, ts = _t(x, w_h, w_p, b, pe, ngp, nsib)
    zb = tpe @ tp if pos else torch.zeros(N, DOUT)
    _close(gk.gcn_layer_fwd_plain(tx, th, tb, zb, tg, ts, P, alpha), want,
           FTOL)
    _close(gk.gcn_layer_fwd(tx, th, tb, zb, tg, ts, P, alpha), want, FTOL)
    for need_dx in (True, False):
        leaves = [a.clone().requires_grad_(True) for a in (tx, th, tb, tpe,
                                                           tp)]
        out = gk.gcn_layer(leaves[0], leaves[1], leaves[2],
                           leaves[3] @ leaves[4], tg, ts, P, alpha=alpha,
                           need_dx=need_dx)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(cot),
                                  allow_unused=True)
        _close(out, want, FTOL)
        names = ("x", "w_h", "b", "pe", "w_p")[:5 if pos else 3]
        for name, a, e in zip(names, got, want_g):
            if name == "x" and not need_dx:
                assert a is None
                continue
            _close(a, e, GTOL)


@functools.partial(jax.jit, static_argnames="alpha")
def _jax_concat_reference(x, pe, w_full, b, ngp, nsib, feat_mask, pe_mask,
                          cot, alpha):
    """The reference layer over the concatenated input [x | pe] with the
    port's masks (dropout over the concat), and its VJP."""
    def f(x, pe, w_full, b):
        inp = jnp.concatenate([x * feat_mask, pe[None] * pe_mask], axis=-1)
        deg = jstar.in_degrees(ngp, nsib, P, N)
        norm = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1e-12)),
                         0.0)[..., None]
        out = jstar.copy_src_sum((inp @ w_full) * norm, ngp, nsib, P) \
            * norm + b
        return jnp.where(out >= 0, out, alpha * out)
    out, vjp = jax.vjp(f, x, pe, w_full, b)
    return out, vjp(cot)


def test_pe_dropout_matches_jax_concat_reference(rng):
    x, w_h, w_p, b, pe, ngp, nsib = _layer_inputs(rng)
    w_full = np.concatenate([w_h, w_p])
    masks = [dropout.slot_mask(SEED, stream, B, N, width, FEAT_DROP).numpy()
             for stream, width in ((dropout.STREAM_FEAT, DIN),
                                   (dropout.STREAM_PE, POS))]
    cot = rng.normal(size=(B, N, DOUT)).astype(np.float32)
    want, want_g = _jax_concat_reference(x, pe, w_full, b, ngp, nsib, *masks,
                                         cot, 0.01)
    leaves = [a.requires_grad_(True) for a in _t(x, pe, w_full, b)]
    tx, tpe, tw, tb = leaves
    out = gk.gcn_layer(tx, tw[:DIN], tb, torch.zeros(N, DOUT), *_t(ngp, nsib),
                       P, pe_pack=(tpe, tw[DIN:]), seed=SEED, drop=FEAT_DROP,
                       alpha=0.01)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    _close(out, want, FTOL)
    for a, e in zip(got, want_g):
        _close(a, e, GTOL)


# ------------------------------------------------------------ the model

ARCH = dict(in_dim=DIN, hidden_dim=8, out_dim=6, pos_dim=POS, num_layers=1,
            heads=[2, 1], max_parents=P, expand_factor=S)


def _models(pm, rm, layers=1, **kw):
    """Both models and one parameter tree in the JAX model's layout, drawn
    with numpy (the shapes from jax.eval_shape of its init, which compiles
    nothing), carried into the port by params_from_jax."""
    arch = dict(ARCH, num_layers=layers, **kw)
    jm = JaxTaxoExpan(pm, rm, "BIM", kernel="xla", **arch)
    tm = TorchTaxoExpan(pm, rm, "BIM", **arch)
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(a.dtype),
        jax.eval_shape(jm.init, jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, tm.init(torch.Generator().manual_seed(0)))
    return jm, jp, tm, tp


def test_gcn_encode_and_match_all(rng):
    """GCN (no positions) with a middle layer and the CR readout; PGCN's
    forward is held in test_pgcn_train_step_matches_jax."""
    jm, jp, tm, tp = _models("GCN", "CR", 2)
    x, *_, ngp, nsib = _layer_inputs(rng)
    qf = rng.normal(size=(5, DIN)).astype(np.float32)

    @jax.jit
    def jax_encode(params, x, ngp, nsib, qf):
        hg = jm.encode(params, x, ngp, nsib, rng=jax.random.PRNGKey(0),
                       train=False)
        return hg, jm.match_all(params, hg, qf)

    want, want_s = jax_encode(jp, x, ngp, nsib, qf)
    with torch.no_grad():
        got = tm.encode(tp, *_t(x, ngp, nsib))
        _close(got, want, MTOL)
        _close(tm.match_all(tp, got, torch.from_numpy(qf)), want_s, MTOL)


def _group_batch(rng, g, c, v):
    b = g * c
    ngp = rng.integers(0, P + 1, (b,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (b,)).astype(np.int32)
    labels = np.zeros((g, c), np.float32)
    labels[:, 0] = 1.0
    return GroupBatch(ego=EgoBatch(rng.integers(0, v, (b, N)).astype(
        np.int32), ngp, nsib), query_ids=rng.integers(0, v, (g,)).astype(
        np.int32), query_feats=None, labels=labels,
        cand_mask=np.ones((g, c), bool))


def test_pgcn_train_step_matches_jax(rng, tmp_path):
    """The PGCN model's eval forward (encode, readout, match), then one
    AMSGrad step (dropout 0) through the port's Trainer.train_step against
    the JAX step from the same params; then the JAX optimizer state after
    that step, carried into the port by opt_state_from_jax (a JAX
    checkpoint), equals the JAX state."""
    jm, jp, tm, tp = _models("PGCN", "WMR", feat_drop=0.0, hidden_drop=0.0,
                             out_drop=0.0)
    batch = _group_batch(rng, 4, 3, 40)
    table = rng.normal(size=(40, DIN)).astype(np.float32)
    jbatch = JGroup(ego=JEgo(*(jnp.asarray(a) for a in (
        batch.ego.node_ids, batch.ego.ngp, batch.ego.nsib))),
        query_ids=jnp.asarray(batch.query_ids), query_feats=None,
        labels=jnp.asarray(batch.labels), cand_mask=jnp.asarray(
            batch.cand_mask))
    jopt = joptim.build_optimizer(lr=1e-2, amsgrad=True)

    @jax.jit
    def jax_step(params, state):
        def loss_fn(p, train=True):
            return jm.forward(p, jbatch, jnp.asarray(table),
                              rng=jax.random.PRNGKey(0), train=train)
        loss, grads = jax.value_and_grad(lambda p: jlosses.info_nce_loss(
            loss_fn(p), jbatch.labels, jbatch.cand_mask))(params)
        updates, state = jopt.update(grads, state, params)
        return (optax.apply_updates(params, updates), state, loss, grads,
                loss_fn(params, train=False))

    jstate = jopt.init(jp)
    jp2, jstate, jloss, jgrads, jscores = jax_step(jp, jstate)
    with torch.no_grad():
        _close(tm.forward(tp, batch_to(batch, torch.device("cpu")),
                          torch.from_numpy(table)), jscores, MTOL)
    topt = toptim.Optimizer(lr=1e-2, amsgrad=True)
    trainer = Trainer(tm, tp, topt, topt.init(tp), loss_name="info_nce_loss",
                      metric_names=["macro_mr"], feature_table=table,
                      train_loader=None, save_dir=tmp_path, device="cpu")
    tloss = trainer.train_step(batch_to(batch, torch.device("cpu")), 0)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    for a, e, g in zip(tree_leaves(trainer.params),
                       jax.tree_util.tree_leaves(jp2),
                       jax.tree_util.tree_leaves(jgrads)):
        well = np.abs(np.asarray(g)) >= 1e-6
        diff = np.abs(a.numpy() - np.asarray(e))
        assert (diff[well] <= 1e-4 + 1e-4 * np.abs(np.asarray(e))[well]).all()
        assert (diff[~well] <= 2e-2).all()

    config = {"arch": {"args": dict(ARCH, propagation_method="PGCN")},
              "optimizer": {"type": "Adam"}}
    jckpt.save_checkpoint(tmp_path / "jax.ckpt", params=jp2,
                          opt_state=jstate, epoch=1, monitor_best=1.0,
                          config=config)
    params, state = tckpt.restore_into(
        tckpt.load_checkpoint(tmp_path / "jax.ckpt"), model=tm,
        optimizer=topt, config=config, device=torch.device("cpu"))
    assert state["count"] == 1
    inner = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "nu_max"))
        if hasattr(s, "nu_max")][0]
    for key in ("mu", "nu", "nu_max"):
        for a, e in zip(tree_leaves(state[key]),
                        jax.tree_util.tree_leaves(getattr(inner, key))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    for a, e in zip(tree_leaves(params), jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


@pytest.mark.parametrize("pm,rm", [("PGAT", "WMR"), ("PGCN", "MR"),
                                   ("GAT", "CR"), ("GCN", "WMR")])
def test_generic_path_matches_star_path(rng, pm, rm):
    """The pairs of tests/test_generic_path.py, eval form, the port alone:
    flat edges and segment operations against the star closed form."""
    tm = TorchTaxoExpan(pm, rm, "BIM", **dict(ARCH, hidden_dim=16,
                                               out_dim=8))
    params = tm.init(torch.Generator().manual_seed(1))
    batch = _group_batch(rng, 4, 3, 40)
    table = torch.from_numpy(rng.normal(size=(40, DIN)).astype(np.float32))
    with torch.no_grad():
        star = tm.forward(params, batch_to(batch, torch.device("cpu")),
                          table)
        generic = forward_generic(tm, params, batch, table)
    _close(generic, star, dict(rtol=2e-4, atol=2e-5))


def test_cli_pgcn_train_and_serve(tmp_path):
    """`python -m taxoexpan_torch.train -d cpu` trains PGCN for one epoch
    (dropout on, full-catalog validation); `test_fast` and `infer` serve
    its best checkpoint."""
    synthetic_taxonomy(num_nodes=80, dim=16, seed=2).save(
        str(tmp_path / "data.pickle.bin"))
    loader = {"data_path": str(tmp_path / "data.pickle.bin"),
              "sampling_mode": 1, "batch_size": 8, "negative_size": 5,
              "expand_factor": 6, "normalize_embed": True, "num_workers": 0}
    arch = {"propagation_method": "PGCN", "readout_method": "WMR",
            "matching_method": "BIM", "in_dim": 16, "hidden_dim": 8,
            "out_dim": 8, "pos_dim": 4, "num_layers": 1}
    config = {
        "name": "tiny_pgcn", "seed": 0,
        "arch": {"type": "TaxoExpan", "args": arch},
        "train_data_loader": {"args": loader},
        "validation_data_loader": {"args": dict(loader, sampling_mode=0)},
        "test_data_loader": {"args": dict(loader, sampling_mode=0)},
        "optimizer": {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}},
        "loss": "info_nce_loss", "metrics": ["macro_mr", "hit_at_1"],
        "trainer": {"epochs": 1, "save_dir": str(tmp_path / "saved"),
                    "save_period": 1, "monitor": "min val_macro_mr",
                    "tensorboardX": False, "full_validation_every": 1}}
    (tmp_path / "config.json").write_text(json.dumps(config))
    cfg = t_train.parse_args(["-c", str(tmp_path / "config.json"), "-d",
                              "cpu"])
    log = t_train.main(cfg)
    assert log["full_validation"] and np.isfinite(log["loss"])
    best = str(cfg.save_dir / "model_best.ckpt")
    metrics = t_test_fast.main(t_test_fast.parse_args(["-r", best, "-d",
                                                       "cpu"]))
    assert all(np.isfinite(metrics[m]) for m in config["metrics"])
    taxonomy = tbuilders.build_taxonomy(loader["data_path"])
    with open(tmp_path / "novel.txt", "w") as fout:
        for i, row in enumerate(taxonomy.features[:2] + 0.01):
            fout.write(f"new term {i}\t{' '.join(map(str, row))}\n")
    preds = t_infer.main(t_infer.parse_args(
        ["-r", best, "-t", str(tmp_path / "novel.txt"), "-d", "cpu", "-s",
         str(tmp_path / "out.tsv")]))
    assert len(preds) == 2 and all(len(p) == 5 for p in preds)
