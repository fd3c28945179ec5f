"""Port parity, the variants slice: the MAX and PATR readouts, the per-slot
final GAT layer, the auxiliary MTL heads (`forward_heads`, the mean of the
per-head losses, their weights and checkpoints), the stored-attention
forms of the GAT layers (TAXOEXPAN_STORED_ATTN=1) and the 8-bit dropout
thresholds (TAXOEXPAN_DROPOUT_BITS=8), each against the JAX package on the
same numpy inputs (models with kernel="xla", the Pallas kernels in
interpret mode, the JAX side jitted), and the MTL configuration through the
port's command lines on the CPU.

Tolerances: forward values 1e-5 relative plus 1e-6; grads 1e-5 relative to
each leaf's largest value (float32, sums in another order), also between
the port's stored and recompute backwards, both plain (the same masks; the
softmax Jacobian written out against autograd's chain through exp and the
division: float32 rounding of a few ulp); the test_fast metrics exactly."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch import test_fast as t_test_fast
from taxoexpan_torch import train as t_train
from taxoexpan_torch.data.egobatch import EgoBatch, GroupBatch
from taxoexpan_torch.data.synthetic import synthetic_taxonomy
from taxoexpan_torch.models import TaxoExpan as TorchTaxoExpan
from taxoexpan_torch.models.propagation import GAT as TorchGAT
from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import gcn_kernels as ck
from taxoexpan_torch.ops import star as tstar
from taxoexpan_torch.ops.launch import train_args
from taxoexpan_torch.training import checkpoint as tckpt
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer, batch_to
from taxoexpan_torch.tree import tree_leaves
from taxoexpan_torch.weights import load_jax_checkpoint, params_from_jax
from taxoexpan_tpu import builders as jbuilders
from taxoexpan_tpu import losses as jlosses
from taxoexpan_tpu.data.egobatch import EgoBatch as JEgo
from taxoexpan_tpu.data.egobatch import GroupBatch as JGroup
from taxoexpan_tpu.evaluation import TaxonomyRanker as JRanker
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from taxoexpan_tpu.models.propagation import GAT as JaxGAT
from taxoexpan_tpu.ops import star as jstar
from taxoexpan_tpu.ops.pallas_gat import (fused_gat_layer,
                                          fused_gat_layer_pooled)
from taxoexpan_tpu.train import checkpoint as jckpt

FTOL = dict(rtol=1e-5, atol=1e-6)
P, S = 3, 6
N = P + 1 + S
D, HID, OUT, POS, ATT = 8, 6, 5, 3, 4
B = 8
AUX = [{"readout": "WMR", "matcher": "BIM"}]
STORED, BITS = "TAXOEXPAN_STORED_ATTN", "TAXOEXPAN_DROPOUT_BITS"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol=FTOL, **kw):
    np.testing.assert_allclose(np.asarray(
        got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), **tol, **kw)


def _close_leaf(got, want, rel=1e-5, name=""):
    """Within `rel` of the leaf's largest value."""
    want = np.asarray(want)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, name


def _egonets(rng, d=D):
    """Features (invalid slots zeroed as gather_feats leaves them; an empty
    egonet, ngp = nsib = 0, and a full one first)."""
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.asarray(jstar.node_mask(jnp.asarray(ngp), jnp.asarray(nsib),
                                       P, N))
    x = rng.normal(size=(B, N, d)).astype(np.float32) * valid[..., None]
    return x, ngp, nsib


def _np_params(jax_init, key):
    """A JAX-layout parameter tree drawn with numpy at the shapes of
    `jax_init` (jax.eval_shape compiles nothing)."""
    rng = np.random.default_rng(key)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.4).astype(a.dtype),
        jax.eval_shape(jax_init, jax.random.PRNGKey(key)))


# ------------------------------------------------------------ readouts

@jax.jit
def _jax_readouts(h, ngp, nsib, gate):
    def f(h, gate):
        return (jstar.readout(h, ngp, nsib, P, kind="MAX"),
                jstar.readout_attention(h, ngp, nsib, P, gate))
    out, vjp = jax.vjp(f, h, gate)
    return out, vjp((jnp.ones_like(out[0]), jnp.ones_like(out[1])))


def test_max_and_patr_readouts_match_jax(rng):
    """MAX (padded slots masked to -1e30; a tie on every feature of an
    egonet splits its gradient as jnp.max does) and PATR, values and the
    grads of h and of the gate params, on egonets with ngp = nsib = 0."""
    h, ngp, nsib = _egonets(rng, OUT)
    h[2, P + 1] = h[2, P]                     # a tie between two valid slots
    nsib[2] = max(nsib[2], 1)
    gate = {"w1": rng.normal(size=(OUT, ATT)).astype(np.float32),
            "b1": rng.normal(size=(ATT,)).astype(np.float32),
            "class_emb": rng.normal(size=(3, ATT)).astype(np.float32),
            "w2": rng.normal(size=(ATT, 1)).astype(np.float32)}
    (want_max, want_patr), (want_dh, want_dgate) = _jax_readouts(
        h, ngp, nsib, gate)
    th = torch.from_numpy(h).requires_grad_(True)
    tgate = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in gate.items()}
    tg, ts = _t(ngp, nsib)
    got_max = tstar.readout(th, tg, ts, P, kind="MAX")
    got_patr = tstar.readout_attention(th, tg, ts, P, tgate)
    _close(got_max, want_max)
    _close(got_patr, want_patr)
    (got_max.sum() + got_patr.sum()).backward()
    _close_leaf(th.grad, want_dh, name="h")
    for k in gate:
        _close_leaf(tgate[k].grad, want_dgate[k], name=k)


# ------------------------------------------------ per-slot final layer

PER_SLOT_ARCH = (D, HID, OUT, 1, [2, 2])


@functools.lru_cache(maxsize=None)
def _jax_per_slot_stack():
    """The JAX GAT stack (XLA path) per slot at dropout 0 and its VJP, on
    the inputs of tests/conftest.py's rng, computed once for both forms
    (at dropout 0 the JAX train and eval forms are the same function)."""
    rng = np.random.default_rng(0)
    jgat = JaxGAT(*PER_SLOT_ARCH, pos_dim=POS, feat_drop=0.0, attn_drop=0.0)
    jp = _np_params(jgat.init, 5)
    x, ngp, nsib = _egonets(rng)
    cot = rng.normal(size=(B, N, OUT)).astype(np.float32)

    @jax.jit
    def jax_side(params, x, cot):
        f = lambda p: jgat.apply(p, x, ngp, nsib, P,  # noqa: E731
                                 rng=jax.random.PRNGKey(0), train=True)
        out, vjp = jax.vjp(f, params)
        return out, vjp(cot)[0]

    return jp, (x, ngp, nsib, cot), jax_side(jp, x, cot)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_per_slot_gat_stack_matches_jax(train):
    """GAT.apply(pool_readout=False) at dropout 0: layer 0 (K1 with the
    fused leaky_relu), the per-slot final layer (K1 without activation; two
    heads here, so the mean over heads is exercised) and that mean; in
    train form the differentiable layers (K2, need_dx on the final layer)
    against jax.vjp."""
    jp, (x, ngp, nsib, cot), (want, want_g) = _jax_per_slot_stack()
    tgat = TorchGAT(*PER_SLOT_ARCH, pos_dim=POS)
    tp = params_from_jax(jp, tgat.init(torch.Generator().manual_seed(0)))
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(train)
    with torch.set_grad_enabled(train):
        got = tgat.apply(tp, *_t(x, ngp, nsib), P, train=train,
                         gen=torch.Generator().manual_seed(1),
                         pool_readout=False)
    _close(got, want)
    if train:
        grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
        for a, e in zip(grads, jax.tree_util.tree_leaves(want_g)):
            _close_leaf(a, e)


# ------------------------------------------------------------ MTL model

MTL_ARCH = dict(in_dim=D, hidden_dim=HID, out_dim=OUT, pos_dim=POS,
                num_layers=1, heads=[2, 1], max_parents=P, expand_factor=S,
                attention_dim=ATT, aux_heads=AUX, feat_drop=0.0,
                attn_drop=0.0)


def _group_batch(rng, g, c, v):
    b = g * c
    ngp = rng.integers(0, P + 1, (b,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (b,)).astype(np.int32)
    ngp[0] = nsib[0] = 0
    labels = np.zeros((g, c), np.float32)
    labels[:, 0] = 1.0
    return GroupBatch(ego=EgoBatch(rng.integers(0, v, (b, N)).astype(
        np.int32), ngp, nsib), query_ids=rng.integers(0, v, (g,)).astype(
        np.int32), query_feats=None, labels=labels,
        cand_mask=np.ones((g, c), bool))


def test_forward_heads_and_mtl_loss_grads_match_jax(rng, tmp_path):
    """The MTL model (PATR + PMLP, one WMR + BIM auxiliary head):
    forward_heads' scores [2, G, C], then one train step (the mean of the
    per-head bce losses, AMSGrad) against jax.grad; the JAX optimizer state
    after that step carried in (opt_state_from_jax) with its `aux`."""
    jm = JaxTaxoExpan("PGAT", "PATR", "PMLP", kernel="xla", **MTL_ARCH)
    tm = TorchTaxoExpan("PGAT", "PATR", "PMLP", **MTL_ARCH)
    jp = _np_params(jm.init, 7)
    assert set(jp) == {"propagate", "readout", "match", "aux"}
    tp = params_from_jax(jp, tm.init(torch.Generator().manual_seed(0)))
    batch = _group_batch(rng, 3, 4, 30)
    table = rng.normal(size=(30, D)).astype(np.float32)
    jbatch = JGroup(ego=JEgo(*(jnp.asarray(a) for a in (
        batch.ego.node_ids, batch.ego.ngp, batch.ego.nsib))),
        query_ids=jnp.asarray(batch.query_ids), query_feats=None,
        labels=jnp.asarray(batch.labels),
        cand_mask=jnp.asarray(batch.cand_mask))
    jopt = jbuilders.build_optimizer_from_config(
        {"type": "Adam", "args": {"lr": 1e-2, "amsgrad": True}})

    @jax.jit
    def jax_step(params):
        def loss_fn(p):
            scores = jm.forward_heads(p, jbatch, jnp.asarray(table),
                                      rng=jax.random.PRNGKey(0), train=True)
            return jax.vmap(lambda s: jlosses.bce_loss(
                s, jbatch.labels, jbatch.cand_mask))(scores).mean(), scores
        (loss, scores), grads = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(params)
        state = jopt.init(params)
        updates, state = jopt.update(grads, state, params)
        return scores, loss, grads, state

    jscores, jloss, jgrads, jstate = jax_step(jp)
    cpu = torch.device("cpu")
    with torch.no_grad():
        got = tm.forward_heads(tp, batch_to(batch, cpu),
                               torch.from_numpy(table))
    assert got.shape == (2, 3, 4)
    _close(got, jscores)
    topt = toptim.Optimizer(lr=1e-2, amsgrad=True)
    trainer = Trainer(tm, tp, topt, topt.init(tp), loss_name="bce_loss",
                      metric_names=["macro_mr"], feature_table=table,
                      train_loader=None, save_dir=tmp_path, device="cpu")
    loss, grads = trainer.train_step(batch_to(batch, cpu), 0,
                                     return_grads=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for a, e in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        _close_leaf(a, e)

    config = {"arch": {"args": dict(MTL_ARCH, propagation_method="PGAT")},
              "optimizer": {"type": "Adam"}}
    jckpt.save_checkpoint(tmp_path / "jax.ckpt", params=jp,
                          opt_state=jstate, epoch=1, monitor_best=1.0,
                          config=config)
    _, state = tckpt.restore_into(
        tckpt.load_checkpoint(tmp_path / "jax.ckpt"), model=tm,
        optimizer=topt, config=config, device=cpu)
    inner = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "nu_max"))
        if hasattr(s, "nu_max")][0]
    assert len(state["mu"]["aux"]) == 1
    for a, e in zip(tree_leaves(state["nu"]),
                    jax.tree_util.tree_leaves(inner.nu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def test_builders_accept_the_mtl_config():
    """config.semeval_verb_mtl.json builds (PATR, PMLP, one aux head at its
    widths), also with compute_dtype "bfloat16" (bf16 GAT layers);
    pos_mode="concat" builds, and a pos_mode or a compute dtype the JAX
    package refuses raises."""
    with open("configs/config.semeval_verb_mtl.json") as fin:
        arch = json.load(fin)["arch"]
    model = tbuilders.build_model(arch, max_parents=P, expand_factor=S)
    assert model.readout.kind == "PATR" and model.matcher.kind == "PMLP"
    assert model.readout.attention_dim == 100
    assert [(rd.kind, mt.kind) for rd, mt in model.aux_heads] == [
        ("WMR", "BIM")]
    assert model.propagate.layer_specs == [(400, 900, 4), (3700, 600, 1)]
    bf16 = {"args": dict(arch["args"], compute_dtype="bfloat16")}
    assert tbuilders.build_model(bf16, max_parents=P, expand_factor=S
                                 ).propagate.dtype == torch.bfloat16
    concat = {"args": dict(arch["args"], pos_mode="concat")}
    assert tbuilders.build_model(concat, max_parents=P, expand_factor=S
                                 ).propagate.pos_mode == "concat"
    for key, value, match in (("pos_mode", "sum", "pos_mode"),
                              ("compute_dtype", "float16", "compute_dtype")):
        bad = {"args": dict(arch["args"], **{key: value})}
        with pytest.raises(ValueError, match=match):
            tbuilders.build_model(bad, max_parents=P, expand_factor=S)


# ------------------------------------------------ stored attention (K7a)

HEADS, DH = 2, 4


def _layer_inputs(rng, heads=HEADS):
    x, ngp, nsib = _egonets(rng, 6)
    w = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    return (x, w(6, heads * DH), w(6, heads), w(6, heads), w(N, heads * DH),
            w(N, heads), w(N, heads), ngp, nsib)


class _Spy:
    """Records which backward form the plain path ran."""

    def __init__(self, monkeypatch):
        self.stored = []
        plain = gk.gat_layer_bwd_plain

        def spy(*a, stored_attn=None, **kw):
            self.stored.append(stored_attn is not None)
            return plain(*a, stored_attn=stored_attn, **kw)
        monkeypatch.setattr(gk, "gat_layer_bwd_plain", spy)


@pytest.mark.parametrize("pooled", [False, True], ids=["k2", "k4"])
def test_stored_path_matches_jax_stored(rng, monkeypatch, pooled):
    """With TAXOEXPAN_STORED_ATTN=1 on both sides at dropout 0: the JAX
    custom_vjp stores its softmax weights (interpret mode) and so does the
    port, whose backward then runs the stored form."""
    monkeypatch.setenv(STORED, "1")
    spy = _Spy(monkeypatch)
    arrays = _layer_inputs(rng)
    g = rng.normal(size=(B, 3, DH) if pooled else (B, N, HEADS * DH)
                   ).astype(np.float32)

    def jax_vjp(diff, ngp, nsib, cot):
        if pooled:
            f = lambda *d: fused_gat_layer_pooled(  # noqa: E731
                *d, None, (ngp, nsib, 0), P, HEADS, 0.2, 0.0, 0.0, True, True)
        else:
            f = lambda *d: fused_gat_layer(  # noqa: E731
                *d, None, (ngp, nsib, 0), P, HEADS, 0.2, 0.0, 0.0, 0.01,
                True, True)
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(cot)

    # traced here, with the switch set (the JAX package reads it at trace)
    want_out, want = jax.jit(jax_vjp)(
        tuple(jnp.asarray(a) for a in arrays[:7]), arrays[7], arrays[8],
        jnp.asarray(g))
    t = _t(*arrays)
    leaves = [a.clone().requires_grad_(True) for a in t[:7]]
    if pooled:
        out = gk.gat_layer_pooled(*leaves, t[7], t[8], P, HEADS)
    else:
        out = gk.gat_layer(*leaves, t[7], t[8], P, HEADS, out_alpha=0.01)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert spy.stored == [True]
    _close(out, want_out)
    for a, e in zip(got, want):
        _close_leaf(a, e)


@pytest.mark.parametrize("pooled", [False, True], ids=["k2", "k4"])
@pytest.mark.parametrize("bits", [32, 8])
def test_stored_and_recompute_agree_with_dropout(rng, monkeypatch, pooled,
                                                 bits):
    """Feature, pe and attention dropout on: the port's stored and
    recompute paths (plain versions) give the same output and grads."""
    monkeypatch.setenv(BITS, str(bits))
    spy = _Spy(monkeypatch)
    arrays = _layer_inputs(rng)
    pe_pack = _t(*(rng.normal(size=s).astype(np.float32) * 0.3
                   for s in ((N, POS), (POS, HEADS * DH), (POS, HEADS),
                             (POS, HEADS))))
    g = torch.from_numpy(rng.normal(
        size=(B, 3, DH) if pooled else (B, N, HEADS * DH)).astype(
        np.float32))
    t = _t(*arrays)
    res = []
    for stored in ("1", "0"):
        monkeypatch.setenv(STORED, stored)
        leaves = [a.clone().requires_grad_(True) for a in t[:7] + pe_pack]
        kw = dict(pe_pack=tuple(leaves[7:]), seed=5, feat_drop=0.3,
                  attn_drop=0.3)
        if pooled:
            out = gk.gat_layer_pooled(*leaves[:7], t[7], t[8], P, HEADS, **kw)
        else:
            out = gk.gat_layer(*leaves[:7], t[7], t[8], P, HEADS,
                               out_alpha=0.01, **kw)
        res.append((out, torch.autograd.grad(out, leaves, g)))
    assert spy.stored == [True, False]
    (out_s, grads_s), (out_r, grads_r) = res
    torch.testing.assert_close(out_s, out_r, rtol=0, atol=0)
    for name, a, e in zip(gk._GRAD_NAMES + gk._PE_NAMES, grads_s, grads_r):
        _close_leaf(a, e, name=name)


def test_switches_are_read_at_forward_time(rng, monkeypatch):
    """The bit mode and the stored form are fixed when the forward runs:
    switches changed before the backward do not desynchronise the mask
    replay; without a gradient nothing is stored."""
    arrays = _layer_inputs(rng)
    t = _t(*arrays)
    kw = dict(seed=9, feat_drop=0.3, attn_drop=0.3, out_alpha=0.01)
    g = torch.from_numpy(rng.normal(size=(B, N, HEADS * DH)).astype(
        np.float32))
    leaves = [a.clone().requires_grad_(True) for a in t[:7]]
    monkeypatch.setenv(BITS, "8")
    monkeypatch.setenv(STORED, "1")
    out = gk.gat_layer(*leaves, t[7], t[8], P, HEADS, **kw)
    monkeypatch.setenv(BITS, "32")
    monkeypatch.setenv(STORED, "0")
    got = torch.autograd.grad(out, leaves, g)
    want = gk.gat_layer_bwd_plain(g, *t[:9], P, HEADS, dropout_bits=8, **kw)
    torch.testing.assert_close(out, gk.gat_layer_train_plain(
        *t[:9], P, HEADS, dropout_bits=8, **kw), rtol=0, atol=0)
    for name, a in zip(gk._GRAD_NAMES, got):
        _close_leaf(a, want[name], name=name)
    monkeypatch.setenv(STORED, "1")
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        gk.gat_layer(*t[:9], P, HEADS, **kw)
    assert gk._layer_cfg(P, HEADS, 0, 0.1, 0.1, None, True, False,
                         t[:7]).store is False
    assert spy.stored == []


# ------------------------------------------------ 8-bit thresholds (K7b)

def test_byte8_golden_and_thresholds():
    """Pinned bytes (plain tensors, Python integers and the word they come
    from), and t8 / scale by the JAX package's formula."""
    for (seed, stream, row, col), want in dropout.GOLDEN_BYTES8:
        word = dropout.bits_int(seed, stream, row, col >> 2)
        assert (word >> (8 * (col & 3))) & 0xFF == want
        assert dropout.byte8_int(seed, stream, row, col) == want
        got = dropout.bits(seed, stream, torch.tensor([row]),
                           torch.tensor([col]), width=8)
        assert int(got[0]) == want
    for rate in (0.1, 0.5, 0.9, 0.999, 1e-4):
        t8 = min(max(int((1.0 - rate) * 256.0), 1), 255)
        assert dropout.keep_threshold(rate, 8) == t8
        assert np.float32(dropout.keep_scale(rate, 8)) == np.float32(
            256.0 / t8)
        ta = train_args(None, 1, rate, rate, bits=8)
        assert (ta.feat_thresh, ta.attn_thresh, ta.bits8) == (t8, t8, 1)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_byte8_keep_rate_unbiased(rate):
    """Keep rate t8 / 256 within 4 sigma, mask mean 1 (the 256 / t8 scale),
    the attention masks of every kind, and K5's masks unchanged by the
    switch (pallas_gcn.py reads none)."""
    b, n, w = 32, 64, 250
    m = dropout.slot_mask(5, dropout.STREAM_FEAT, b, n, w, rate, bits=8)
    t8 = dropout.keep_threshold(rate, 8)
    q = t8 / 256
    sigma = (q * (1 - q) / m.numel()) ** 0.5
    assert abs(float((m > 0).double().mean()) - q) < 4 * sigma
    assert abs(float(m.double().mean()) - 1.0) < 4 * sigma / q
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(256.0 / t8)}
    assert not torch.equal(m, dropout.slot_mask(5, dropout.STREAM_FEAT, b, n,
                                                w, rate))
    a = dropout.attention_masks(5, 512, P, S, HEADS, rate, bits=8)
    k = torch.cat([(x > 0).flatten() for x in a]).double()
    sigma = (q * (1 - q) / k.numel()) ** 0.5
    assert abs(float(k.mean()) - q) < 4 * sigma


def test_gcn_masks_stay_32_bit(rng, monkeypatch):
    x, ngp, nsib = _egonets(rng, 6)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    ops = _t(x, w, np.zeros(5, np.float32), np.zeros((N, 5), np.float32),
             ngp, nsib)
    want = ck.gcn_layer_train_plain(*ops, P, seed=3, drop=0.4, alpha=0.01)
    monkeypatch.setenv(BITS, "8")
    torch.testing.assert_close(ck.gcn_layer(*ops, P, seed=3, drop=0.4,
                                            alpha=0.01), want, rtol=0,
                               atol=0)


# -------------------------------------------- the MTL configuration's CLIs

def _mtl_config(tmp_path, in_dim=16):
    synthetic_taxonomy(num_nodes=60, dim=in_dim, seed=4).save(
        str(tmp_path / "data.pickle.bin"))
    loader = {"data_path": str(tmp_path / "data.pickle.bin"),
              "sampling_mode": 1, "batch_size": 4, "negative_size": 3,
              "expand_factor": 5, "normalize_embed": True, "num_workers": 0}
    with open("configs/config.semeval_verb_mtl.json") as fin:
        config = json.load(fin)
    config["arch"]["args"].update(in_dim=in_dim, hidden_dim=6, out_dim=5,
                                  pos_dim=3, attention_dim=4)
    config.update(
        train_data_loader={"args": loader},
        validation_data_loader={"args": dict(loader, sampling_mode=0)},
        test_data_loader={"args": dict(loader, sampling_mode=0)},
        metrics=["macro_mr", "hit_at_1", "mrr_scaled_10"])
    config["trainer"].update(epochs=1, save_dir=str(tmp_path / "saved"),
                             tensorboardX=False, full_validation_every=1)
    (tmp_path / "config.json").write_text(json.dumps(config))
    return config


def test_test_fast_of_a_jax_mtl_checkpoint_equals_jax(tmp_path):
    """A JAX MTL checkpoint (with `aux`) served by the port's test_fast:
    the metrics equal the JAX ranker's."""
    config = _mtl_config(tmp_path)
    loader = dict(config["test_data_loader"]["args"])
    taxonomy = jbuilders.build_taxonomy(loader["data_path"])
    sampler = jbuilders.build_sampler(taxonomy, loader, "test")
    model = jbuilders.build_model(config["arch"],
                                  max_parents=sampler.max_parents,
                                  expand_factor=sampler.expand_factor)
    params = _np_params(model.init, 11)
    jckpt.save_checkpoint(tmp_path / "model_best.ckpt", params=params,
                          opt_state=None, epoch=1, monitor_best=1.0,
                          config=config)
    got = t_test_fast.main(t_test_fast.parse_args(
        ["-r", str(tmp_path / "model_best.ckpt"), "-d", "cpu"]))
    want, _ = JRanker(model, params, sampler, sampler.node_features
                      ).evaluate(config["metrics"], 0)
    assert got == pytest.approx(want, rel=1e-12)


def test_cli_train_mtl_with_both_switches(tmp_path, monkeypatch):
    """`python -m taxoexpan_torch.train -d cpu` on the MTL configuration
    (tiny widths) with TAXOEXPAN_STORED_ATTN=1 and TAXOEXPAN_DROPOUT_BITS=8:
    a finite loss and a checkpoint with `aux`, which the JAX package's
    restore_params reads and the port reads back unchanged; test_fast
    serves it."""
    monkeypatch.setenv(STORED, "1")
    monkeypatch.setenv(BITS, "8")
    spy = _Spy(monkeypatch)
    config = _mtl_config(tmp_path)
    cfg = t_train.parse_args(["-c", str(tmp_path / "config.json"), "-d",
                              "cpu"])
    log = t_train.main(cfg)
    assert np.isfinite(log["loss"]) and log["full_validation"]
    assert spy.stored and all(spy.stored)
    best = cfg.save_dir / "model_best.ckpt"
    state = load_jax_checkpoint(best)
    assert len(state["params"]["aux"]) == 1
    jm = jbuilders.build_model(config["arch"], max_parents=P,
                               expand_factor=5)
    tm = tbuilders.build_model(config["arch"], max_parents=P,
                               expand_factor=5)
    jparams = jckpt.restore_params(state, _np_params(jm.init, 0))
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           tm.init(torch.Generator().manual_seed(0)))
    for a, e in zip(tree_leaves(back), jax.tree_util.tree_leaves(
            state["params"])):
        np.testing.assert_array_equal(a.numpy(), e)
    metrics = t_test_fast.main(t_test_fast.parse_args(["-r", str(best),
                                                       "-d", "cpu"]))
    assert all(np.isfinite(metrics[m]) for m in config["metrics"])
