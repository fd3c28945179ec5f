"""Port parity, residual GAT layers (`GAT(residual=True)`,
taxoexpan_tpu/models/propagation.py:187-203, :234-238, :326-332, :490-495):
every layer after layer 0 adds x @ res_fc (or x itself when its width is
the head width) to its per-slot output before the stack's activation.

- GAT without positions (two layers, heads [2, 2, 1]: a res_fc layer and
  an identity one), eval output and grads against JAX's
  `GAT(residual=True)` (its XLA path: residual layers never take the fused
  kernel, :235), at rtol 1e-5 / atol 1e-5;
- PGAT in pos_mode "concat" with residual layers as the composite model's
  propagation (WMR readout: the final layer is residual, so encode takes
  the per-slot path, taxoexpan.py:195-197): scores and grads against the
  JAX model with the same propagation, at 1e-5;
- PGAT in pos_mode "bias" with residual layers: the JAX package fails on
  it (res_fc has in_dim + pos_dim rows, the input has no pe columns), the
  port refuses it when it builds the stack;
- a train-mode residual layer drops its input once: both branches take the
  same mask (the kernel's output and the residual branch recomputed from
  one mask of ops/dropout.py, exactly);
- weights.params_from_jax carries res_fc, and a tree without it does not
  fit a residual model.

Inputs made with numpy from a seed; params drawn with numpy from the JAX
init's shapes and carried into the port by weights.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch.models import TaxoExpan as TorchTaxoExpan
from taxoexpan_torch.models.propagation import GAT
from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.tree import tree_leaves, tree_leaves_with_path
from taxoexpan_torch.tree import tree_unflatten
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from taxoexpan_tpu.models.propagation import GAT as JGAT

P, S = 3, 4
N = P + 1 + S
B = 6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine; restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _egonets(seed: int, din: int):
    """Features [B, N, din] (invalid slots zeroed; an empty and a full
    egonet first), ngp, nsib."""
    rng = np.random.default_rng(seed)
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.concatenate([np.arange(P)[None] < ngp[:, None],
                            np.ones((B, 1), bool),
                            np.arange(S)[None] < nsib[:, None]], axis=1)
    x = rng.normal(size=(B, N, din)).astype(np.float32) * valid[..., None]
    return x, ngp, nsib


def _draw(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.4).astype(a.dtype), tree)


def _grads_of(fn, tp: dict):
    """fn(params) -> a float32 tensor; its value and the grads of
    sum(value * cot) for a fixed cotangent."""
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(tp)]
    out = fn(tree_unflatten(tp, leaves))
    cot = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(out.shape)).astype(np.float32))
    grads = torch.autograd.grad((out * cot).sum(), leaves)
    return out.detach().numpy(), cot.numpy(), [g.numpy() for g in grads]


def test_gat_residual_matches_jax():
    """GAT (no positions), heads [2, 2, 1], residual: layer 1 through
    res_fc (8 -> 2 x 4), the final layer through the identity (8 -> 1 x
    8); the per-slot output and every param's grad against JAX's."""
    kw = dict(in_dim=6, hidden_dim=4, out_dim=8, num_layers=2,
              heads=[2, 2, 1], feat_drop=0.0, attn_drop=0.0)
    jg = JGAT(residual=True, **kw)
    tg = GAT(residual=True, **kw)
    jp = _draw(jax.eval_shape(jg.init, jax.random.PRNGKey(0)), 1)
    tp = params_from_jax(jp, tg.init(torch.Generator()))
    assert "res_fc" in tp["layers"][1] and "res_fc" not in tp["layers"][2]
    assert "res_fc" not in tp["layers"][0]
    x, ngp, nsib = _egonets(2, 6)
    t = [torch.from_numpy(a) for a in (x, ngp, nsib)]
    got, cot, tgrads = _grads_of(lambda p: tg.apply(
        p, *t, P, train=True, pool_readout=False), tp)

    @jax.jit
    def jax_side(p):
        def f(q):
            return jg.apply(q, x, ngp, nsib, P, rng=jax.random.PRNGKey(0),
                            train=True)
        out, vjp = jax.vjp(f, p)
        return out, vjp(jnp.asarray(cot))[0]

    want, jgrads = jax_side(jp)
    with torch.no_grad():
        evaluated = tg.apply(tp, *t, P, pool_readout=False)
    np.testing.assert_allclose(evaluated.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for g, w in zip(tgrads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def _concat_residual_models():
    """The composite PGAT (pos_mode "concat", WMR) of both packages with a
    residual propagation of the same widths, and one parameter tree."""
    arch = dict(in_dim=6, hidden_dim=4, out_dim=5, pos_dim=3, num_layers=1,
                heads=[2, 1], feat_drop=0.0, attn_drop=0.0, hidden_drop=0.0,
                out_drop=0.0, max_parents=P, expand_factor=S)
    prop = {k: arch[k] for k in ("in_dim", "hidden_dim", "out_dim",
                                 "num_layers", "heads", "pos_dim",
                                 "feat_drop", "attn_drop")}
    jm = JaxTaxoExpan("PGAT", "WMR", "BIM", kernel="xla", pos_mode="concat",
                      **arch)
    jm.propagate = JGAT(residual=True, pos_mode="concat", **prop)
    tm = TorchTaxoExpan("PGAT", "WMR", "BIM", pos_mode="concat", **arch)
    tm.propagate = GAT(residual=True, pos_mode="concat", **prop)
    jp = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 3)
    return jm, jp, tm, params_from_jax(jp, tm.init(torch.Generator()))


def test_pgat_concat_residual_matches_jax():
    """PGAT concat with a residual final layer (11 -> 1 x 5 through
    res_fc): the model's graph embeddings and scores (the per-slot final
    layer and the WMR readout over it), and every grad of the scores,
    pos_emb's included, against the JAX model's."""
    jm, jp, tm, tp = _concat_residual_models()
    assert "res_fc" in tp["propagate"]["layers"][1]
    x, ngp, nsib = _egonets(4, 6)
    qf = np.random.default_rng(5).normal(size=(B, 6)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, ngp, nsib, qf)]

    def port_scores(p):
        return tm.match(p, tm.encode(p, *t[:3], train=True), t[3])
    got, cot, tgrads = _grads_of(port_scores, tp)

    @jax.jit
    def jax_side(p):
        def f(q):
            hg = jm.encode(q, x, ngp, nsib, rng=jax.random.PRNGKey(0),
                           train=True)
            return jm.match(q, hg, qf)
        out, vjp = jax.vjp(f, p)
        return out, vjp(jnp.asarray(cot))[0]

    want, jgrads = jax_side(jp)
    with torch.no_grad():
        np.testing.assert_allclose(tm.match(tp, tm.encode(tp, *t[:3]), t[3])
                                   .numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    paths = [p for p, _ in tree_leaves_with_path(tp)]
    for path, g, w in zip(paths, tgrads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL,
                                   err_msg=str(path))
    pe0 = tgrads[paths.index(("propagate", "pos_emb", 0, "emb"))]
    assert np.abs(pe0).max() > 1e-4


def test_pgat_bias_residual_refused_by_both():
    """Residual PGAT layers in pos_mode "bias": the JAX package's res_fc
    [in_dim + pos_dim, H*Dh] meets an input without its pe columns and the
    product fails; the port refuses the stack with a ValueError naming
    the limitation."""
    kw = dict(in_dim=6, hidden_dim=4, out_dim=5, num_layers=1, heads=[2, 1],
              pos_dim=3, feat_drop=0.0, attn_drop=0.0)
    jg = JGAT(residual=True, pos_mode="bias", **kw)
    jp = _draw(jax.eval_shape(jg.init, jax.random.PRNGKey(0)), 1)
    x, ngp, nsib = _egonets(6, 6)
    with pytest.raises(TypeError, match="dot_general"):
        jax.eval_shape(lambda p: jg.apply(p, x, ngp, nsib, P,
                                          rng=jax.random.PRNGKey(0),
                                          train=False), jp)
    with pytest.raises(ValueError, match="pos_mode='concat'"):
        GAT(residual=True, pos_mode="bias", **kw)
    GAT(residual=True, pos_mode="bias", **dict(kw, pos_dim=0))


def test_residual_layer_drops_its_input_once():
    """A train-mode residual layer (feature and attention dropout 0.3): its
    output equals the kernel's plain train form on x times the layer's
    feature mask (ops/dropout.py, the feature stream of the layer's seed)
    plus that same masked x @ res_fc, exactly; and the mask drops about
    the rate's share of x."""
    kw = dict(in_dim=6, hidden_dim=4, out_dim=5, num_layers=1, heads=[2, 1],
              feat_drop=0.3, attn_drop=0.3)
    g = GAT(residual=True, **kw)
    params = g.init(torch.Generator().manual_seed(1))
    x, ngp, nsib = (torch.from_numpy(a) for a in _egonets(7, 6))
    h0 = gk.gat_layer_fwd_plain(x, *g.operands(params, 0, N, P)[0], ngp,
                                nsib, P, 2, out_alpha=0.01)
    ops, _ = g.operands(params, 1, N, P)
    seed = 1234
    with torch.no_grad():
        got = g._residual_layer(params["layers"][1], h0, ops, ngp, nsib, P,
                                1, seed=seed, feat_drop=0.3, attn_drop=0.3,
                                differentiable=True, need_dx=True)
    mask = dropout.slot_mask(seed, dropout.STREAM_FEAT, B, N, 8, 0.3)
    xd = h0 * mask
    want = gk.gat_layer_train_plain(xd, *ops, ngp, nsib, P, 1, seed=seed,
                                    attn_drop=0.3) \
        + xd @ params["layers"][1]["res_fc"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 0.15 < float((mask == 0).double().mean()) < 0.45
    # the whole stack in train mode draws the layer's seed from `gen`
    out = g.apply(params, x, ngp, nsib, P, train=True, pool_readout=False,
                  gen=torch.Generator().manual_seed(2))
    assert out.shape == (B, N, 5) and torch.isfinite(out).all()


def test_params_from_jax_carries_res_fc():
    """A JAX residual GAT's params cross into the port by key path, res_fc
    included; a tree without res_fc does not fit the residual model."""
    kw = dict(in_dim=6, hidden_dim=4, out_dim=5, num_layers=1, heads=[2, 1],
              pos_dim=3, pos_mode="concat")
    jp = _draw(jax.eval_shape(JGAT(residual=True, **kw).init,
                              jax.random.PRNGKey(0)), 2)
    template = GAT(residual=True, **kw).init(torch.Generator())
    tp = params_from_jax(jp, template)
    np.testing.assert_array_equal(tp["layers"][1]["res_fc"].numpy(),
                                  jp["layers"][1]["res_fc"])
    assert tp["layers"][1]["res_fc"].shape == (11, 5)
    plain = _draw(jax.eval_shape(JGAT(**kw).init, jax.random.PRNGKey(0)), 2)
    with pytest.raises(ValueError, match="res_fc"):
        params_from_jax(plain, template)
