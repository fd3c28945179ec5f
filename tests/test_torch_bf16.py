"""Port parity, the bf16 layers (compute_dtype "bfloat16"): the bf16 forms
of K1-K4 as their plain versions compute them, and the bf16 models, held
against the JAX package's Pallas path (`fused_gat_layer`,
`fused_gat_layer_pooled` and `TaxoExpan(kernel="pallas")` with bf16
operands, in interpret mode, jitted), which keeps the projection, the
softmax and the aggregation in float32 and rounds at the places the
port's bf16 kernels round.

Small sizes (B = 6 with an empty and a full egonet, N = 3 + 1 + 4, Din 10,
heads 1 and 2, Dh 5, pos 3); inputs made with numpy from a seed and handed
to both sides. Tolerances:
- bf16 results (a per-slot output, dx, dfc, dwa1, dwa2): one bf16 ulp
  elementwise, |got - want| <= 2**-7 |want| (+ 1e-6 for float32 noise
  around exact zeros): both sides multiply the same bf16 operands exactly
  and accumulate in float32 in another order, so a result can round to
  the neighbouring bf16 value;
- float32 results (the pools, the slot-bias and pe grads): 1e-5, float32
  sums in another order;
- the port's own compositions (projection + star pass against the plain
  layer): 1e-6 in float32, bf16 results equal;
- the models: see each test.
The JAX pe path needs input dropout; at rate 1e-9 both sides keep every
element with scale 1.0 (asserted), so it is the pe path at dropout 0."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch import losses as tlosses
from taxoexpan_torch.models import TaxoExpan as TorchTaxoExpan
from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import launch
from taxoexpan_torch.ops import star
from taxoexpan_torch.tree import tree_leaves, tree_unflatten
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import losses as jlosses
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from taxoexpan_tpu.ops.pallas_gat import (fused_gat_layer,
                                          fused_gat_layer_pooled)
from tests.test_torch_pooled import _inputs

P, S = 3, 4
N = P + 1 + S
B, DIN, DH, POS = 6, 10, 5, 3
ULP = dict(rtol=2 ** -7, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
PLAIN_TOL = dict(rtol=1e-6, atol=1e-6)
TINY_RATE = 1e-9
BF = torch.bfloat16
GRAD_NAMES = ("x", "fc", "wa1", "wa2", "bias_ft", "bias_a1", "bias_a2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def _pe_pack(heads: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * 0.3).astype(np.float32)
            for shape in ((N, POS), (POS, heads * DH), (POS, heads),
                          (POS, heads))]


def _bf16_ops(arrays):
    """Torch operands of a bf16 layer: x, fc, wa1, wa2 rounded to bf16, the
    slot biases float32, ngp / nsib int32."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [v.to(BF) for v in t[:4]] + t[4:]


# ------------------------------------------------------ layers against JAX

@pytest.mark.parametrize("pooled, heads, pe", [(False, 1, True),
                                               (True, 2, True)],
                         ids=["k1k2-h1-pe", "k3k4-h2-pe"])
def test_layer_matches_jax_pallas(pooled, heads, pe):
    """Forward and VJP of one bf16 layer (the per-slot layer with the fused
    leaky 0.01, or the pooled one) against the Pallas kernel it replaces,
    with non-zero slot biases and, with `pe`, the pe path. (The eval forms
    at dropout 0, per-slot with 2 heads and pooled with 1, are held to JAX
    inside the PGAT model below: its layer 0 and final layer.)"""
    arrays = _inputs(heads, seed=3 + heads)
    pe_np = _pe_pack(heads) if pe else None
    rate = TINY_RATE if pe else 0.0
    rng = np.random.default_rng(9)
    g_shape = (B, 3, DH) if pooled else (B, N, heads * DH)
    g_np = (rng.normal(size=g_shape) * 0.5).astype(np.float32)

    def jax_side(x, fc, wa1, wa2, bft, ba1, ba2, ngp, nsib, pe_pack, g):
        def layer(x, fc, wa1, wa2, bft, ba1, ba2, pe_pack):
            meta = (ngp, nsib, 0)
            if pooled:
                return fused_gat_layer_pooled(
                    x, fc, wa1, wa2, bft, ba1, ba2, pe_pack, meta, P, heads,
                    0.2, 0.0, rate, True)
            return fused_gat_layer(x, fc, wa1, wa2, bft, ba1, ba2, pe_pack,
                                   meta, P, heads, 0.2, 0.0, rate, 0.01, True)
        out, vjp = jax.vjp(layer, x, fc, wa1, wa2, bft, ba1, ba2, pe_pack)
        return out, vjp(g)

    j = [jnp.asarray(a) for a in arrays]
    j[:4] = [a.astype(jnp.bfloat16) for a in j[:4]]
    jg = jnp.asarray(g_np) if pooled else jnp.asarray(g_np, jnp.bfloat16)
    jpe = tuple(jnp.asarray(a) for a in pe_np) if pe else None
    want, want_grads = jax.jit(jax_side)(*j, jpe, jg)

    t = _bf16_ops(arrays)
    tpe = tuple(torch.from_numpy(a) for a in pe_np) if pe else None
    tg = torch.from_numpy(g_np)
    kw = dict(pe_pack=tpe, seed=7, feat_drop=rate)
    if pe:   # the tiny rate keeps every element at scale 1.0
        for stream, width in ((dropout.STREAM_FEAT, DIN),
                              (dropout.STREAM_PE, POS)):
            assert bool((dropout.slot_mask(7, stream, B, N, width,
                                           rate) == 1.0).all())
    if pooled:
        got = gk.gat_layer_pooled_fwd_train(*t, P, heads, **kw)
        grads = gk.gat_layer_pooled_bwd(tg, *t, P, heads, **kw)
        assert got.dtype == torch.float32
        _close(got, want, F32_TOL)
    else:
        got = gk.gat_layer_fwd_train(*t, P, heads, out_alpha=0.01, **kw)
        grads = gk.gat_layer_bwd(tg.to(BF), *t, P, heads, out_alpha=0.01,
                                 **kw)
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        _close(got, want.astype(jnp.float32), ULP)
    for name, w in zip(GRAD_NAMES, want_grads[:7]):
        low = name in ("x", "fc", "wa1", "wa2")
        assert grads[name].dtype == (BF if low else torch.float32), name
        _close(grads[name], w.astype(jnp.float32), ULP if low else F32_TOL)
    if pe:
        for name, w in zip(("pe", "wp", "wpa1", "wpa2"), want_grads[7]):
            assert grads[name].dtype == torch.float32
            _close(grads[name], w, F32_TOL)


# ------------------------------------------- the port's own compositions

@pytest.mark.parametrize("pooled, bits", [(False, 32), (False, 8),
                                          (True, 32), (True, 8)])
def test_train_forms_compose(pooled, bits):
    """Dropout on (features, the pe path, attention) with 32- or 8-bit
    masks, store form: the projection (`gat_projection`, the plain version
    on CPU tensors) and the star pass over it against the plain bf16
    layer; the projection is float32 and the masks bite."""
    heads = 2
    t = _bf16_ops(_inputs(heads, seed=1))
    tpe = tuple(torch.from_numpy(a) for a in _pe_pack(heads))
    kw = dict(seed=5, dropout_bits=bits)
    proj = gk.gat_projection(*t[:7], pe_pack=tpe, feat_drop=0.25, **kw)
    assert proj.dtype == torch.float32
    assert proj.shape == (B, N, heads * DH + 2 * heads)
    want, want_attn = gk.gat_layer_train_plain(
        *t, P, heads, pe_pack=tpe, feat_drop=0.25, attn_drop=0.3,
        pooled=pooled, store_attn=True, out_alpha=None if pooled else 0.01,
        **kw)
    if pooled:
        got, attn = gk.gat_pooled_star(proj, t[7], t[8], P, heads,
                                       attn_drop=0.3, store=True, **kw)
        _close(got, want, PLAIN_TOL)
    else:
        hd = heads * DH
        got, attn = gk._star_plain(
            proj[..., :hd], proj[..., hd:hd + heads], proj[..., hd + heads:],
            t[7], t[8], P, heads, 5, 0.3, 0.01, False, bits, None)
        assert want.dtype == BF
        assert torch.equal(got.to(BF), want)
    _close(attn, want_attn, PLAIN_TOL)
    eval_proj = gk.gat_projection(*t[:7])
    assert not torch.allclose(eval_proj, proj)


def test_stored_backward_matches_recompute():
    """The bf16 plain backward fed the store form's softmax weights gives
    the recompute backward's grads (K7a in bf16), dropout and the pe path
    on, 8-bit masks."""
    heads = 2
    t = _bf16_ops(_inputs(heads, seed=4))
    tpe = tuple(torch.from_numpy(a) for a in _pe_pack(heads))
    kw = dict(pe_pack=tpe, seed=3, feat_drop=0.2, attn_drop=0.2,
              dropout_bits=8, out_alpha=0.01)
    out, attn = gk.gat_layer_fwd_train_store(*t, P, heads, **kw)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)
                    ).to(BF)
    stored = gk.gat_layer_bwd_stored(g, *t, P, heads, attn, **kw)
    recompute = gk.gat_layer_bwd(g, *t, P, heads, **kw)
    for name, v in recompute.items():
        tol = ULP if v.dtype == BF else PLAIN_TOL
        _close(stored[name], v, tol)


def test_check_operands_takes_bf16_together():
    """The kernels' operand check: x, fc, wa1, wa2 all float32 or all bf16;
    a mix raises, and so does bf16 anywhere else (the slot biases, a K5
    operand)."""
    x = torch.zeros(2, N, DIN)
    fc, wa = torch.zeros(DIN, 4), torch.zeros(DIN, 2)
    bias = torch.zeros(N, 4)
    low = ("fc", "wa1", "wa2")

    def shapes(fc, wa1, bias):
        return {"fc": (fc, (DIN, 4)), "wa1": (wa1, (DIN, 2)),
                "bias_ft": (bias, (N, 4))}
    launch.check_operands(x, shapes(fc, wa, bias), low)
    launch.check_operands(x.to(BF), shapes(fc.to(BF), wa.to(BF), bias), low)
    for args in ((x.to(BF), fc, wa.to(BF), bias),
                 (x, fc.to(BF), wa.to(BF), bias),
                 (x.to(BF), fc.to(BF), wa.to(BF), bias.to(BF))):
        with pytest.raises(TypeError, match="the kernel takes"):
            launch.check_operands(args[0], shapes(*args[1:]), low)
    with pytest.raises(TypeError, match="float32"):    # no bf16 K5 form
        launch.check_operands(x.to(BF), {"w": (fc.to(BF), (DIN, 4))})


# ------------------------------------------------------------- the models

ARCH = dict(in_dim=16, hidden_dim=8, out_dim=8, pos_dim=4, num_layers=1,
            heads=[2, 1], feat_drop=0.0, attn_drop=0.0, max_parents=P,
            expand_factor=S)
G, C = 3, 2      # groups x candidates: B = 6 egonets


def _egonets(seed: int, d: int = 16):
    rng = np.random.default_rng(seed)
    ngp = rng.integers(0, P + 1, (G * C,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (G * C,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.concatenate([np.arange(P)[None] < ngp[:, None],
                            np.ones((G * C, 1), bool),
                            np.arange(S)[None] < nsib[:, None]], axis=1)
    x = rng.normal(size=(G * C, N, d)).astype(np.float32) * valid[..., None]
    qf = rng.normal(size=(G * C, d)).astype(np.float32)
    return x, ngp, nsib, qf


def _carried_over(jm, tm, seed: int):
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tm.init(torch.Generator().manual_seed(0)))
    return jp, tp


def test_pgat_bf16_model_matches_jax_pallas():
    """PGAT/WMR/BIM with the raw channel, compute_dtype "bfloat16", dropout
    0: graph embeddings, scores, the InfoNCE loss of a train step and every
    param's grad against the JAX model with kernel="pallas", params carried
    over by weights.py. Tolerances: hg and scores 2e-3 of their largest
    value, the loss 1e-4 relative, each grad 5e-3 of its leaf's largest
    value: both sides round layer 0's output to bf16 from float32 values
    summed in another order, so an element can land one bf16 ulp (2**-8
    relative) apart and move what follows it by about that much. The raw
    channel stays float32 on both sides (the reference's hg is float32),
    equal to 1e-6."""
    arch = dict(ARCH, raw_channel=True)
    jm = JaxTaxoExpan("PGAT", "WMR", "BIM", kernel="pallas",
                      compute_dtype="bfloat16", **arch)
    tm = TorchTaxoExpan("PGAT", "WMR", "BIM", compute_dtype="bfloat16",
                        **arch)
    jp, tp = _carried_over(jm, tm, 5)
    x, ngp, nsib, qf = _egonets(6)
    labels = np.zeros((G, C), np.float32)
    labels[:, 0] = 1.0
    mask = np.ones((G, C), bool)

    @jax.jit
    def jax_side(params):
        def loss_fn(p):
            hg = jm.encode(p, x, ngp, nsib, rng=jax.random.PRNGKey(0),
                           train=True)
            s = jm.match(p, hg, qf).reshape(G, C)
            return jlosses.info_nce_loss(s, labels, mask), (hg, s)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jloss, (jhg, js)), jgrads = jax_side(jp)
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    t = [torch.from_numpy(a) for a in (x, ngp, nsib, qf)]
    hg = tm.encode(params, *t[:3], train=True)
    s = tm.match(params, hg, t[3]).reshape(G, C)
    loss = tlosses.info_nce_loss(s, torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, leaves)
    assert hg.dtype == s.dtype == torch.float32
    for got, want in ((hg, jhg), (s, js)):
        want = np.asarray(want)
        _close(got.detach(), want,
               dict(rtol=0, atol=2e-3 * float(np.abs(want).max())))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    l_dim = tm.readout.l_dim     # the raw channel: float32 on both sides
    _close(hg[:, l_dim:], np.asarray(jhg)[:, l_dim:], PLAIN_TOL)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        _close(got, want, dict(rtol=0,
                               atol=5e-3 * float(np.abs(want).max())))


def test_bf16_close_to_f32_and_grads_finite():
    """tests/test_bf16.py's contract through the port: bf16 scores within
    0.05 of the float32 model's mean |score|, float32 out; with dropout on,
    every grad of a bf16 train forward finite (LBM matcher)."""
    kw = dict(ARCH, pos_dim=4)
    m32 = TorchTaxoExpan("PGAT", "WMR", "BIM", **kw)
    m16 = TorchTaxoExpan("PGAT", "WMR", "BIM", compute_dtype="bfloat16",
                         **kw)
    params = m32.init(torch.Generator().manual_seed(0))
    x, ngp, nsib, qf = (torch.from_numpy(a) for a in _egonets(1))
    with torch.no_grad():
        s32 = m32.match(params, m32.encode(params, x, ngp, nsib), qf)
        s16 = m16.match(params, m16.encode(params, x, ngp, nsib), qf)
    assert s16.dtype == torch.float32
    scale = float(s32.abs().mean()) + 1e-6
    assert float((s32 - s16).abs().max()) / scale < 0.05
    assert not torch.equal(s32, s16)          # the bf16 path ran

    m16 = TorchTaxoExpan("PGAT", "WMR", "LBM", compute_dtype="bfloat16",
                         **dict(kw, feat_drop=0.1, attn_drop=0.1))
    params = m16.init(torch.Generator().manual_seed(0))
    leaves = [v.requires_grad_(True) for v in tree_leaves(params)]
    s = m16.match(params, m16.encode(params, x, ngp, nsib, train=True,
                                     gen=torch.Generator().manual_seed(2)),
                  qf)
    for grad in torch.autograd.grad((s ** 2).sum(), leaves):
        assert grad.dtype == torch.float32 and torch.isfinite(grad).all()


def test_pgcn_ignores_compute_dtype():
    """PGCN with compute_dtype "bfloat16" runs float32, as the JAX package's
    (its TaxoExpan passes no dtype to GCN): scores and train-form grads
    equal the float32 model's bit for bit."""
    kw = dict(ARCH, feat_drop=0.1, hidden_drop=0.1, out_drop=0.1)
    m32 = TorchTaxoExpan("PGCN", "WMR", "BIM", **kw)
    m16 = TorchTaxoExpan("PGCN", "WMR", "BIM", compute_dtype="bfloat16", **kw)
    params = m32.init(torch.Generator().manual_seed(0))
    x, ngp, nsib, qf = (torch.from_numpy(a) for a in _egonets(2))
    results = []
    for m in (m32, m16):
        leaves = [v.detach().requires_grad_(True)
                  for v in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        with torch.no_grad():
            s_eval = m.match(p, m.encode(p, x, ngp, nsib), qf)
        s = m.match(p, m.encode(p, x, ngp, nsib, train=True,
                                gen=torch.Generator().manual_seed(3)), qf)
        results.append((s_eval, s.detach(),
                        torch.autograd.grad(s.sum(), leaves)))
    (e32, s32, g32), (e16, s16, g16) = results
    assert torch.equal(e32, e16) and torch.equal(s32, s16)
    assert all(torch.equal(a, b) for a, b in zip(g32, g16))


def test_mtl_bf16_forward_matches_jax_pallas():
    """The MTL configuration's propagation and heads (PATR + PMLP, one
    WMR/BIM auxiliary head: the per-slot final layer, the head mean in
    bf16 then float32) in bf16 at small widths: the scores of every head
    against the JAX model with kernel="pallas". Tolerance 2e-3 of the
    largest score (one bf16 ulp of a layer output, as in the PGAT test)."""
    arch = dict(ARCH, hidden_dim=6, out_dim=6, heads=[2, 1],
                attention_dim=5, aux_heads=[{"readout": "WMR",
                                             "matcher": "BIM"}])
    jm = JaxTaxoExpan("PGAT", "PATR", "PMLP", kernel="pallas",
                      compute_dtype="bfloat16", **arch)
    tm = TorchTaxoExpan("PGAT", "PATR", "PMLP", compute_dtype="bfloat16",
                        **arch)
    jp, tp = _carried_over(jm, tm, 8)
    x, ngp, nsib, qf = _egonets(9)

    @jax.jit
    def jax_side(params):
        h = jm.propagate.apply(params["propagate"], x, ngp, nsib, P,
                               rng=jax.random.PRNGKey(0), train=False)
        heads = [(jm.readout, jm.matcher, params["readout"],
                  params["match"])]
        heads += [(rd, mt, hp["readout"], hp["match"]) for (rd, mt), hp in
                  zip(jm.aux_heads, params["aux"])]
        return [mt.apply(mp, rd.apply(rp, h, ngp, nsib, P), qf)
                for rd, mt, rp, mp in heads]

    want = jax_side(jp)
    t = [torch.from_numpy(a) for a in (x, ngp, nsib, qf)]
    with torch.no_grad():
        h = tm._trunk(tp, *t[:3], None, False)
        assert h.dtype == torch.float32
        heads = [(tm.readout, tm.matcher, tp["readout"], tp["match"])]
        heads += [(rd, mt, hp["readout"], hp["match"]) for (rd, mt), hp in
                  zip(tm.aux_heads, tp["aux"])]
        got = [mt.apply(mp, rd.apply(rp, h, *t[1:3], P), t[3])
               for rd, mt, rp, mp in heads]
    assert len(got) == 2
    for a, b in zip(got, want):
        b = np.asarray(b)
        _close(a, b, dict(rtol=0, atol=2e-3 * float(np.abs(b).max())))


def test_build_model_takes_bfloat16():
    """config.mag.json with compute_dtype "bfloat16" builds bf16 GAT
    layers; with PGCN the key is accepted and ignored; pos_mode="concat"
    builds bf16 GAT layers too, and a pos_mode the JAX package refuses
    raises."""
    with open("configs/config.mag.json") as fin:
        arch = json.load(fin)["arch"]
    args = dict(arch["args"], compute_dtype="bfloat16")
    model = tbuilders.build_model({"args": args}, max_parents=P,
                                  expand_factor=S)
    assert model.propagate.dtype == torch.bfloat16
    assert model.compute_dtype == torch.bfloat16
    pgcn = tbuilders.build_model(
        {"args": dict(args, propagation_method="PGCN")}, max_parents=P,
        expand_factor=S)
    assert not hasattr(pgcn.propagate, "dtype")
    concat = tbuilders.build_model({"args": dict(args, pos_mode="concat")},
                                   max_parents=P, expand_factor=S)
    assert concat.propagate.pos_mode == "concat"
    assert concat.propagate.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="pos_mode must be bias|concat"):
        tbuilders.build_model({"args": dict(args, pos_mode="sum")},
                              max_parents=P, expand_factor=S)


# ------------------------------------------------ the float32 path, kept

def _f32_projection_parent(x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2,
                           pe_pack, seed, feat_drop, bits):
    """The float32 projection as the plain versions computed it before the
    bf16 forms existed (gat_kernels._projection_plain, float32 branch)."""
    b, n, din = x.shape
    hd = fc.shape[1]
    if feat_drop > 0:
        x = x * dropout.slot_mask(seed, dropout.STREAM_FEAT, b, n, din,
                                  feat_drop, None, bits)
    ft = (x.reshape(b * n, din) @ fc).reshape(b, n, hd) + bias_ft[None]
    a1 = x @ wa1 + bias_a1[None]
    a2 = x @ wa2 + bias_a2[None]
    if pe_pack is not None:
        pe, wp, wpa1, wpa2 = pe_pack
        pos = pe.shape[1]
        pm = pe[None] * dropout.slot_mask(seed, dropout.STREAM_PE, b, n, pos,
                                          feat_drop, None, bits)
        ft = ft + (pm.reshape(b * n, pos) @ wp).reshape(b, n, hd)
        a1 = a1 + pm @ wpa1
        a2 = a2 + pm @ wpa2
    return ft, a1, a2


@pytest.mark.parametrize("pooled", [False, True])
def test_float32_plain_versions_unchanged(pooled):
    """K1-K4's float32 plain versions at test_torch_pooled.py's inputs
    equal, bit for bit, the float32 formulas they computed before the bf16
    forms were added: the eval forward (ft / a1 / a2 and ops/star.py's
    aggregation), the train form with dropout and the pe path, and its
    backward (autograd through that train form)."""
    heads = 2
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in _inputs(heads, seed=1)]
    tpe = tuple(torch.from_numpy(a) for a in _pe_pack(heads))
    b = t[0].shape[0]

    ft, a1, a2 = _f32_projection_parent(*t[:7], None, 0, 0.0, 32)
    out = star.gat_attention_aggregate(
        ft.reshape(b, N, heads, DH), a1, a2, t[7], t[8], P,
        leaky_alpha=gk.LEAKY_ALPHA, mask_output=pooled)
    if pooled:
        hm = out.mean(dim=2)
        want = torch.stack([hm[:, :P].sum(dim=1), hm[:, P],
                            hm[:, P + 1:].sum(dim=1)], dim=1)
        got = gk.gat_layer_pooled_fwd_plain(*t, P, heads)
    else:
        want = out.reshape(b, N, -1)
        want = torch.where(want >= 0, want, 0.01 * want)
        got = gk.gat_layer_fwd_plain(*t, P, heads, out_alpha=0.01)
    assert got.dtype == torch.float32 and torch.equal(got, want)

    kw = dict(seed=5, feat_drop=0.25, attn_drop=0.3, dropout_bits=32)
    leaves = [v.detach().requires_grad_(True) for v in t[:7] + list(tpe)]
    with torch.enable_grad():
        ft, a1, a2 = _f32_projection_parent(*leaves[:7], tuple(leaves[7:]),
                                            5, 0.25, 32)
        want, _ = gk._star_plain(ft, a1, a2, t[7], t[8], P, heads, 5, 0.3,
                                 None if pooled else 0.01, pooled, 32, None)
        g = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
        want_grads = torch.autograd.grad(want, leaves, g)
    got = gk.gat_layer_train_plain(*t, P, heads, pe_pack=tpe, pooled=pooled,
                                   out_alpha=None if pooled else 0.01, **kw)
    assert torch.equal(got, want.detach())
    grads = gk.gat_layer_bwd_plain(g, *t, P, heads, pe_pack=tpe,
                                   pooled=pooled,
                                   out_alpha=None if pooled else 0.01, **kw)
    for name, w in zip(GRAD_NAMES + ("pe", "wp", "wpa1", "wpa2"),
                       want_grads):
        assert grads[name].dtype == torch.float32
        assert torch.equal(grads[name], w), name
