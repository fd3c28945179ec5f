"""Port parity, training ops: the differentiable star-GAT layers of
taxoexpan_torch.ops.gat_kernels (their CPU path, the plain versions of K1/K3
train forms and K2/K4) against jax.vjp of the Pallas kernels they replace
(interpret mode), the pe-dropout path against a JAX concat-input reference
fed the port's own masks, and the dropout generator.

Inputs are made with numpy from a seed and handed to both sides; the JAX
side is jitted. Gradient tolerance rtol 1e-3 / atol 1e-4 (the template of
tests/test_pallas_gat.py: float32, sums in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_tpu.ops.pallas_gat import (_tile_attention, fused_gat_layer,
                                          fused_gat_layer_pooled)

GTOL = dict(rtol=1e-3, atol=1e-4)
P, S = 3, 8
N = P + 1 + S
HEADS, DH, DIN, POS = 2, 4, 6, 5
B = 8
NAMES = ("x", "fc", "wa1", "wa2", "bias_ft", "bias_a1", "bias_a2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer_inputs(rng, heads=HEADS):
    """x (invalid slots zeroed as gather_feats leaves them; the first
    egonets empty and full), fc, folded attention weights and non-zero slot
    biases (the pos-bias split)."""
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.concatenate([np.arange(P)[None] < ngp[:, None],
                            np.ones((B, 1), bool),
                            np.arange(S)[None] < nsib[:, None]], axis=1)
    x = rng.normal(size=(B, N, DIN)).astype(np.float32) * valid[..., None]
    w = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    return (x, w(DIN, heads * DH), w(DIN, heads), w(DIN, heads),
            w(N, heads * DH), w(N, heads), w(N, heads), ngp, nsib)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**GTOL, **tol})


def _port_grads(fn, t, g, **kw):
    leaves = [a.clone().requires_grad_(True) for a in t[:7]]
    out = fn(*leaves, t[7], t[8], P, HEADS, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g),
                                allow_unused=True)
    return out.detach(), grads


@pytest.mark.parametrize("need_dx", [True, False])
def test_k2_function_matches_jax_vjp(rng, need_dx):
    arrays = _layer_inputs(rng)
    g = rng.normal(size=(B, N, HEADS * DH)).astype(np.float32)

    @jax.jit
    def jax_vjp(diff, ngp, nsib, cot):
        f = lambda *d: fused_gat_layer(  # noqa: E731
            *d, None, (ngp, nsib, 0), P, HEADS, 0.2, 0.0, 0.0, 0.01, True,
            need_dx)
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(cot)

    want_out, want = jax_vjp(tuple(jnp.asarray(a) for a in arrays[:7]),
                             arrays[7], arrays[8], jnp.asarray(g))
    t = _torch(arrays)
    out, got = _port_grads(gk.gat_layer, t, g, out_alpha=0.01,
                           need_dx=need_dx)
    _close(out, want_out, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, got, want):
        if name == "x" and not need_dx:
            continue
        _close(a, b, err_msg=name)


def test_k4_function_matches_jax_vjp(rng):
    arrays = _layer_inputs(rng)
    g = rng.normal(size=(B, 3, DH)).astype(np.float32)

    @jax.jit
    def jax_vjp(diff, ngp, nsib, cot):
        f = lambda *d: fused_gat_layer_pooled(  # noqa: E731
            *d, None, (ngp, nsib, 0), P, HEADS, 0.2, 0.0, 0.0, True, True)
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(cot)

    want_out, want = jax_vjp(tuple(jnp.asarray(a) for a in arrays[:7]),
                             arrays[7], arrays[8], jnp.asarray(g))
    out, got = _port_grads(gk.gat_layer_pooled, _torch(arrays), g)
    _close(out, want_out, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, err_msg=name)


# ----------------------------------------------- the pe-dropout path

FEAT_DROP, ATTN_DROP, SEED = 0.4, 0.3, 777


def _jax_concat_reference(x, pe, fc_full, al, ar, ngp, nsib, feat_mask,
                          pe_mask, attn_masks, pooled):
    """The reference's layer over the concatenated input [x | pe] with the
    port's masks: dropout over the concat, ft = inp @ W, a = ft . attn, the
    JAX kernel's own `_tile_attention` (masks after the softmax)."""
    inp = jnp.concatenate([x * feat_mask, pe[None] * pe_mask], axis=-1)
    ft = (inp @ fc_full).reshape(B, N, HEADS, DH)
    a1, a2 = (ft * al).sum(-1), (ft * ar).sum(-1)
    masks = [tuple(m[..., h] for m in attn_masks) for h in range(HEADS)]
    outs = []
    for h in range(HEADS):
        at = _tile_attention(a1[..., h], a2[..., h], ngp[:, None], P, S, 0.2,
                             masks, h)
        fth = ft[:, :, h]
        out_gp = at["w_gp"][..., None] * fth[:, :P]
        out_anchor = ((at["w_gp2a"][..., None] * fth[:, :P]).sum(1)
                      + at["w_selfa"] * fth[:, P])
        out_sib = (at["w_s0"][..., None] * fth[:, P:P + 1]
                   + at["w_s1"][..., None] * fth[:, P + 1:])
        if pooled:
            sib_f = (jnp.arange(S)[None] < nsib[:, None]).astype(jnp.float32)
            outs.append(jnp.stack([
                (out_gp * at["gp_mask"][..., None]).sum(1), out_anchor,
                (out_sib * sib_f[..., None]).sum(1)], axis=1))
        else:
            outs.append(jnp.concatenate(
                [out_gp, out_anchor[:, None], out_sib], axis=1))
    if pooled:
        return sum(outs) / HEADS
    return jnp.stack(outs, axis=2).reshape(B, N, HEADS * DH)


def _port_pe_layer(x, pe, fc_full, al, ar, ngp, nsib, pooled):
    """The way PGAT calls the layer in train mode: fc split at DIN, the
    attention folded into wa, pe as pe_pack, zero slot biases."""
    w_heads = fc_full.reshape(-1, HEADS, DH)
    wa1 = torch.einsum("ihd,hd->ih", w_heads, al)
    wa2 = torch.einsum("ihd,hd->ih", w_heads, ar)
    zeros_ft, zeros_a = torch.zeros(N, HEADS * DH), torch.zeros(N, HEADS)
    kw = dict(pe_pack=(pe, fc_full[DIN:], wa1[DIN:], wa2[DIN:]), seed=SEED,
              feat_drop=FEAT_DROP, attn_drop=ATTN_DROP)
    ops = (x, fc_full[:DIN], wa1[:DIN], wa2[:DIN], zeros_ft, zeros_a,
           zeros_a, ngp, nsib, P, HEADS)
    if pooled:
        return gk.gat_layer_pooled(*ops, **kw)
    return gk.gat_layer(*ops, **kw)


@pytest.mark.parametrize("pooled", [False, True])
def test_pe_dropout_matches_jax_concat_reference(rng, pooled):
    x, *_, ngp, nsib = _layer_inputs(rng)
    pe = rng.normal(size=(N, POS)).astype(np.float32)
    fc_full = (rng.normal(size=(DIN + POS, HEADS * DH)) * 0.3).astype(
        np.float32)
    al, ar = ((rng.normal(size=(HEADS, DH)) * 0.3).astype(np.float32)
              for _ in range(2))
    feat_mask = dropout.slot_mask(SEED, dropout.STREAM_FEAT, B, N, DIN,
                                  FEAT_DROP).numpy()
    pe_mask = dropout.slot_mask(SEED, dropout.STREAM_PE, B, N, POS,
                                FEAT_DROP).numpy()
    attn = [m.numpy() for m in dropout.attention_masks(SEED, B, P, S, HEADS,
                                                       ATTN_DROP)]
    g = rng.normal(size=(B, 3, DH) if pooled else (B, N, HEADS * DH)
                   ).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=0)
    def jax_vjp(pooled, diff, ngp, nsib, masks, cot):
        f = lambda *d: _jax_concat_reference(  # noqa: E731
            *d, ngp, nsib, *masks, pooled)
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(cot)

    want_out, want = jax_vjp(
        pooled, tuple(jnp.asarray(a) for a in (x, pe, fc_full, al, ar)),
        jnp.asarray(ngp), jnp.asarray(nsib),
        (jnp.asarray(feat_mask), jnp.asarray(pe_mask),
         tuple(jnp.asarray(m) for m in attn)), jnp.asarray(g))
    leaves = [a.requires_grad_(True) for a in _torch((x, pe, fc_full, al,
                                                      ar))]
    out = _port_pe_layer(*leaves, *_torch((ngp, nsib)), pooled)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _close(out.detach(), want_out, rtol=1e-4, atol=1e-5)
    for name, a, b in zip(("x", "pe", "fc_full", "attn_l", "attn_r"), got,
                          want):
        _close(a, b, err_msg=name)


# ------------------------------------------------- the dropout generator

def test_golden_bits():
    keys = [k for k, _ in dropout.GOLDEN_BITS]
    want = [v for _, v in dropout.GOLDEN_BITS]
    assert [dropout.bits_int(*k) for k in keys] == want
    for (seed, stream, row, col), v in dropout.GOLDEN_BITS:
        got = dropout.bits(seed, stream, torch.tensor([row]),
                           torch.tensor([col]))
        assert int(got[0]) == v


def test_bits_match_python_integers(rng):
    rows = rng.integers(0, 2 ** 32, 500, dtype=np.int64)
    cols = rng.integers(0, 2 ** 32, 500, dtype=np.int64)
    got = dropout.bits_plain(99, 3, torch.from_numpy(rows),
                             torch.from_numpy(cols)).tolist()
    assert got == [dropout.bits_int(99, 3, int(r), int(c))
                   for r, c in zip(rows, cols)]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_unbiased_and_streams_independent(rate):
    b, n, w = 32, 64, 250
    m = dropout.slot_mask(5, dropout.STREAM_FEAT, b, n, w, rate)
    k = (m > 0).double()
    count = m.numel()
    sigma = (rate * (1 - rate) / count) ** 0.5
    assert abs(k.mean().item() - (1 - rate)) < 4 * sigma
    # kept values carry 1 / (1 - rate): the mask's mean is 1 (unbiased)
    assert abs(m.double().mean().item() - 1.0) < 4 * sigma / (1 - rate)
    assert set(torch.unique(m).tolist()) == {0.0,
                                             np.float32(1 / (1 - rate))}
    # other streams, other seeds and neighbouring rows / columns are
    # uncorrelated with this one
    others = [dropout.slot_mask(5, dropout.STREAM_PE, b, n, w, rate),
              dropout.slot_mask(6, dropout.STREAM_FEAT, b, n, w, rate),
              torch.roll(m, 1, dims=1), torch.roll(m, 1, dims=2)]
    for o in others:
        corr = np.corrcoef(k.flatten().numpy(),
                           (o > 0).double().flatten().numpy())[0, 1]
        assert abs(corr) < 4 / count ** 0.5
    a = dropout.attention_masks(5, 512, P, S, HEADS, rate)
    assert [tuple(t.shape) for t in a] == [(512, P, HEADS), (512, 1, HEADS),
                                           (512, S, HEADS), (512, S, HEADS),
                                           (512, P, HEADS)]
    assert not torch.equal(a[2][..., 0], a[3][..., 0])
    assert not torch.equal(a[2][..., 0], a[2][..., 1])


def test_backward_replays_the_forward_masks(rng):
    """The Function's backward regenerates the forward's masks from the
    seed: its grads equal autograd through the plain train form, and a
    different seed gives other outputs."""
    arrays = _layer_inputs(rng)
    g = rng.normal(size=(B, N, HEADS * DH)).astype(np.float32)
    t = _torch(arrays)
    kw = dict(seed=11, feat_drop=0.3, attn_drop=0.3, out_alpha=0.01)
    out, got = _port_grads(gk.gat_layer, t, g, **kw)
    want_out, want = _port_grads(gk.gat_layer_train_plain, t, g, **kw)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = gk.gat_layer(*t[:9], P, HEADS, **dict(kw, seed=12))
    assert not torch.equal(other, out)
    # the dropout bits depend on the element's indices only: egonet 3 of
    # this batch sees the masks of row 3 whatever the batch around it
    part = gk.gat_layer_train_plain(*[a[:4] for a in t[:1]], *t[1:7],
                                    t[7][:4], t[8][:4], P, HEADS, **kw)
    torch.testing.assert_close(part, out[:4], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [32, 8])
def test_projection_plain_matches_float64_reference(rng, bits):
    """`gat_projection` on the CPU (its plain version, which the card test
    holds the 3xTF32 kernel to) equals [x*m | pe*m_pe] @ [fc | wa1 | wa2;
    wp | wpa1 | wpa2] + the slot biases, computed in float64 with numpy
    from the same masks."""
    arrays = _layer_inputs(rng)
    t = _torch(arrays)
    pe = [(rng.normal(size=s) * 0.3).astype(np.float32)
          for s in ((N, POS), (POS, HEADS * DH), (POS, HEADS), (POS, HEADS))]
    got = gk.gat_projection(*t[:7], pe_pack=tuple(_torch(pe)), seed=5,
                            feat_drop=0.3, dropout_bits=bits)
    m = dropout.slot_mask(5, dropout.STREAM_FEAT, B, N, DIN, 0.3,
                          torch.device("cpu"), bits).numpy()
    m_pe = dropout.slot_mask(5, dropout.STREAM_PE, B, N, POS, 0.3,
                             torch.device("cpu"), bits).numpy()
    xcat = np.concatenate([arrays[0] * m, pe[0][None] * m_pe], axis=-1)
    w = np.concatenate([np.concatenate(arrays[1:4], axis=1),
                        np.concatenate(pe[1:], axis=1)], axis=0)
    bias = np.concatenate(arrays[4:7], axis=1)
    want = xcat.astype(np.float64) @ w.astype(np.float64) + bias
    assert got.shape == (B, N, HEADS * DH + 2 * HEADS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
