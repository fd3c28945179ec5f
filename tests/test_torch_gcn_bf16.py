"""Port parity, the bf16 form of the star-GCN layer (K5 with x in bf16): its
plain versions against the JAX package's `fused_gcn_layer` with x and w in
bf16 (interpret mode, jitted, dropout 0): the eval forward, and the
backward with need_dx on and off, with and without the activation; the
train form (feature and pe dropout) against a float64 reference built from
the port's own masks (JAX's dropout bits are platform-specific); the
kernels' operand check refusing a bf16 x beside a float32 w; and the
float32 plain versions, bit for bit, as they were before the bf16 form.

Small sizes (B = 6 with an empty and a full egonet, N = 3 + 1 + 4, Din 10
(not a multiple of 8), Dout 12, pos 3); inputs made with numpy from a seed
and handed to both sides. Tolerances:
- bf16 results (the output, dx, dW) against JAX: one bf16 ulp
  elementwise, |got - want| <= 2**-7 |want| + 1e-6: both sides multiply
  the same bf16 operands exactly and sum in float32 in another order, so
  a result can round to the neighbouring bf16 value;
- float32 results (db, d z_bias) against JAX: 1e-5, float32 sums in
  another order;
- against the float64 reference: the output one bf16 ulp plus 1e-5 (the
  float32 sums before its rounding); the bf16 grads 2**-6 relative plus
  2**-8 of the grad's largest value (dz rounded to bf16 from float32 on
  one side and float64 on the other, so an element of dz may sit one ulp
  apart before the sums over rows), the float32 grads 1e-5 relative plus
  1e-6 of the grad's largest value."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gcn_kernels as ck
from taxoexpan_torch.ops import star
from taxoexpan_tpu.ops.pallas_gcn import fused_gcn_layer

P, S = 3, 4
N = P + 1 + S
B, DIN, DOUT, POS = 6, 10, 12, 3
BF = torch.bfloat16
ULP = dict(rtol=2 ** -7, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed: int = 0):
    """numpy inputs of one layer: x (invalid slots zeroed), W_h, b, a
    non-zero z_bias, ngp / nsib with an empty and a full egonet first, the
    pe rows and W_p."""
    rng = np.random.default_rng(seed)
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.concatenate([np.arange(P)[None] < ngp[:, None],
                            np.ones((B, 1), bool),
                            np.arange(S)[None] < nsib[:, None]], axis=1)
    f32 = lambda *shape: (rng.normal(size=shape) * 0.3).astype(  # noqa
        np.float32)
    x = f32(B, N, DIN) / 0.3 * valid[..., None]
    return (x, f32(DIN, DOUT), f32(DOUT), f32(N, DOUT), ngp, nsib,
            f32(N, POS) / 0.3, f32(POS, DOUT))


def _bf16_ops(arrays):
    """Torch operands: x and W_h rounded to bf16, the rest float32 / int32."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [t[0].to(BF), t[1].to(BF)] + t[2:]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol, err_msg=name)


@functools.partial(jax.jit, static_argnames=("alpha", "need_dx"))
def _jax_layer(x, w, b, zb, ngp, nsib, cot, alpha, need_dx):
    """fused_gcn_layer in interpret mode at dropout 0 with x and w in bf16,
    and its VJP for x, W_h, b and z_bias."""
    def f(x, w, b, zb):
        return fused_gcn_layer(x, w, b, zb, None, (ngp, nsib, 0), P, alpha,
                               0.0, True, need_dx)
    out, vjp = jax.vjp(f, x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       b, zb)
    return out, vjp(cot.astype(jnp.bfloat16))


@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_bf16_plain_versions_match_jax(alpha):
    """Dropout 0: the eval forward and the backward (need_dx on and off) of
    the bf16 plain versions against the Pallas kernel they replace; every
    output in the reference's dtype."""
    arrays = _inputs(seed=1)
    cot = np.random.default_rng(2).normal(size=(B, N, DOUT)).astype(
        np.float32)
    x, w, b, zb, ngp, nsib = _bf16_ops(arrays)[:6]
    g = torch.from_numpy(cot).to(BF)
    got = ck.gcn_layer_fwd(x, w, b, zb, ngp, nsib, P, alpha)
    assert got.dtype == BF
    for need_dx in (True, False):
        want, (dx, dw, db, dzb) = _jax_layer(*arrays[:6], cot, alpha,
                                             need_dx)
        assert want.dtype == jnp.bfloat16 and dw.dtype == jnp.bfloat16
        _close(got, want, ULP, "out")
        grads = ck.gcn_layer_bwd(g, x, w, b, zb, ngp, nsib, P, alpha=alpha,
                                 need_dx=need_dx)
        assert grads["w"].dtype == BF and grads["b"].dtype == torch.float32
        _close(grads["w"], dw, ULP, "dw")
        _close(grads["b"], np.asarray(db).reshape(-1), F32_TOL, "db")
        _close(grads["z_bias"], dzb, F32_TOL, "dzb")
        if need_dx:
            assert grads["x"].dtype == BF
            _close(grads["x"], dx, ULP, "dx")
        else:
            assert grads["x"] is None


def _reference64(x, w, b, zb, ngp, nsib, pe, wp, g, seed, drop, alpha):
    """The bf16 train form in float64 from the port's masks: X = [x *
    bf16(m), rounded | pe * m_pe, rounded], W = [W_h; bf16(W_p)], z = X W +
    z_bias, the star pass (ops/star.py), the output; its backward with dz
    rounded to bf16 for dW and dX (dx times its float32 mask)."""
    r16 = lambda t: t.to(BF).double()  # noqa: E731
    fm = dropout.slot_mask(seed, dropout.STREAM_FEAT, B, N, DIN, drop, None)
    pm = dropout.slot_mask(seed, dropout.STREAM_PE, B, N, POS, drop, None)
    xs = r16(x.double() * r16(fm)).reshape(B * N, DIN)
    ps = r16(pe.double()[None] * pm.double()).reshape(B * N, POS)
    big_x = torch.cat([xs, ps], dim=1)
    big_w = torch.cat([w.double(), r16(wp)], dim=0)
    z = ((big_x @ big_w).reshape(B, N, DOUT) + zb.double()[None]
         ).requires_grad_(True)
    bias = b.double().requires_grad_(True)
    with torch.enable_grad():
        norm = star.gcn_norm(ngp, nsib, P, N).double()
        out = star.copy_src_sum(z * norm, ngp, nsib, P) * norm + bias
        if alpha is not None:
            out = torch.where(out >= 0, out, alpha * out)
        dz, db = torch.autograd.grad(out, (z, bias), g.double())
    d16 = r16(dz.reshape(B * N, DOUT))
    dw = big_x.T @ d16
    dxs = d16 @ big_w.T
    grads = {"x": (dxs[:, :DIN] * fm.reshape(B * N, DIN).double()
                   ).reshape(B, N, DIN),
             "w": dw[:DIN], "b": db, "z_bias": dz.sum(dim=0),
             "pe": (dxs[:, DIN:] * pm.reshape(B * N, POS).double()
                    ).reshape(B, N, POS).sum(dim=0),
             "wp": dw[DIN:]}
    return out.detach(), grads


@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_bf16_train_form_matches_float64_reference(alpha):
    """Feature and pe dropout with the pe path: the train form and its
    backward (need_dx on) against the float64 reference from the same
    masks; the masks bite."""
    arrays = _inputs(seed=3)
    x, w, b, zb, ngp, nsib, pe, wp = _bf16_ops(arrays)
    g = (torch.randn((B, N, DOUT), generator=torch.Generator().manual_seed(
        4))).to(BF)
    kw = dict(pe_pack=(pe, wp), seed=7, drop=0.3, alpha=alpha)
    got = ck.gcn_layer_fwd_train(x, w, b, zb, ngp, nsib, P, **kw)
    want, want_g = _reference64(x, w, b, zb, ngp, nsib, pe, wp, g, 7, 0.3,
                                alpha)
    assert got.dtype == BF
    _close(got, want, dict(rtol=2 ** -7, atol=1e-5), "out")
    # the masks bite: the eval form with the pe term unmasked differs
    assert not np.allclose(_f32(got), _f32(ck.gcn_layer_fwd(
        x, w, b, zb + pe @ wp, ngp, nsib, P, alpha)))
    grads = ck.gcn_layer_bwd(g, x, w, b, zb, ngp, nsib, P, need_dx=True,
                             **kw)
    for name, ref in want_g.items():
        low = name in ("x", "w")
        assert grads[name].dtype == (BF if low else torch.float32), name
        scale = float(ref.abs().max())
        _close(grads[name], ref, dict(
            rtol=2 ** -6 if low else 1e-5,
            atol=(2 ** -8 if low else 1e-6) * scale), name)


def test_kernel_check_refuses_mixed_dtypes():
    """x and W_h both float32 or both bf16 (and a bf16 layer's incoming
    grad bf16); a mix raises, as do bf16 slot biases or pe rows."""
    x, w, b, zb, ngp, nsib, pe, wp = _bf16_ops(_inputs())
    ck._check(x, w, b, zb, ngp, nsib, P, (pe, wp), torch.zeros(
        (B, N, DOUT), dtype=BF))
    ck._check(x.float(), w.float(), b, zb, ngp, nsib, P)
    for args in ((x, w.float(), b, zb), (x.float(), w, b, zb),
                 (x, w, b.to(BF), zb), (x, w, b, zb.to(BF))):
        with pytest.raises(TypeError, match="the kernel takes"):
            ck._check(*args, ngp, nsib, P)
    with pytest.raises(TypeError, match="the kernel takes"):
        ck._check(x, w, b, zb, ngp, nsib, P, (pe, wp.to(BF)))
    with pytest.raises(TypeError, match="the kernel takes"):
        ck._check(x, w, b, zb, ngp, nsib, P, g=torch.zeros((B, N, DOUT)))


def _f32_parent(x, w, b, zb, ngp, nsib, pe_pack, seed, drop, alpha):
    """The float32 train form as the plain versions computed it before the
    bf16 form existed."""
    if drop > 0:
        x = x * dropout.slot_mask(seed, dropout.STREAM_FEAT, B, N, DIN, drop,
                                  x.device)
    z = (x.reshape(B * N, DIN) @ w).reshape(B, N, -1) + zb[None]
    if pe_pack is not None:
        pe, wp = pe_pack
        pm = pe[None] * dropout.slot_mask(seed, dropout.STREAM_PE, B, N, POS,
                                          drop, x.device)
        z = z + (pm.reshape(B * N, -1) @ wp).reshape(B, N, -1)
    norm = star.gcn_norm(ngp, nsib, P, N)
    out = star.copy_src_sum(z * norm, ngp, nsib, P) * norm + b
    return out if alpha is None else torch.where(out >= 0, out, alpha * out)


@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_float32_plain_versions_unchanged(alpha):
    """The float32 plain versions equal, bit for bit, the formulas they
    computed before the bf16 form: the eval forward, the train form with
    dropout and the pe path, and its backward (autograd through it)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in _inputs(5)]
    x, w, b, zb, ngp, nsib, pe, wp = t
    want = _f32_parent(x, w, b, zb, ngp, nsib, None, 0, 0.0, alpha)
    got = ck.gcn_layer_fwd_plain(x, w, b, zb, ngp, nsib, P, alpha)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    kw = dict(seed=9, drop=0.25, alpha=alpha)
    leaves = [v.detach().requires_grad_(True) for v in (x, w, b, zb, pe, wp)]
    with torch.enable_grad():
        want = _f32_parent(*leaves[:4], ngp, nsib, tuple(leaves[4:]),
                           9, 0.25, alpha)
        g = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
        want_grads = torch.autograd.grad(want, leaves, g)
    got = ck.gcn_layer_train_plain(x, w, b, zb, ngp, nsib, P,
                                   pe_pack=(pe, wp), **kw)
    assert torch.equal(got, want.detach())
    grads = ck.gcn_layer_bwd_plain(g, x, w, b, zb, ngp, nsib, P,
                                   pe_pack=(pe, wp), **kw)
    for name, ref in zip(("x", "w", "b", "z_bias", "pe", "wp"), want_grads):
        assert grads[name].dtype == torch.float32
        assert torch.equal(grads[name], ref), name


def test_card_form_by_shape():
    """The form a K5 call takes on the card (`ck.form`): the valid-rows
    form at N <= 64 and the two-pass form above 64 slots, for float32 and
    bf16 alike; `use_form` picks one for calls of either dtype, nests, and
    refuses an unknown name."""
    def x(n, dtype):
        return torch.zeros((1, n, 4), dtype=dtype)

    for dtype in (torch.bfloat16, torch.float32):
        assert ck.form(x(64, dtype)) == "valid_rows"
        assert ck.form(x(65, dtype)) == "two_pass"
    with ck.use_form("two_pass"):
        assert ck.form(x(64, torch.bfloat16)) == "two_pass"
        assert ck.form(x(64, torch.float32)) == "two_pass"
        with ck.use_form("valid_rows"):
            assert ck.form(x(64, torch.float32)) == "valid_rows"
        assert ck.form(x(64, torch.float32)) == "two_pass"
    assert ck.form(x(64, torch.float32)) == "valid_rows"
    with pytest.raises(ValueError):
        with ck.use_form("fused"):
            pass
