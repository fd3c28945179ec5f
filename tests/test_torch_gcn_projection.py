"""Port parity, the star-GCN layer (K5) as its kernels compute it: the
projection z = [x*m | pe*m_pe] @ [W_h; W_p] + z_bias
(`gcn_projection_plain`, the plain version of the kernel launch
`gcn_projection`), then the star pass over z (`gcn_star_plain`, the plain
version of `gcn_star`), held against the plain layer of record (eval form,
and the train form with feature and pe dropout) at 1e-6 and against JAX's
`fused_gcn_layer` in interpret mode at dropout 0 at 1e-5; and the
backward's plain composition (the dz star pass as autograd through
`gcn_star_plain`, then dW = X^T dz, dx = dz W^T, d z_bias = the sum of dz
over egonets, db from the pass) against jax.vjp of `fused_gcn_layer` at
1e-5.

Small sizes (B = 8 with an empty and a full egonet, N = 3 + 1 + 8, Din 6,
Dout 8, pos 5); inputs made with numpy from a seed and handed to both
sides; the JAX side is jitted, as tests/test_pallas_gcn.py runs it."""
import functools

import jax
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import gcn_kernels as ck
from taxoexpan_torch.ops import star
from taxoexpan_tpu.ops.pallas_gcn import fused_gcn_layer

P, S = 3, 8
N = P + 1 + S
B, DIN, DOUT, POS = 8, 6, 8, 5
PLAIN_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed: int = 0):
    """numpy inputs of one layer: x (invalid slots zeroed as gather_feats
    leaves them), W_h, b, a non-zero z_bias, ngp / nsib with an empty and a
    full egonet first, the pe rows and W_p."""
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


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **tol)


@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_star_over_projection_matches_plain_layer(alpha):
    """Eval form, then the train form with feature and pe dropout: the
    composition against the plain layer of record; on CPU tensors the two
    launches' wrappers are the plain versions."""
    x, w, b, zb, ngp, nsib, pe, wp = _torch(_inputs())
    z = ck.gcn_projection_plain(x, w, zb)
    got = ck.gcn_star_plain(z, b, ngp, nsib, P, alpha)
    _close(got, ck.gcn_layer_fwd_plain(x, w, b, zb, ngp, nsib, P, alpha),
           PLAIN_TOL)
    _close(ck.gcn_star(ck.gcn_projection(x, w, zb), b, ngp, nsib, P, alpha),
           got, PLAIN_TOL)
    kw = dict(pe_pack=(pe, wp), seed=5, drop=0.3)
    zt = ck.gcn_projection_plain(x, w, zb, **kw)
    got_t = ck.gcn_star_plain(zt, b, ngp, nsib, P, alpha)
    _close(got_t, ck.gcn_layer_train_plain(x, w, b, zb, ngp, nsib, P,
                                           alpha=alpha, **kw), PLAIN_TOL)
    # the masks bite: the projection without them differs
    assert not np.allclose(zt, z + (pe @ wp)[None])


@functools.partial(jax.jit, static_argnames="alpha")
def _jax_layer(x, w, b, zb, ngp, nsib, cot, alpha):
    """fused_gcn_layer in interpret mode at dropout 0, and its VJP for x,
    W_h, b and z_bias."""
    def f(x, w, b, zb):
        return fused_gcn_layer(x, w, b, zb, None, (ngp, nsib, 0), P, alpha,
                               0.0, True, True)
    out, vjp = jax.vjp(f, x, w, b, zb)
    return out, vjp(cot)


@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_star_over_projection_matches_jax_kernel(alpha):
    """Dropout 0: the composition against the Pallas kernel it replaces."""
    arrays = _inputs(seed=1)
    cot = np.random.default_rng(2).normal(size=(B, N, DOUT)).astype(
        np.float32)
    want, _ = _jax_layer(*arrays[:6], cot, alpha)
    x, w, b, zb, ngp, nsib = _torch(arrays[:6])
    _close(ck.gcn_star_plain(ck.gcn_projection_plain(x, w, zb), b, ngp, nsib,
                             P, alpha), want, JAX_TOL)


@pytest.mark.parametrize("alpha", [0.01, None], ids=["leaky", "final"])
def test_dz_star_pass_composition_matches_jax_vjp(alpha):
    """The backward as K5b computes it: z from the projection (recomputed
    for leaky'), the dz star pass (dz and db; autograd through the plain
    star pass), then the products dW = X^T dz and dx = dz W^T and d z_bias
    = the sum of dz over egonets, against jax.vjp of the Pallas kernel."""
    arrays = _inputs(seed=3)
    cot = np.random.default_rng(4).normal(size=(B, N, DOUT)).astype(
        np.float32)
    _, (dx, dw, db, dzb) = _jax_layer(*arrays[:6], cot, alpha)
    x, w, b, zb, ngp, nsib = _torch(arrays[:6])
    z = ck.gcn_projection_plain(x, w, zb).requires_grad_(True)
    bl = b.clone().requires_grad_(True)
    dz, got_db = torch.autograd.grad(
        ck.gcn_star_plain(z, bl, ngp, nsib, P, alpha), (z, bl),
        torch.from_numpy(cot))
    dz2 = dz.reshape(B * N, DOUT)
    _close(x.reshape(B * N, DIN).T @ dz2, dw, JAX_TOL)
    _close((dz2 @ w.T).reshape(B, N, DIN), dx, JAX_TOL)
    _close(dz.sum(dim=0), dzb, JAX_TOL)
    _close(got_db, db.reshape(-1), JAX_TOL)
    # dz is exactly 0 on invalid slots (norm 0)
    assert float(dz[~star.node_mask(ngp, nsib, P, N)].abs().max()) == 0.0
