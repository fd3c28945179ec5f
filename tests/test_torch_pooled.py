"""Port parity, the pooled final layer (K3) as its kernels compute it: the
projection P = [ft | a1 | a2] of the layer's input, then the pooled star
pass over P (`gat_pooled_star_plain`, the plain version of the kernel pass
`gat_pooled_star`), held against the plain pooled layer of the port
(eval form, and the train forms with dropout, 32- and 8-bit masks and the
store form's softmax weights) at 1e-6, and against JAX's
`fused_gat_layer_pooled` in interpret mode at dropout 0 at 1e-5.

Small sizes (B = 6 with an empty and a full egonet, N = 3 + 1 + 4, Din 10,
heads 1 and 2, Dh 5); inputs made with numpy from a seed and handed to both
sides; the JAX side is jitted, as tests/test_pallas_pooled.py runs it."""
import jax
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_tpu.ops.pallas_gat import fused_gat_layer_pooled

P, S = 3, 4
N = P + 1 + S
B, DIN, DH, POS = 6, 10, 5, 3
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


def _inputs(heads: int, seed: int = 0):
    """numpy inputs of one pooled layer: x (invalid slots zeroed as
    gather_feats leaves them), fc, the folded attention weights, non-zero
    slot biases, ngp / nsib with an empty and a full egonet first."""
    rng = np.random.default_rng(seed)
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    valid = np.concatenate([np.arange(P)[None] < ngp[:, None],
                            np.ones((B, 1), bool),
                            np.arange(S)[None] < nsib[:, None]], axis=1)
    f32 = lambda *shape: (rng.normal(size=shape) * 0.3).astype(  # noqa
        np.float32)
    x = f32(B, N, DIN) * valid[..., None]
    return (x, f32(DIN, heads * DH), f32(DIN, heads), f32(DIN, heads),
            f32(N, heads * DH), f32(N, heads), f32(N, heads), ngp, nsib)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("heads", [1, 2])
def test_star_over_projection_matches_pooled_layer(heads):
    """Eval form: the composition against the plain pooled layer, which
    aggregates through ops/star.py; on CPU tensors the pass's wrapper is
    the plain version."""
    t = _torch(_inputs(heads))
    proj = gk.gat_projection_plain(*t[:7])
    assert proj.shape == (B, N, heads * DH + 2 * heads)
    got = gk.gat_pooled_star_plain(proj, t[7], t[8], P, heads)
    want = gk.gat_layer_pooled_fwd_plain(*t, P, heads)
    _close(got, want, PLAIN_TOL)
    _close(gk.gat_pooled_star(proj, t[7], t[8], P, heads), want, PLAIN_TOL)
    assert float(got[0].abs().max()) > 0    # the empty egonet: its anchor


@pytest.mark.parametrize("bits", [32, 8])
def test_star_over_projection_matches_train_forms(bits):
    """Train forms, dropout on (features, pe path, attention) with 32- or
    8-bit masks: the composition against `gat_layer_train_plain(pooled=
    True)`, pools and the store form's softmax weights."""
    heads = 2
    t = _torch(_inputs(heads, seed=1))
    rng = np.random.default_rng(2)
    pe_pack = tuple(_torch([rng.normal(size=shape).astype(np.float32) * 0.3
                            for shape in ((N, POS), (POS, heads * DH),
                                          (POS, heads), (POS, heads))]))
    kw = dict(seed=5, dropout_bits=bits)
    proj = gk.gat_projection_plain(*t[:7], pe_pack=pe_pack, feat_drop=0.25,
                                   **kw)
    got, attn = gk.gat_pooled_star_plain(proj, t[7], t[8], P, heads,
                                         attn_drop=0.3, store_attn=True, **kw)
    want, want_attn = gk.gat_layer_train_plain(
        *t, P, heads, pe_pack=pe_pack, feat_drop=0.25, attn_drop=0.3,
        pooled=True, store_attn=True, **kw)
    _close(got, want, PLAIN_TOL)
    _close(attn, want_attn, PLAIN_TOL)
    assert attn.shape == (B, heads, 2 * N - P - 1)
    # the masks bite: the eval pass over the same projection differs
    assert not np.allclose(got, gk.gat_pooled_star_plain(proj, t[7], t[8], P,
                                                         heads))


@pytest.mark.parametrize("heads", [1, 2])
def test_star_over_projection_matches_jax_pooled_kernel(heads):
    """Dropout 0: the composition against the Pallas kernel it replaces,
    `fused_gat_layer_pooled` in interpret mode."""
    arrays = _inputs(heads, seed=3)
    j = [jax.numpy.asarray(a) for a in arrays]
    want = jax.jit(lambda *a: fused_gat_layer_pooled(
        *a[:7], None, (a[7], a[8], 0), P, heads, 0.2, 0.0, 0.0, True))(*j)
    t = _torch(arrays)
    got = gk.gat_pooled_star_plain(gk.gat_projection_plain(*t[:7]), t[7],
                                   t[8], P, heads)
    _close(got, want, JAX_TOL)
