"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes the serving path of config.mag.json does not reach: several row
chunks (N > 64), a partial one, ragged head widths and input depths, an
empty batch, and the wrapper's refusals.

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets JAX up for the CPU suite, and the
port's card tests need no JAX.)

Tolerance rtol 1e-4 / atol 1e-4: float32 on both sides, sums taken in
another order (the kernel's tiled K loop vs cuBLAS)."""
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import star

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the H100 machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, b, p, s, din, heads, dh, seed=0):
    """Inputs at the model's scales: unit-norm feature rows (invalid slots
    zeroed as gather_feats leaves them), xavier-scaled weights, small slot
    biases."""
    n = p + 1 + s
    rng = np.random.default_rng(seed)
    ngp = rng.integers(0, p + 1, (b,)).astype(np.int32)
    nsib = rng.integers(0, s + 1, (b,)).astype(np.int32)
    if b:
        ngp[0] = nsib[0] = 0
    x = rng.normal(size=(b, n, din)) / np.sqrt(din)
    x *= np.asarray(star.node_mask(torch.from_numpy(ngp),
                                   torch.from_numpy(nsib), p, n))[..., None]
    w = 1.414 * np.sqrt(2.0 / (din + heads * dh))
    arrays = [x,
              rng.normal(size=(din, heads * dh)) * w,
              rng.normal(size=(din, heads)) * w,
              rng.normal(size=(din, heads)) * w,
              rng.normal(size=(n, heads * dh)) * 0.1,
              rng.normal(size=(n, heads)) * 0.1,
              rng.normal(size=(n, heads)) * 0.1]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]
    return t + [torch.from_numpy(ngp).to(dev), torch.from_numpy(nsib).to(dev)]


@pytest.mark.parametrize("b,p,s,din,heads,dh", [
    (37, 5, 64, 33, 3, 130),       # N = 70: two row chunks, ragged widths
    (16, 2, 9, 16, 2, 4),          # N = 12: one partial chunk
    (9, 13, 50, 250, 4, 500),      # the config.mag.json layer-0 shapes
])
@pytest.mark.parametrize("out_alpha", [0.01, None])
def test_gat_layer_fwd_matches_plain(dev, b, p, s, din, heads, dh,
                                     out_alpha):
    t = _inputs(dev, b, p, s, din, heads, dh)
    before = gk.gat_layer_fwd.launches
    got = gk.gat_layer_fwd(*t, p, heads, out_alpha=out_alpha)
    torch.cuda.synchronize()
    assert gk.gat_layer_fwd.launches == before + 1
    want = gk.gat_layer_fwd_plain(*t, p, heads, out_alpha=out_alpha)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b,p,s,din,heads,dh", [
    (37, 5, 64, 33, 3, 130), (16, 2, 9, 16, 2, 4), (9, 13, 50, 2000, 1, 500)])
def test_gat_layer_pooled_fwd_matches_plain(dev, b, p, s, din, heads, dh):
    t = _inputs(dev, b, p, s, din, heads, dh)
    before = gk.gat_layer_pooled_fwd.launches
    got = gk.gat_layer_pooled_fwd(*t, p, heads)
    torch.cuda.synchronize()
    assert gk.gat_layer_pooled_fwd.launches == before + 1
    torch.testing.assert_close(got, gk.gat_layer_pooled_fwd_plain(
        *t, p, heads), **TOL)


def test_empty_batch_launches_nothing(dev):
    t = _inputs(dev, 0, 3, 8, 6, 2, 4)
    before = (gk.gat_layer_fwd.launches, gk.gat_layer_pooled_fwd.launches)
    assert gk.gat_layer_fwd(*t, 3, 2).shape == (0, 12, 8)
    assert gk.gat_layer_pooled_fwd(*t, 3, 2).shape == (0, 3, 4)
    assert (gk.gat_layer_fwd.launches,
            gk.gat_layer_pooled_fwd.launches) == before


def test_wrapper_refuses_bad_inputs(dev):
    t = _inputs(dev, 4, 3, 8, 6, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        gk.gat_layer_fwd(t[0].double(), *t[1:], 3, 2)
    with pytest.raises(TypeError, match="int32"):
        gk.gat_layer_fwd(*t[:7], t[7].long(), t[8], 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fc_t = t[1].T.contiguous().T
        gk.gat_layer_fwd(t[0], fc_t, *t[2:], 3, 2)
    with pytest.raises(ValueError, match="shape"):
        gk.gat_layer_pooled_fwd(t[0], t[1][:5], *t[2:], 3, 2)
    with pytest.raises(ValueError, match="is on"):
        gk.gat_layer_fwd(t[0], t[1].cpu(), *t[2:], 3, 2)
