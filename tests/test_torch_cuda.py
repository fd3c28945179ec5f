"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes the main paths of config.mag.json do not reach: several row
chunks (N > 64), a partial one, ragged head widths (Dh not a multiple of
128) and input depths, heads 1 and 4, empty and full egonets, an empty
batch, and the wrapper's refusals; for the train path the K1/K3 train
forms, K2/K4 with need_dx both ways, the pe path, and the dropout
generator's golden bits.

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets JAX up for the CPU suite, and the
port's card tests need no JAX.)

Tolerance rtol 1e-4 / atol 1e-4 for the forwards: float32 on both sides,
sums taken in another order (the kernel's tiled K loop vs cuBLAS). The
backward grads reduce over every row of the batch (dW, slot biases) and
take rtol 1e-3 / atol 1e-4, the CPU parity tests' gradient tolerance."""
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import star

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)
GTOL = dict(rtol=1e-3, atol=1e-4)


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
    if b > 1:
        ngp[1], nsib[1] = p, s
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


# ------------------------------------------------------------ train path

def _pe_pack(dev, n, pos, heads, dh, seed=1):
    if not pos:
        return None
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(n, pos)), rng.normal(size=(pos, heads * dh)),
              rng.normal(size=(pos, heads)), rng.normal(size=(pos, heads))]
    return tuple(torch.from_numpy(np.asarray(a * 0.1, np.float32)).to(dev)
                 for a in arrays)


TRAIN_SHAPES = [
    # b, p, s, din, heads, dh, pos
    (37, 5, 64, 33, 3, 130, 7),    # N = 70, ragged widths, pe path
    (16, 2, 9, 16, 1, 4, 0),       # N = 12, one head, no pe
    (9, 13, 50, 250, 4, 500, 50),  # the config.mag.json layer-0 shapes
]


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", TRAIN_SHAPES)
@pytest.mark.parametrize("out_alpha", [0.01, None])
def test_gat_layer_fwd_train_matches_plain(dev, b, p, s, din, heads, dh,
                                           pos, out_alpha):
    t = _inputs(dev, b, p, s, din, heads, dh)
    kw = dict(pe_pack=_pe_pack(dev, p + 1 + s, pos, heads, dh), seed=3,
              feat_drop=0.1 if pos else 0.0, attn_drop=0.2,
              out_alpha=out_alpha)
    before = gk.gat_layer_fwd_train.launches
    got = gk.gat_layer_fwd_train(*t, p, heads, **kw)
    torch.cuda.synchronize()
    assert gk.gat_layer_fwd_train.launches == before + 1
    want = gk.gat_layer_train_plain(*t, p, heads, **kw)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", [
    (37, 5, 64, 33, 3, 130, 7), (16, 2, 9, 16, 4, 4, 0),
    (9, 13, 50, 2000, 1, 500, 50)])
def test_gat_layer_pooled_fwd_train_matches_plain(dev, b, p, s, din, heads,
                                                  dh, pos):
    t = _inputs(dev, b, p, s, din, heads, dh)
    kw = dict(pe_pack=_pe_pack(dev, p + 1 + s, pos, heads, dh), seed=4,
              feat_drop=0.3, attn_drop=0.1)
    before = gk.gat_layer_pooled_fwd_train.launches
    got = gk.gat_layer_pooled_fwd_train(*t, p, heads, **kw)
    torch.cuda.synchronize()
    assert gk.gat_layer_pooled_fwd_train.launches == before + 1
    want = gk.gat_layer_train_plain(*t, p, heads, pooled=True, **kw)
    torch.testing.assert_close(got, want, **TOL)


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name in want:
        if want[name] is None or got[name] is None:
            assert got[name] is None, name
            continue
        torch.testing.assert_close(got[name], want[name], **GTOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", TRAIN_SHAPES + [
    (97, 3, 30, 40, 2, 24, 5),     # 3298 rows: several split-K splits
])
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("drop", [True, False])
def test_gat_layer_bwd_matches_plain(dev, b, p, s, din, heads, dh, pos,
                                     need_dx, drop):
    t = _inputs(dev, b, p, s, din, heads, dh)
    n = p + 1 + s
    g = torch.randn((b, n, heads * dh), device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    kw = dict(pe_pack=_pe_pack(dev, n, pos, heads, dh) if drop else None,
              seed=6, feat_drop=0.1 if drop else 0.0,
              attn_drop=0.1 if drop else 0.0, out_alpha=0.01,
              need_dx=need_dx)
    before = gk.gat_layer_bwd.launches
    got = gk.gat_layer_bwd(g, *t, p, heads, **kw)
    torch.cuda.synchronize()
    assert gk.gat_layer_bwd.launches == before + 1
    want = gk.gat_layer_bwd_plain(g, *t, p, heads, **kw)
    _assert_grads(got, want)


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", [
    (37, 5, 64, 33, 3, 130, 7), (16, 2, 9, 16, 4, 4, 0),
    (9, 13, 50, 2000, 1, 500, 50)])
@pytest.mark.parametrize("need_dx", [True, False])
def test_gat_layer_pooled_bwd_matches_plain(dev, b, p, s, din, heads, dh,
                                            pos, need_dx):
    t = _inputs(dev, b, p, s, din, heads, dh)
    n = p + 1 + s
    g = torch.randn((b, 3, dh), device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    kw = dict(pe_pack=_pe_pack(dev, n, pos, heads, dh), seed=8,
              feat_drop=0.2, attn_drop=0.2, need_dx=need_dx)
    before = gk.gat_layer_pooled_bwd.launches
    got = gk.gat_layer_pooled_bwd(g, *t, p, heads, **kw)
    torch.cuda.synchronize()
    assert gk.gat_layer_pooled_bwd.launches == before + 1
    want = gk.gat_layer_bwd_plain(g, *t, p, heads, pooled=True, **kw)
    _assert_grads(got, want)
    if need_dx:   # invalid slots get no grad from the pools
        mask = star.node_mask(t[7], t[8], p, n)
        assert float(got["x"][~mask].abs().max()) == 0.0


def test_layer_function_on_card_matches_cpu(dev):
    """The differentiable layer end to end: card forward + K2 against the
    CPU Function (plain versions) on the same inputs and seed."""
    t = _inputs(dev, 12, 4, 20, 24, 2, 36)
    kw = dict(seed=9, feat_drop=0.1, attn_drop=0.1, out_alpha=0.01)
    out = {}
    for d in (dev, torch.device("cpu")):
        leaves = [a.to(d).clone().requires_grad_(True) for a in t[:7]]
        y = gk.gat_layer(*leaves, t[7].to(d), t[8].to(d), 4, 2, **kw)
        grads = torch.autograd.grad(y.square().sum(), leaves)
        out[d.type] = [y.detach().cpu()] + [x.cpu() for x in grads]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, **GTOL)


def test_golden_bits_on_card(dev):
    keys = [k for k, _ in dropout.GOLDEN_BITS]
    for (seed, stream, row, col), want in dropout.GOLDEN_BITS:
        got = dropout.bits(seed, stream, torch.tensor([row], device=dev),
                           torch.tensor([col], device=dev))
        assert int(got[0]) == want
    rows = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64)
    cols = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64)
    got = dropout.bits(keys[5][0], 7, rows.to(dev), cols.to(dev)).cpu()
    assert torch.equal(got, dropout.bits_plain(keys[5][0], 7, rows, cols))
