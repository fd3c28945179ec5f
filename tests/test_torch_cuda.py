"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes the main paths of config.mag.json do not reach: several row
chunks (N > 64), a partial one, ragged head widths (Dh not a multiple of
128) and input depths, heads 1 and 4, empty and full egonets, an empty
batch, and the wrapper's refusals; for the train path the K1/K3 train
forms, K2/K4 with need_dx both ways, the pe path, and the dropout
generator's golden bits; for the GCN layer K5f (eval and train form) and
K5b at N 12 and Dout 200 (not multiples of the tiles) and at the
config.mag.json PGCN shapes, empty and full egonets, need_dx both ways,
with and without the activation and the pe path; for K7 the store forms
of K1/K3 and the stored K2/K4 (also at the MTL per-slot final layer's
widths, Din 3600 and Dh 600) with 32- and 8-bit masks, held to the
recompute backward on the card within 1e-6 of each grad's largest value,
the 8-bit golden bytes, and the differentiable layer with both switches;
the projection of the per-slot layer (3xTF32 on the tensor cores) alone
and K1 / K2 around it at B*N not a multiple of its 128-row tile, Dh 500 /
900 / 600, din + pos 300 / 400 / 2050 / 3700, heads 4 and 1, dropout 0 and
0.1 with 32- and 8-bit masks, need_dx both ways, stored and recompute
backwards (equal bits);
for K6 the halo gather at P = 1 to 4 in float32 and bf16 (exact), empty
buckets, and two rank processes sharing the card through CUDA IPC.

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets JAX up for the CPU suite, and the
port's card tests need no JAX.)

Tolerance rtol 1e-4 / atol 1e-4 for the forwards: float32 on both sides
(the projections in 3xTF32, float32-accurate), sums taken in another order
(the kernel's tiled K loop vs cuBLAS). The
backward grads reduce over every row of the batch (dW, slot biases) and
take rtol 1e-3 / atol 1e-4, the CPU parity tests' gradient tolerance."""
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import dropout
from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import gcn_kernels as ck
from taxoexpan_torch.ops import halo_kernels
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


# ------------------------------------------------------------ the GCN layer

def _gcn_inputs(dev, b, p, s, din, dout, pos, seed=0):
    """x (unit-scale rows, invalid slots zeroed, an empty and a full
    egonet first), W_h, b, a non-zero z_bias, ngp, nsib, and pe_pack = (pe,
    W_p) when pos > 0."""
    t = _inputs(dev, b, p, s, din, 1, dout, seed)
    x, w, ngp, nsib = t[0], t[1], t[7], t[8]
    rng = np.random.default_rng(seed + 1)
    n = p + 1 + s
    extra = [rng.normal(size=(dout,)) * 0.1, rng.normal(size=(n, dout)) * 0.1]
    if pos:
        extra += [rng.normal(size=(n, pos)),
                  rng.normal(size=(pos, dout)) / np.sqrt(din + pos)]
    bias, zb, *pe_pack = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                          for a in extra]
    return (x, w, bias, zb, ngp, nsib), tuple(pe_pack) or None


GCN_SHAPES = [
    # b, p, s, din, dout, pos
    (16, 2, 9, 16, 200, 7),        # N = 12, Dout not a multiple of 128
    (37, 5, 64, 33, 130, 0),       # N = 70: two row chunks, no pe
    (9, 13, 50, 250, 500, 50),     # the config.mag.json PGCN layer 0
]


@pytest.mark.parametrize("b,p,s,din,dout,pos", GCN_SHAPES)
@pytest.mark.parametrize("alpha", [0.01, None])
@pytest.mark.parametrize("train", [False, True])
def test_gcn_layer_fwd_matches_plain(dev, b, p, s, din, dout, pos, alpha,
                                     train):
    ops, pe_pack = _gcn_inputs(dev, b, p, s, din, dout, pos)
    if train:
        kw = dict(pe_pack=pe_pack, seed=3, drop=0.1 if pos else 0.3,
                  alpha=alpha)
        wrapper, plain = ck.gcn_layer_fwd_train, ck.gcn_layer_train_plain
    else:
        kw = dict(alpha=alpha)
        wrapper, plain = ck.gcn_layer_fwd, ck.gcn_layer_train_plain
    before = wrapper.launches
    got = wrapper(*ops, p, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*ops, p, **kw)
    torch.testing.assert_close(got, want, **TOL)
    # invalid slots carry leaky(b) (or b): the formula value, not 0
    mask = star.node_mask(ops[4], ops[5], p, p + 1 + s)
    bias = ops[2] if alpha is None else torch.where(ops[2] >= 0, ops[2],
                                                    alpha * ops[2])
    torch.testing.assert_close(got[~mask], bias.expand_as(got[~mask]),
                               **TOL)


@pytest.mark.parametrize("b,p,s,din,dout,pos", GCN_SHAPES + [
    (97, 3, 30, 40, 24, 5),        # 3298 rows: several split-K splits
])
@pytest.mark.parametrize("alpha", [0.01, None])
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("drop", [True, False])
def test_gcn_layer_bwd_matches_plain(dev, b, p, s, din, dout, pos, alpha,
                                     need_dx, drop):
    ops, pe_pack = _gcn_inputs(dev, b, p, s, din, dout, pos)
    n = p + 1 + s
    g = torch.randn((b, n, dout), device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    kw = dict(pe_pack=pe_pack if drop else None, seed=6,
              drop=0.1 if drop else 0.0, alpha=alpha, need_dx=need_dx,
              need_dzb=not drop)
    before = ck.gcn_layer_bwd.launches
    got = ck.gcn_layer_bwd(g, *ops, p, **kw)
    torch.cuda.synchronize()
    assert ck.gcn_layer_bwd.launches == before + 1
    _assert_grads(got, ck.gcn_layer_bwd_plain(g, *ops, p, **kw))


def test_gcn_empty_batch_launches_nothing(dev):
    ops, _ = _gcn_inputs(dev, 0, 3, 8, 6, 5, 0)
    before = {k: w.launches for k, w in ck.WRAPPERS.items()}
    assert ck.gcn_layer_fwd(*ops, 3, alpha=0.01).shape == (0, 12, 5)
    got = ck.gcn_layer_bwd(torch.zeros((0, 12, 5), device=dev), *ops, 3)
    assert float(got["w"].abs().sum()) == 0.0
    assert {k: w.launches for k, w in ck.WRAPPERS.items()} == before


def test_gcn_layer_function_on_card_matches_cpu(dev):
    """The differentiable layer end to end: card forward + K5b against the
    CPU Function (plain versions) on the same inputs and seed."""
    ops, pe_pack = _gcn_inputs(dev, 12, 4, 20, 24, 36, 5)
    out = {}
    for d in (dev, torch.device("cpu")):
        leaves = [a.to(d).clone().requires_grad_(True)
                  for a in (*ops[:4], *pe_pack)]
        y = ck.gcn_layer(*leaves[:4], ops[4].to(d), ops[5].to(d), 4,
                         pe_pack=tuple(leaves[4:]), seed=9, drop=0.1,
                         alpha=0.01)
        grads = torch.autograd.grad(y.square().sum(), leaves,
                                    allow_unused=True)
        out[d.type] = [y.detach().cpu()] + [
            x.cpu() for x in grads if x is not None]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, **GTOL)


# ------------------------------------------- K7: stored attention, 8-bit

STORE_SHAPES = [
    # b, p, s, din, heads, dh, pos
    (37, 5, 64, 33, 3, 130, 7),    # N = 70, ragged widths, pe path
    (16, 2, 9, 16, 1, 4, 0),       # N = 12, one head, no pe
    (9, 13, 50, 3600, 1, 600, 100),  # the MTL per-slot final layer
]


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", STORE_SHAPES)
@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("bits", [32, 8])
def test_store_forms_and_stored_backwards(dev, b, p, s, din, heads, dh, pos,
                                          pooled, bits):
    """The store forms (output and softmax weights) against the plain
    version; the stored backwards fed those weights against the plain
    version and against the recompute backward on the card."""
    t = _inputs(dev, b, p, s, din, heads, dh)
    n = p + 1 + s
    kw = dict(pe_pack=_pe_pack(dev, n, pos, heads, dh), seed=13,
              feat_drop=0.1 if pos else 0.0, attn_drop=0.2,
              dropout_bits=bits)
    akw = {} if pooled else {"out_alpha": 0.01}
    fwd = gk.gat_layer_pooled_fwd_train_store if pooled \
        else gk.gat_layer_fwd_train_store
    bwd = gk.gat_layer_pooled_bwd_stored if pooled else gk.gat_layer_bwd_stored
    recompute = gk.gat_layer_pooled_bwd if pooled else gk.gat_layer_bwd
    before = (fwd.launches, bwd.launches)
    out, attn = fwd(*t, p, heads, **kw, **akw)
    torch.cuda.synchronize()
    assert attn.shape == (b, heads, 2 * n - p - 1)
    want_out, want_attn = gk.gat_layer_train_plain(
        *t, p, heads, pooled=pooled, store_attn=True, **kw, **akw)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(attn, want_attn, **TOL)
    torch.testing.assert_close(out, (gk.gat_layer_pooled_fwd_train if pooled
                                     else gk.gat_layer_fwd_train)(
        *t, p, heads, **kw, **akw), rtol=0, atol=0)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(14))
    got = bwd(g, *t, p, heads, attn, **kw, **akw)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_grads(got, gk.gat_layer_bwd_plain(
        g, *t, p, heads, pooled=pooled, stored_attn=attn, **kw, **akw))
    ref = recompute(g, *t, p, heads, **kw, **akw)
    for name, a in got.items():
        if a is not None:
            scale = float(ref[name].abs().max()) or 1.0
            assert float((a - ref[name]).abs().max()) <= 1e-6 * scale, name


def test_golden_bytes8_on_card(dev):
    for (seed, stream, row, col), want in dropout.GOLDEN_BYTES8:
        got = dropout.bits(seed, stream, torch.tensor([row], device=dev),
                           torch.tensor([col], device=dev), width=8)
        assert int(got[0]) == want
    rows = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64)
    cols = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64)
    got = dropout.bits(3, 7, rows.to(dev), cols.to(dev), width=8).cpu()
    assert torch.equal(got, dropout.bytes8_plain(3, 7, rows, cols))


def test_stored_layer_function_on_card_matches_cpu(dev, monkeypatch):
    """gat_layer with both switches set: the store form and the stored
    backward on the card against the CPU Function (plain versions)."""
    monkeypatch.setenv("TAXOEXPAN_STORED_ATTN", "1")
    monkeypatch.setenv("TAXOEXPAN_DROPOUT_BITS", "8")
    t = _inputs(dev, 12, 4, 20, 24, 2, 36)
    kw = dict(seed=9, feat_drop=0.1, attn_drop=0.1, out_alpha=0.01)
    before = gk.gat_layer_bwd_stored.launches
    out = {}
    for d in (dev, torch.device("cpu")):
        leaves = [a.to(d).clone().requires_grad_(True) for a in t[:7]]
        y = gk.gat_layer(*leaves, t[7].to(d), t[8].to(d), 4, 2, **kw)
        grads = torch.autograd.grad(y.square().sum(), leaves)
        out[d.type] = [y.detach().cpu()] + [x.cpu() for x in grads]
    assert gk.gat_layer_bwd_stored.launches == before + 1
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, **GTOL)


# --------------------------------- K1 / K2 around the projection (3xTF32)

PROJ_SHAPES = [
    # b, p, s, din, heads, dh, pos: B*N = 48 or 192, never a multiple of
    # the projection's 128-row tile
    (3, 2, 13, 250, 4, 500, 50),     # N = 16; din + pos 300 (PGAT layer 0)
    (3, 13, 50, 300, 4, 900, 100),   # N = 64; 400 (the MTL layer 0)
    (3, 13, 50, 2000, 1, 500, 50),   # 2050 (the PGAT final layer's input)
    (3, 13, 50, 3600, 1, 600, 100),  # 3700 (the MTL per-slot final layer)
]


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", PROJ_SHAPES)
@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("bits", [32, 8])
def test_projection_k1_k2_match_plain(dev, b, p, s, din, heads, dh, pos,
                                      drop, bits):
    """The projection alone, K1 (the eval form at dropout 0, else the train
    form's store form) and K2 with need_dx on and off against their plain
    versions; with dropout also the stored K2 fed the store form's
    weights, equal bits with the recompute K2 (both run the forward's
    projection). Layer-0 widths (heads 4) fuse leaky_relu 0.01, whose
    derivative jumps at 0: the incoming grad is 0 where the
    pre-activation lies within 1e-5 of it. An empty and a full egonet
    lead the batch."""
    t = _inputs(dev, b, p, s, din, heads, dh)
    n = p + 1 + s
    pe = _pe_pack(dev, n, pos, heads, dh) if drop else None
    kw = dict(pe_pack=pe, seed=17, feat_drop=drop, dropout_bits=bits)
    before = gk.gat_projection.launches
    proj = gk.gat_projection(*t[:7], **kw)
    torch.cuda.synchronize()
    assert gk.gat_projection.launches == before + 1
    torch.testing.assert_close(proj, gk.gat_projection_plain(*t[:7], **kw),
                               **TOL)
    out_alpha = 0.01 if heads > 1 else None
    tkw = dict(kw, attn_drop=drop, out_alpha=out_alpha)
    if drop:
        out, attn = gk.gat_layer_fwd_train_store(*t, p, heads, **tkw)
        want, want_attn = gk.gat_layer_train_plain(*t, p, heads,
                                                   store_attn=True, **tkw)
        torch.testing.assert_close(attn, want_attn, **TOL)
    else:
        out, attn = gk.gat_layer_fwd(*t, p, heads, out_alpha=out_alpha), None
        want = gk.gat_layer_fwd_plain(*t, p, heads, out_alpha)
    torch.testing.assert_close(out, want, **TOL)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(18)) * 1e-2
    if out_alpha is not None:
        pre = gk.gat_layer_train_plain(*t, p, heads, **dict(tkw,
                                                             out_alpha=None))
        g = g * (pre.abs() > 1e-5)
    for need_dx in (True, False):
        bkw = dict(tkw, need_dx=need_dx)
        got = gk.gat_layer_bwd(g, *t, p, heads, **bkw)
        _assert_grads(got, gk.gat_layer_bwd_plain(g, *t, p, heads, **bkw))
        if attn is not None:
            stored = gk.gat_layer_bwd_stored(g, *t, p, heads, attn, **bkw)
            for name, a in stored.items():
                assert (a is None) == (got[name] is None), name
                assert a is None or torch.equal(a, got[name]), name


# ------------------------------------------------------------------- K6

@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [250, 7])
def test_halo_gather_matches_plain(dev, p, dtype, d):
    """K6 on P shards of this process against its plain version, exactly:
    in-range slots, slots past the shard and negative ones (zero rows), a
    bucket with no slot in range, D a multiple of 2 (vector loads) and odd
    (scalar)."""
    rng = np.random.default_rng(p)
    rows, cap = 37, 53
    shards = [torch.from_numpy(rng.normal(size=(rows, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(p)]
    req = rng.integers(-3, 2 * rows, size=(p, cap)).astype(np.int32)
    req[-1] = rng.integers(rows, 10 * rows, size=cap)   # nothing in range
    req = torch.from_numpy(req).to(dev)
    before = halo_kernels.halo_gather.launches
    got = halo_kernels.halo_gather(shards, req)
    torch.cuda.synchronize()
    assert halo_kernels.halo_gather.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (p, cap, d)
    assert torch.equal(got, halo_kernels.halo_gather_plain(shards, req))
    assert not got[-1].any()


def test_halo_gather_empty_buckets_launch_nothing(dev):
    shards = [torch.ones((5, 4), device=dev) for _ in range(2)]
    before = halo_kernels.halo_gather.launches
    got = halo_kernels.halo_gather(shards, torch.zeros(
        (2, 0), dtype=torch.int32, device=dev))
    assert got.shape == (2, 0, 4)
    assert halo_kernels.halo_gather.launches == before
    with pytest.raises(TypeError):
        halo_kernels.halo_gather(shards, torch.zeros((2, 3), device=dev))
    with pytest.raises(ValueError):
        halo_kernels.halo_gather(shards, torch.zeros(
            (3, 3), dtype=torch.int32, device=dev))


def _ring_rank(rank: int, coord: str, world: int) -> None:
    """One rank of the IPC test: its shard through RingExchange (K6 reading
    the peer's shard through a CUDA IPC mapping), partitioned_gather of
    this rank's ids, against the dense table."""
    import torch.distributed as tdist
    from taxoexpan_torch.parallel import distributed, partition
    from taxoexpan_torch.parallel.halo import RingExchange
    from taxoexpan_torch.parallel.mesh import DataParallel
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"tcp://{coord}",
                             world_size=world, rank=rank)
    try:
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        table = rng.normal(size=(301, 250)).astype(np.float32)
        ids = rng.integers(0, 301, size=(world, 512, 64))[rank]
        dp = DataParallel(size=world, rank=rank, backend="gloo")
        ring = RingExchange(torch.from_numpy(
            partition.shard_table(table, world)[rank]), dp, dev)
        got = partition.partitioned_gather(
            torch.from_numpy(ids).to(dev), ring, world)
        torch.cuda.synchronize()
        assert halo_kernels.halo_gather.launches == 1
        want = torch.from_numpy(table[ids]).to(dev)
        assert torch.equal(got, want), float((got - want).abs().max())
        ring.close()
        distributed.barrier(dp)
    finally:
        tdist.destroy_process_group()


def test_ring_exchange_two_processes_on_one_card(dev):
    """Two rank processes share the card: each exchanges through K6 and the
    peer's IPC-mapped shard, and gets the dense gather's rows exactly."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    mp.spawn(_ring_rank, args=(coord, 2), nprocs=2, join=True)
