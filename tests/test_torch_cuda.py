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
backwards (equal bits); K3 (eval, train and store forms) and K4 (recompute
and stored) around the same projection at B = 1, a batch of empty
egonets, heads 3, Dh 200 / 500 and din 33 / 250 (rows staged), stored and
recompute grads equal bits, and the pooled star pass alone; K5 (eval
and train forward, backward) around its projection at B = 1, N = 70 with
B*N not a multiple of the 128-row tile, Dout 130 (rows of 132 floats), din
33 / 250 and a batch of empty egonets (dz and dx exactly 0 on invalid
rows), and the projection and the star pass alone;
for K6 the halo gather at P = 1 to 4 in float32 and bf16 (exact), empty
buckets, and two rank processes sharing the card through CUDA IPC; the
bf16 forms of K1-K4 (compute_dtype "bfloat16": the projection on bf16
tensor-core MMAs) and of K7 at din not a multiple of 8, P's rows padded to
8 elements, B*N not a multiple of the 128-row tile, several split-K
splits, dropout 0 and 0.1 with 32- and 8-bit masks, stored and recompute
backwards (equal bits), the differentiable layer against the CPU, and the
wrappers' refusal of mixed dtypes; the bf16 form of K5 (eval and train
forward, backward with need_dx both ways, with and without the activation,
the projection alone) at din 33 / 250 / 500 (not all multiples of 8), Dout
130 (rows of z padded to 136), B*N not a multiple of the 128-row tile,
several split-K splits and a batch of empty egonets, and its
differentiable layer against the CPU; the shapes head tensor parallelism
over mp = 2 gives K1-K4 (config.mag.json's layer 0 at 2 of its 4 heads,
a pooled layer at 2 of 4 heads), in float32 and bf16; and one train step
of config.mag.json's PGAT at full width free of host syncs (CUDA's sync
debug mode "error").

Needs a CUDA device and nvcc; skipped elsewhere. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets JAX up for the CPU suite, and the
port's card tests need no JAX.)

Tolerance rtol 1e-4 / atol 1e-4 for the forwards: float32 on both sides
(the projections in 3xTF32, float32-accurate), sums taken in another order
(the kernel's tiled K loop vs cuBLAS). The
backward grads reduce over every row of the batch (dW, slot biases) and
take rtol 1e-3 / atol 1e-4, the CPU parity tests' gradient tolerance.
The bf16 forms' tolerances are stated at `_assert_close_bf16` and
`_assert_grads_bf16`."""
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
    at_heads = gk.gat_layer_fwd.launches_by_heads.get(str(heads), 0)
    got = gk.gat_layer_fwd(*t, p, heads, out_alpha=out_alpha)
    torch.cuda.synchronize()
    assert gk.gat_layer_fwd.launches == before + 1
    assert gk.gat_layer_fwd.launches_by_heads[str(heads)] == at_heads + 1
    want = gk.gat_layer_fwd_plain(*t, p, heads, out_alpha=out_alpha)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b,p,s,din,heads,dh", [
    (37, 5, 64, 33, 3, 130), (16, 2, 9, 16, 2, 4), (9, 13, 50, 2000, 1, 500)])
def test_gat_layer_pooled_fwd_matches_plain(dev, b, p, s, din, heads, dh):
    t = _inputs(dev, b, p, s, din, heads, dh)
    before = gk.gat_layer_pooled_fwd.launches
    by_heads = gk.gat_layer_pooled_fwd.launches_by_heads
    at_heads = by_heads.get(str(heads), 0)
    got = gk.gat_layer_pooled_fwd(*t, p, heads)
    torch.cuda.synchronize()
    assert gk.gat_layer_pooled_fwd.launches == before + 1
    assert by_heads[str(heads)] == at_heads + 1
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
    (3, 13, 50, 250, 2, 500, 50),    # N = 64; PGAT layer 0's mp = 2 shard
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


# ------------------- K3 / K4 around the projection (3xTF32), pooled star

POOLED_SHAPES = [
    # b, p, s, din, heads, dh, pos, only empty egonets
    (1, 13, 50, 250, 1, 500, 50, False),   # B = 1; din 250: rows staged
    (6, 5, 20, 33, 3, 200, 7, False),      # heads 3, Dh 200, din 33
    (9, 3, 30, 30, 3, 500, 0, False),      # heads 3, Dh 500, no pe path
    (4, 13, 50, 2000, 1, 500, 50, True),   # only empty egonets
    (3, 13, 50, 2000, 2, 500, 50, False),  # the TP form: 2 heads of 4
]


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos,empty", POOLED_SHAPES)
def test_pooled_forms_around_projection(dev, b, p, s, din, heads, dh, pos,
                                        empty):
    """K3 in all three forms (eval, train, store) and K4 in both (recompute,
    stored) against their plain versions at shapes the smoke does not use
    (Dh not a multiple of 128, din not a multiple of 4, heads 3, B = 1, a
    batch of empty egonets); stored and recompute grads equal bits (both
    run the forward's projection); each wrapper launched once."""
    t = _inputs(dev, b, p, s, din, heads, dh)
    n = p + 1 + s
    if empty:
        t[7].zero_()
        t[8].zero_()
        t[0] *= star.node_mask(t[7], t[8], p, n)[..., None]
    names = ("gat_layer_pooled_fwd", "gat_layer_pooled_fwd_train",
             "gat_layer_pooled_fwd_train_store", "gat_layer_pooled_bwd",
             "gat_layer_pooled_bwd_stored")
    before = {k: gk.WRAPPERS[k].launches for k in names}
    got = gk.gat_layer_pooled_fwd(*t, p, heads)
    torch.testing.assert_close(got, gk.gat_layer_pooled_fwd_plain(
        *t, p, heads), **TOL)
    kw = dict(pe_pack=_pe_pack(dev, n, pos, heads, dh), seed=21,
              feat_drop=0.1, attn_drop=0.1)
    out = gk.gat_layer_pooled_fwd_train(*t, p, heads, **kw)
    torch.testing.assert_close(out, gk.gat_layer_train_plain(
        *t, p, heads, pooled=True, **kw), **TOL)
    out_s, attn = gk.gat_layer_pooled_fwd_train_store(*t, p, heads, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_s, out)
    want_attn = gk.gat_layer_train_plain(*t, p, heads, pooled=True,
                                         store_attn=True, **kw)[1]
    torch.testing.assert_close(attn, want_attn, **TOL)
    g = torch.randn((b, 3, dh), device=dev,
                    generator=torch.Generator(dev).manual_seed(22))
    got = gk.gat_layer_pooled_bwd(g, *t, p, heads, **kw)
    _assert_grads(got, gk.gat_layer_bwd_plain(g, *t, p, heads, pooled=True,
                                              **kw))
    stored = gk.gat_layer_pooled_bwd_stored(g, *t, p, heads, attn, **kw)
    torch.cuda.synchronize()
    for name, a in stored.items():
        assert (a is None) == (got[name] is None), name
        assert a is None or torch.equal(a, got[name]), name
    assert {k: gk.WRAPPERS[k].launches - before[k] for k in names} == \
        dict.fromkeys(names, 1)


@pytest.mark.parametrize("b,p,s,heads,dh", [
    (7, 13, 50, 1, 500),   # the config.mag.json final layer's head
    (5, 5, 64, 3, 200),    # N = 70, heads 3
    (4, 2, 9, 2, 130),     # N = 12, Dh past one 128-column block
])
@pytest.mark.parametrize("store", [False, True])
def test_pooled_star_pass_matches_plain(dev, b, p, s, heads, dh, store):
    """K3's pooled star pass alone, on the projection the card computes,
    against its plain version on the same projection: the eval form, and
    the train form with attention dropout writing the softmax weights."""
    t = _inputs(dev, b, p, s, 40, heads, dh)
    proj = gk.gat_projection(*t[:7])
    kw = dict(seed=23, attn_drop=0.2 if store else 0.0)
    before = gk.gat_pooled_star.launches
    got = gk.gat_pooled_star(proj, t[7], t[8], p, heads, store=store, **kw)
    torch.cuda.synchronize()
    assert gk.gat_pooled_star.launches == before + 1
    want = gk.gat_pooled_star_plain(proj, t[7], t[8], p, heads,
                                    store_attn=store, **kw)
    for a, w in zip(got if store else (got,), want if store else (want,)):
        torch.testing.assert_close(a, w, **TOL)


# ------------------------ K5 around the projection (3xTF32), star pass

K5_SHAPES = [
    # b, p, s, din, dout, pos, only empty egonets
    (1, 13, 50, 250, 500, 50, False),   # B = 1; din 250: rows staged
    (37, 5, 64, 33, 130, 7, False),     # N = 70, 2590 rows, Dout 130
    (9, 5, 64, 250, 130, 0, True),      # only empty egonets, no pe path
]


@pytest.mark.parametrize("b,p,s,din,dout,pos,empty", K5_SHAPES)
@pytest.mark.parametrize("alpha", [0.01, None])
def test_gcn_forms_around_projection(dev, b, p, s, din, dout, pos, empty,
                                     alpha):
    """K5f in both forms and K5b (need_dx, d z_bias) against their plain
    versions at shapes the projection's tiles do not divide (B*N not a
    multiple of 128 rows, Dout 130 in rows of 132 floats, din 33), B = 1
    and a batch of empty egonets; a dense incoming grad, yet dx and d
    z_bias exactly 0 where only invalid slots reach them (dz is 0 there);
    each wrapper launched once."""
    ops, pe_pack = _gcn_inputs(dev, b, p, s, din, dout, pos)
    n = p + 1 + s
    if empty:
        ops[4].zero_()
        ops[5].zero_()
        ops[0].mul_(star.node_mask(ops[4], ops[5], p, n)[..., None])
    valid = star.node_mask(ops[4], ops[5], p, n)
    before = {k: w.launches for k, w in ck.WRAPPERS.items()}
    torch.testing.assert_close(ck.gcn_layer_fwd(*ops, p, alpha=alpha),
                               ck.gcn_layer_fwd_plain(*ops, p, alpha),
                               **TOL)
    kw = dict(pe_pack=pe_pack, seed=31, drop=0.1, alpha=alpha)
    torch.testing.assert_close(ck.gcn_layer_fwd_train(*ops, p, **kw),
                               ck.gcn_layer_train_plain(*ops, p, **kw),
                               **TOL)
    g = torch.randn((b, n, dout), device=dev,
                    generator=torch.Generator(dev).manual_seed(32))
    got = ck.gcn_layer_bwd(g, *ops, p, need_dx=True, need_dzb=True, **kw)
    torch.cuda.synchronize()
    _assert_grads(got, ck.gcn_layer_bwd_plain(g, *ops, p, need_dx=True,
                                              need_dzb=True, **kw))
    assert float(got["x"][~valid].abs().max()) == 0.0
    if empty:   # only the anchor slot is valid in every egonet
        assert float(got["z_bias"][:p].abs().max()) == 0.0
        assert float(got["z_bias"][p + 1:].abs().max()) == 0.0
    assert {k: w.launches - before[k] for k, w in ck.WRAPPERS.items()} == \
        dict.fromkeys(ck.WRAPPERS, 1)


@pytest.mark.parametrize("b,p,s,din,dout,pos", [
    (7, 13, 50, 250, 500, 50),   # the config.mag.json PGCN layer 0
    (5, 5, 64, 33, 130, 0),      # N = 70, Dout 130 (rows of 132 floats)
    (3, 2, 9, 16, 7, 3),         # Dout 7 (rows of 8 floats)
])
@pytest.mark.parametrize("alpha", [0.01, None])
def test_gcn_projection_and_star_pass_match_plain(dev, b, p, s, din, dout,
                                                  pos, alpha):
    """The projection alone (the train form's where the layer has a pe
    path) and the star pass alone on it, each against its plain version;
    each launched once."""
    ops, pe_pack = _gcn_inputs(dev, b, p, s, din, dout, pos)
    x, w, bias, zb, ngp, nsib = ops
    kw = dict(pe_pack=pe_pack, seed=33, drop=0.1) if pos else {}
    before = (ck.gcn_projection.launches, ck.gcn_star.launches)
    z = ck.gcn_projection(x, w, zb, **kw)
    torch.testing.assert_close(z, ck.gcn_projection_plain(x, w, zb, **kw),
                               **TOL)
    got = ck.gcn_star(z, bias, ngp, nsib, p, alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ck.gcn_star_plain(z, bias, ngp, nsib, p,
                                                      alpha), **TOL)
    assert (ck.gcn_projection.launches, ck.gcn_star.launches) == \
        (before[0] + 1, before[1] + 1)


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


# ------------------------- bf16 layers: the bf16 forms of K1-K4, K7 in bf16

BF16_SHAPES = [
    # b, p, s, din, heads, dh, pos: din not a multiple of 8 (rows staged),
    # H*Dh + 2H not a multiple of 8 (P's rows padded), B*N not a multiple
    # of the 128-row tile
    (3, 2, 13, 250, 4, 500, 50),     # PGAT layer 0's widths, N = 16
    (3, 13, 50, 250, 2, 500, 50),    # its mp = 2 shard, N = 64
    (37, 5, 64, 33, 3, 130, 7),      # N = 70, 2590 rows, wd 396
    (3, 13, 50, 2000, 1, 500, 50),   # the PGAT final layer's (x read
                                     # directly in the eval form)
    (3, 13, 50, 3600, 1, 600, 100),  # the MTL per-slot final layer's
    (260, 3, 30, 40, 2, 24, 5),      # 8840 rows: three split-K splits
]


def _bf16(t):
    """A layer's operands in bf16: x, fc, wa1, wa2 rounded, the rest as
    they are."""
    return [a.to(torch.bfloat16) for a in t[:4]] + list(t[4:])


def _assert_close_bf16(got, want, name=""):
    """One bf16 ulp (2**-7 relative) elementwise, plus TOL's atol: both
    sides multiply the same bf16 operands exactly and sum in float32 in
    another order, so before its rounding a result agrees to the float32
    forms' tolerance (where it cancels to near 0 as well), and the rounding
    may then pick the neighbouring bf16 value."""
    assert got.dtype == want.dtype == torch.bfloat16, name
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=TOL["atol"], msg=lambda m: f"{name}: {m}")


def _assert_grads_bf16(got, want):
    """dx, dfc, dwa1, dwa2 in bf16: 2**-6 relative plus 2**-8 of the
    grad's largest value (D rounded to bf16 on both sides from float32
    values that differ by rounding, so an element of D can land one bf16
    ulp apart before the sums over rows); the float32 grads (slot biases,
    the pe path) GTOL's rtol plus 1e-3 of the grad's largest value."""
    assert set(got) == set(want)
    for name in want:
        if want[name] is None or got[name] is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == want[name].dtype, name
        scale = float(want[name].abs().max())
        low = want[name].dtype == torch.bfloat16
        torch.testing.assert_close(
            got[name].float(), want[name].float(),
            rtol=2 ** -6 if low else GTOL["rtol"],
            atol=(2 ** -8 if low else 1e-3) * scale,
            msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos", BF16_SHAPES)
@pytest.mark.parametrize("drop,bits", [(0.0, 32), (0.1, 32), (0.1, 8)])
def test_bf16_projection_k1_k2_match_plain(dev, b, p, s, din, heads, dh, pos,
                                           drop, bits):
    """The bf16 forms of the projection, K1 (the eval form at dropout 0,
    else the train form's store form) and K2 with need_dx on and off
    against their plain versions; the stored K2 equal bits with the
    recompute K2; every launch counted as a bf16 launch, none as a float32
    one."""
    t = _bf16(_inputs(dev, b, p, s, din, heads, dh))
    n = p + 1 + s
    pe = _pe_pack(dev, n, pos, heads, dh) if drop else None
    kw = dict(pe_pack=pe, seed=31, feat_drop=drop, dropout_bits=bits)
    names = ("gat_layer_fwd", "gat_layer_fwd_train_store", "gat_layer_bwd",
             "gat_layer_bwd_stored")
    before = {k: (gk.WRAPPERS[k].launches, gk.WRAPPERS[k].launches_bf16)
              for k in names}
    before_proj = (gk.gat_projection.launches, gk.gat_projection.launches_bf16)
    proj = gk.gat_projection(*t[:7], **kw)
    torch.cuda.synchronize()
    assert (gk.gat_projection.launches, gk.gat_projection.launches_bf16) == (
        before_proj[0], before_proj[1] + 1)
    assert proj.dtype == torch.float32
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
    _assert_close_bf16(out, want, "out")
    g = (torch.randn(out.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(32))
         * 1e-2).to(torch.bfloat16)
    if out_alpha is not None:   # leaky' jumps at 0: no grad near the kink
        pre = gk.gat_layer_train_plain(*t, p, heads,
                                       **dict(tkw, out_alpha=None))
        g = g * (pre.float().abs() > 1e-5)
    for need_dx in (True, False):
        bkw = dict(tkw, need_dx=need_dx)
        got = gk.gat_layer_bwd(g, *t, p, heads, **bkw)
        _assert_grads_bf16(got, gk.gat_layer_bwd_plain(g, *t, p, heads,
                                                       **bkw))
        if attn is not None:
            stored = gk.gat_layer_bwd_stored(g, *t, p, heads, attn, **bkw)
            for name, a in stored.items():
                assert (a is None) == (got[name] is None), name
                assert a is None or torch.equal(a, got[name]), name
    torch.cuda.synchronize()
    after = {k: (gk.WRAPPERS[k].launches, gk.WRAPPERS[k].launches_bf16)
             for k in names}
    calls = {"gat_layer_fwd": 0 if drop else 1,
             "gat_layer_fwd_train_store": 1 if drop else 0,
             "gat_layer_bwd": 2, "gat_layer_bwd_stored": 2 if drop else 0}
    assert after == {k: (before[k][0], before[k][1] + calls[k])
                     for k in names}


@pytest.mark.parametrize("b,p,s,din,heads,dh,pos,empty", POOLED_SHAPES + [
    (3, 13, 50, 2000, 1, 500, 50, False),   # x read directly (eval form)
])
def test_bf16_pooled_forms_match_plain(dev, b, p, s, din, heads, dh, pos,
                                       empty):
    """The bf16 forms of K3 (eval, train, store; pools float32) and K4
    (recompute, stored; dx bf16, zero on invalid slots) against their
    plain versions; stored and recompute grads equal bits."""
    t = _bf16(_inputs(dev, b, p, s, din, heads, dh))
    n = p + 1 + s
    if empty:
        t[7].zero_()
        t[8].zero_()
        t[0] *= star.node_mask(t[7], t[8], p, n)[..., None].to(t[0].dtype)
    got = gk.gat_layer_pooled_fwd(*t, p, heads)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, gk.gat_layer_pooled_fwd_plain(
        *t, p, heads), **TOL)
    kw = dict(pe_pack=_pe_pack(dev, n, pos, heads, dh), seed=33,
              feat_drop=0.1, attn_drop=0.1)
    out = gk.gat_layer_pooled_fwd_train(*t, p, heads, **kw)
    torch.testing.assert_close(out, gk.gat_layer_train_plain(
        *t, p, heads, pooled=True, **kw), **TOL)
    out_s, attn = gk.gat_layer_pooled_fwd_train_store(*t, p, heads, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_s, out)
    g = torch.randn((b, 3, dh), device=dev,
                    generator=torch.Generator(dev).manual_seed(34))
    got = gk.gat_layer_pooled_bwd(g, *t, p, heads, **kw)
    _assert_grads_bf16(got, gk.gat_layer_bwd_plain(g, *t, p, heads,
                                                   pooled=True, **kw))
    mask = star.node_mask(t[7], t[8], p, n)
    if bool((~mask).any()):    # invalid slots get no grad from the pools
        assert float(got["x"][~mask].abs().max()) == 0.0
    stored = gk.gat_layer_pooled_bwd_stored(g, *t, p, heads, attn, **kw)
    torch.cuda.synchronize()
    for name, a in stored.items():
        assert (a is None) == (got[name] is None), name
        assert a is None or torch.equal(a, got[name]), name


def test_bf16_layer_function_on_card_matches_cpu(dev):
    """The differentiable layer with bf16 operands (the model casts float32
    params to bf16 outside it): card forward + K2 against the CPU Function
    (plain versions), grads reaching the float32 leaves."""
    t = _inputs(dev, 12, 4, 20, 24, 2, 36)
    kw = dict(seed=9, feat_drop=0.1, attn_drop=0.1, out_alpha=0.01)
    out = {}
    for d in (dev, torch.device("cpu")):
        leaves = [a.to(d).clone().requires_grad_(True) for a in t[:7]]
        ops = [v.to(torch.bfloat16) for v in leaves[:4]] + leaves[4:]
        y = gk.gat_layer(*ops, t[7].to(d), t[8].to(d), 4, 2, **kw)
        assert y.dtype == torch.bfloat16
        grads = torch.autograd.grad(y.float().square().sum(), leaves)
        out[d.type] = [y.detach().cpu()] + [x.cpu() for x in grads]
    _assert_close_bf16(out["cuda"][0], out["cpu"][0], "out")
    for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=2 ** -6,
                                   atol=2 ** -8 * float(b.abs().max()))


def test_bf16_wrappers_refuse_mixed_dtypes(dev):
    """x, fc, wa1, wa2 all bf16 or all float32: a mix raises; the slot
    biases stay float32; K5 takes a bf16 x only with a bf16 W_h."""
    t = _inputs(dev, 4, 3, 8, 6, 2, 4)
    bf = _bf16(t)
    with pytest.raises(TypeError, match="the kernel takes"):
        gk.gat_layer_fwd(bf[0], t[1], *bf[2:], 3, 2)
    with pytest.raises(TypeError, match="the kernel takes"):
        gk.gat_layer_fwd(t[0], bf[1], *t[2:], 3, 2)
    with pytest.raises(TypeError, match="the kernel takes"):
        gk.gat_layer_pooled_fwd(*bf[:4], bf[4].to(torch.bfloat16), *bf[5:],
                                3, 2)
    w = torch.zeros((6, 5), device=dev)
    with pytest.raises(TypeError, match="float32"):
        ck.gcn_layer_fwd(bf[0], w, torch.zeros(5, device=dev),
                         torch.zeros((12, 5), device=dev), t[7], t[8], 3)


GCN_BF16_SHAPES = [
    # b, p, s, din, dout, pos, only empty egonets
    (37, 5, 64, 33, 130, 7, False),    # N = 70, 2590 rows, Dout 130
    (3, 13, 50, 250, 500, 50, False),  # PGCN layer 0's widths, N = 64
    (3, 13, 50, 500, 500, 50, False),  # PGCN final layer's (x read
                                       # directly in the eval form)
    (260, 3, 30, 40, 24, 5, False),    # 8840 rows: three split-K splits
    (9, 5, 64, 250, 130, 0, True),     # only empty egonets, no pe path
]


@pytest.mark.parametrize("b,p,s,din,dout,pos,empty", GCN_BF16_SHAPES)
@pytest.mark.parametrize("alpha", [0.01, None])
def test_bf16_gcn_forms_match_plain(dev, b, p, s, din, dout, pos, empty,
                                    alpha):
    """The bf16 forms of K5: the projection alone (float32 z), K5f eval and
    train (bf16 output), K5b with need_dx on and off (dx, dW bf16; db, d
    z_bias, the pe grads float32) against their plain versions; dx exactly
    0 on invalid slots; every launch counted as a bf16 launch, none as a
    float32 one."""
    ops, pe_pack = _gcn_inputs(dev, b, p, s, din, dout, pos)
    n = p + 1 + s
    if empty:
        ops[4].zero_()
        ops[5].zero_()
        ops[0].mul_(star.node_mask(ops[4], ops[5], p, n)[..., None])
    ops = (ops[0].to(torch.bfloat16), ops[1].to(torch.bfloat16), *ops[2:])
    valid = star.node_mask(ops[4], ops[5], p, n)
    names = (*ck.WRAPPERS, "gcn_projection")
    counter = lambda k: getattr(ck, k)  # noqa: E731
    before = {k: (counter(k).launches, counter(k).launches_bf16)
              for k in names}
    kw = dict(pe_pack=pe_pack, seed=41, drop=0.1, alpha=alpha)
    pkw = {k: kw[k] for k in ("pe_pack", "seed", "drop")}
    z = ck.gcn_projection(ops[0], ops[1], ops[3], **pkw)
    assert z.dtype == torch.float32
    torch.testing.assert_close(z, ck.gcn_projection_plain(
        ops[0], ops[1], ops[3], **pkw), **TOL)
    _assert_close_bf16(ck.gcn_layer_fwd(*ops, p, alpha=alpha),
                       ck.gcn_layer_fwd_plain(*ops, p, alpha), "eval")
    _assert_close_bf16(ck.gcn_layer_fwd_train(*ops, p, **kw),
                       ck.gcn_layer_train_plain(*ops, p, **kw), "train")
    g = (torch.randn((b, n, dout), device=dev,
                     generator=torch.Generator(dev).manual_seed(42))
         * 1e-2).to(torch.bfloat16)
    if alpha is not None:   # leaky' jumps at 0: no grad near the kink
        pre = ck.gcn_layer_train_plain(*ops, p, **dict(kw, alpha=None))
        g = g * (pre.float().abs() > 1e-5)
    for need_dx in (True, False):
        bkw = dict(kw, need_dx=need_dx, need_dzb=True)
        got = ck.gcn_layer_bwd(g, *ops, p, **bkw)
        torch.cuda.synchronize()
        _assert_grads_bf16(got, ck.gcn_layer_bwd_plain(g, *ops, p, **bkw))
        if need_dx and bool((~valid).any()):
            assert float(got["x"][~valid].abs().max()) == 0.0
    after = {k: (counter(k).launches, counter(k).launches_bf16)
             for k in names}
    calls = {"gcn_layer_fwd": 1, "gcn_layer_fwd_train": 1,
             "gcn_layer_bwd": 2, "gcn_projection": 1}
    assert after == {k: (before[k][0], before[k][1] + calls[k])
                     for k in names}


def test_bf16_gcn_layer_function_on_card_matches_cpu(dev):
    """The differentiable K5 layer with bf16 x and W_h (cast from float32
    leaves): card forward + K5b against the CPU Function (plain
    versions), grads reaching the float32 leaves."""
    ops, pe_pack = _gcn_inputs(dev, 12, 4, 20, 24, 36, 5)
    out = {}
    for d in (dev, torch.device("cpu")):
        leaves = [a.to(d).clone().requires_grad_(True)
                  for a in (*ops[:4], *pe_pack)]
        y = ck.gcn_layer(leaves[0].to(torch.bfloat16),
                         leaves[1].to(torch.bfloat16), *leaves[2:4],
                         ops[4].to(d), ops[5].to(d), 4,
                         pe_pack=tuple(leaves[4:]), seed=9, drop=0.1,
                         alpha=0.01)
        assert y.dtype == torch.bfloat16
        grads = torch.autograd.grad(y.float().square().sum(), leaves)
        out[d.type] = [y.detach().cpu()] + [x.cpu() for x in grads]
    _assert_close_bf16(out["cuda"][0], out["cpu"][0], "out")
    for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=2 ** -6,
                                   atol=2 ** -8 * float(b.abs().max()))


def test_train_step_makes_no_host_sync(dev, tmp_path):
    """One train step of config.mag.json's PGAT at full width (4 groups x
    32 candidates, AMSGrad) after a warm-up step raises nothing under
    torch.cuda.set_sync_debug_mode("error"): no operation of the step waits
    for the device (AMSGrad's bias corrections are filled in on the card,
    the slot codes of the position embeddings too)."""
    import json

    from taxoexpan_torch import builders
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.training.trainer import Trainer, batch_to
    with open("configs/config.mag.json") as fin:
        cfg = json.load(fin)
    loader = dict(cfg["train_data_loader"]["args"], batch_size=4,
                  num_workers=0, max_parents=13, expand_factor=50)
    taxonomy = synthetic_taxonomy(num_nodes=300, dim=250, seed=0)
    sampler = builders.build_sampler(taxonomy, loader, "train")
    model = builders.build_model(cfg["arch"],
                                 max_parents=sampler.max_parents,
                                 expand_factor=sampler.expand_factor)
    params = model.init(torch.Generator().manual_seed(0))
    opt = builders.build_optimizer_from_config(cfg["optimizer"],
                                               cfg["trainer"])
    trainer = Trainer(model, params, opt, opt.init(params),
                      loss_name=cfg["loss"], metric_names=cfg["metrics"],
                      feature_table=sampler.node_features, train_loader=None,
                      save_dir=tmp_path, device=dev)
    batch = batch_to(next(iter(builders.build_loader(sampler, loader))), dev)
    trainer.train_step(batch, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = trainer.train_step(batch, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss))
