"""The premise of K4 bf16's valid-rows design (ops/csrc/gat_bwd.cu): the
pooled layer's backward gives nothing to an invalid slot, so its products
may run on the valid rows alone.

- the plain versions (`gat_kernels._bwd_plain_bf16`, and the float32
  pooled backward by autograd) give exact zero rows of D (the grad of the
  layer's projection) and of dx at the invalid slots, with dropout on and
  random features there;
- dW, dpe and the slot-bias grads from the valid rows alone equal the
  all-rows grads within 1e-6 relative (float32 sums of the same terms in
  another order);
- the JAX package's `fused_gat_layer_pooled` VJP (interpret mode, dropout
  0, as tests/test_pallas_gat.py runs it) gives exact zero dx rows there
  too.

Tiny sizes: in 16, 4 heads x 8, pos 4, N = 12, B = 8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import star
from taxoexpan_tpu.ops.pallas_gat import fused_gat_layer_pooled

P, S = 3, 8
N = P + 1 + S
HEADS, DH, DIN, POS = 4, 8, 16, 4
B = 8
REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors on a machine shared by parallel test workers: one
    intra-op thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    """Random features at every slot (the invalid ones too), weights, slot
    biases, the pe path and the pool grads; the first egonets: only the
    anchor, no grandparents, no siblings, full."""
    rng = np.random.default_rng(seed)
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:4], nsib[:4] = (0, 0, P, P), (0, S, 0, S)
    w = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    arrays = [rng.normal(size=(B, N, DIN)).astype(np.float32),
              w(DIN, HEADS * DH), w(DIN, HEADS), w(DIN, HEADS),
              w(N, HEADS * DH), w(N, HEADS), w(N, HEADS)]
    pe = (w(N, POS), w(POS, HEADS * DH), w(POS, HEADS), w(POS, HEADS))
    g = rng.normal(size=(B, 3, DH)).astype(np.float32)
    return arrays, ngp, nsib, pe, g


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _valid(ngp, nsib):
    return star.node_mask(torch.from_numpy(ngp), torch.from_numpy(nsib), P,
                          N).reshape(-1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_d_and_dx_rows_are_zero_at_invalid_slots(dtype):
    arrays, ngp, nsib, pe, g = _inputs()
    ops = _torch(arrays)
    ops[:4] = [t.to(dtype) for t in ops[:4]]
    kw = dict(pe_pack=tuple(_torch(pe)), seed=5, feat_drop=0.1,
              attn_drop=0.1, dropout_bits=32)
    ngp_t, nsib_t = torch.from_numpy(ngp), torch.from_numpy(nsib)
    g_t = torch.from_numpy(g)
    d, _ = gk._projection_grad(g_t, *ops, ngp_t, nsib_t, P, HEADS,
                               kw["pe_pack"], 5, 0.1, 0.1, None, True, 32,
                               None)
    grads = gk.gat_layer_bwd_plain(g_t, *ops, ngp_t, nsib_t, P, HEADS,
                                   pooled=True, **kw)
    invalid = ~_valid(ngp, nsib)
    assert bool(invalid.any()) and bool((~invalid).any())
    assert bool((d.reshape(B * N, -1)[invalid] == 0).all())
    assert bool((grads["x"].reshape(B * N, DIN)[invalid] == 0).all())
    assert bool((d.reshape(B * N, -1)[~invalid] != 0).any())


def test_valid_rows_alone_give_the_grads():
    """The products and sums of the bf16 backward (its plain operands: X
    staged, W packed, D rounded to bf16) over the valid rows alone against
    all rows."""
    arrays, ngp, nsib, pe, g = _inputs(seed=1)
    ops = _torch(arrays)
    ops[:4] = [t.to(torch.bfloat16) for t in ops[:4]]
    pe_pack = tuple(_torch(pe))
    d, (xs, w, _fmask, pmask) = gk._projection_grad(
        torch.from_numpy(g), *ops, torch.from_numpy(ngp),
        torch.from_numpy(nsib), P, HEADS, pe_pack, 7, 0.1, 0.1, None, True,
        32, None)
    d16 = gk.round_bf16(d.reshape(B * N, -1))
    valid = _valid(ngp, nsib)

    def grads(rows):
        dr = d16 * rows[:, None]          # the valid rows' D, zero elsewhere
        pe_rows = ((dr @ w.T)[:, DIN:] * pmask).reshape(B, N, POS)
        xv, dv = xs[rows], d16[rows]      # the compacted operands
        return {"dw": xv.T @ dv, "dpe": pe_rows.sum(dim=0),
                "dbias": dr.reshape(B, N, -1).sum(dim=0)}

    got = grads(valid)
    want = grads(torch.ones_like(valid))
    for name in want:
        scale = float(want[name].abs().max())
        assert scale > 0, name
        err = float((got[name] - want[name]).abs().max())
        assert err <= REL * scale, (name, err, scale)


def test_jax_pooled_vjp_gives_zero_dx_at_invalid_slots():
    arrays, ngp, nsib, _pe, g = _inputs(seed=2)

    @jax.jit
    def jax_vjp(diff, ngp, nsib, cot):
        f = lambda *d: fused_gat_layer_pooled(  # noqa: E731
            *d, None, (ngp, nsib, 0), P, HEADS, 0.2, 0.0, 0.0, True, True)
        _out, vjp = jax.vjp(f, *diff)
        return vjp(cot)

    grads = jax_vjp(tuple(jnp.asarray(a) for a in arrays), ngp, nsib,
                    jnp.asarray(g))
    dx = np.asarray(grads[0]).reshape(B * N, DIN)
    invalid = ~np.asarray(_valid(ngp, nsib))
    assert invalid.any()
    assert (dx[invalid] == 0).all()
    assert (dx[~invalid] != 0).any()
