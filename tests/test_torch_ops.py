"""Port parity, ops layer: taxoexpan_torch.ops.star against
taxoexpan_tpu.ops.star, and the plain versions of the two CUDA kernels
(taxoexpan_torch.ops.gat_kernels) against the Pallas kernels they replace,
run in interpret mode on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
side is jitted (eager JAX compiles each operation on its own). Tolerance
1e-5 (float32, sums taken in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch.ops import gat_kernels as gk
from taxoexpan_torch.ops import star as tstar
from taxoexpan_tpu.ops import star as jstar
from taxoexpan_tpu.ops.pallas_gat import (fused_gat_layer,
                                          fused_gat_layer_pooled)

TOL = dict(rtol=1e-5, atol=1e-5)
# the sizes of tests/test_pallas_gat.py
P, S = 3, 8
N = P + 1 + S
HEADS, DH, DIN = 2, 4, 6
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counts(rng):
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[:2] = (0, P)              # an empty egonet and a full one
    nsib[:2] = (0, S)
    return ngp, nsib


def _valid(ngp, nsib):
    """[B, N] validity mask, in numpy."""
    return np.concatenate([np.arange(P)[None] < ngp[:, None],
                           np.ones((len(ngp), 1), bool),
                           np.arange(S)[None] < nsib[:, None]], axis=1)


@functools.partial(jax.jit, static_argnames="kind")
def _jax_readouts(h, ngp, nsib, pw, pools, kind):
    return (jstar.readout(h, ngp, nsib, P, kind=kind, position_weights=pw),
            jstar.readout_from_pools(pools, ngp, nsib, kind=kind,
                                     position_weights=pw))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_node_mask_and_raw_channel(rng):
    ngp, nsib = _counts(rng)
    feats = rng.normal(size=(B, N, DIN)).astype(np.float32)
    (jf, jg, js), (tf, tg, ts) = _both(feats, ngp, nsib)
    mask, raw = jax.jit(lambda f, g, s: (jstar.node_mask(g, s, P, N),
                                         jstar.raw_star_channel(f, g, s, P)))(
        jf, jg, js)
    np.testing.assert_array_equal(tstar.node_mask(tg, ts, P, N).numpy(),
                                  np.asarray(mask))
    _close(tstar.raw_star_channel(tf, tg, ts, P), raw)


@pytest.mark.parametrize("kind", ["MR", "WMR", "CR", "SUM"])
def test_readouts(rng, kind):
    ngp, nsib = _counts(rng)
    h = rng.normal(size=(B, N, DH)).astype(np.float32)
    pw = rng.normal(size=(3, 1)).astype(np.float32)
    # the pooled form of the same readout, from per-class masked sums
    hm = h * _valid(ngp, nsib)[..., None]
    pools = np.stack([hm[:, :P].sum(1), hm[:, P], hm[:, P + 1:].sum(1)], 1)
    (jh, jg, js, jw, jp), (th, tg, ts, tw, tp) = _both(h, ngp, nsib, pw,
                                                       pools)
    want, want_pools = _jax_readouts(jh, jg, js, jw, jp, kind)
    _close(tstar.readout(th, tg, ts, P, kind=kind, position_weights=tw),
           want)
    _close(tstar.readout_from_pools(tp, tg, ts, kind=kind,
                                    position_weights=tw), want_pools)
    _close(tstar.readout_from_pools(tp, tg, ts, kind=kind,
                                    position_weights=tw), want)


@pytest.mark.parametrize("mask_output", [True, False])
def test_gat_attention_aggregate(rng, mask_output):
    ngp, nsib = _counts(rng)
    ft = rng.normal(size=(B, N, HEADS, DH)).astype(np.float32)
    a1 = rng.normal(size=(B, N, HEADS)).astype(np.float32)
    a2 = rng.normal(size=(B, N, HEADS)).astype(np.float32)
    (jft, ja1, ja2, jg, js), (tft, ta1, ta2, tg, ts) = _both(
        ft, a1, a2, ngp, nsib)
    want = jax.jit(functools.partial(jstar.gat_attention_aggregate, p=P,
                                     mask_output=mask_output))(
        jft, ja1, ja2, jg, js)
    _close(tstar.gat_attention_aggregate(tft, ta1, ta2, tg, ts, P,
                                         mask_output=mask_output), want)


def _layer_inputs(rng):
    """x (invalid slots zeroed as gather_feats leaves them), fc, the folded
    attention weights and non-zero slot biases (the pos-bias split)."""
    ngp, nsib = _counts(rng)
    x = rng.normal(size=(B, N, DIN)).astype(np.float32)
    x *= _valid(ngp, nsib)[..., None]
    fc = (rng.normal(size=(DIN, HEADS * DH)) * 0.3).astype(np.float32)
    wa1 = (rng.normal(size=(DIN, HEADS)) * 0.3).astype(np.float32)
    wa2 = (rng.normal(size=(DIN, HEADS)) * 0.3).astype(np.float32)
    bias_ft = (rng.normal(size=(N, HEADS * DH)) * 0.3).astype(np.float32)
    bias_a1 = (rng.normal(size=(N, HEADS)) * 0.3).astype(np.float32)
    bias_a2 = (rng.normal(size=(N, HEADS)) * 0.3).astype(np.float32)
    return x, fc, wa1, wa2, bias_ft, bias_a1, bias_a2, ngp, nsib


@pytest.mark.parametrize("out_alpha", [0.01, None])
def test_plain_k1_matches_fused_gat_layer(rng, out_alpha):
    """Every slot, invalid ones included: both keep the formula value there
    (no output mask)."""
    arrays = _layer_inputs(rng)
    j, t = _both(*arrays)
    want = jax.jit(lambda *a: fused_gat_layer(
        *a[:7], None, (a[7], a[8], 0), P, HEADS, 0.2, 0.0, 0.0, out_alpha,
        True))(*j)
    _close(gk.gat_layer_fwd_plain(*t, P, HEADS, out_alpha=out_alpha), want)
    # on a CPU tensor the wrapper is the plain version
    _close(gk.gat_layer_fwd(*t, P, HEADS, out_alpha=out_alpha), want)


def test_plain_k3_matches_fused_gat_layer_pooled(rng):
    arrays = _layer_inputs(rng)
    j, t = _both(*arrays)
    want = jax.jit(lambda *a: fused_gat_layer_pooled(
        *a[:7], None, (a[7], a[8], 0), P, HEADS, 0.2, 0.0, 0.0, True))(*j)
    _close(gk.gat_layer_pooled_fwd_plain(*t, P, HEADS), want)
    _close(gk.gat_layer_pooled_fwd(*t, P, HEADS), want)


def test_wrapper_refuses_other_devices(rng):
    t = [torch.from_numpy(a).to("meta") for a in _layer_inputs(rng)]
    with pytest.raises(ValueError, match="unsupported device"):
        gk.gat_layer_fwd(*t, P, HEADS)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.gat_layer_pooled_fwd(*t, P, HEADS)
