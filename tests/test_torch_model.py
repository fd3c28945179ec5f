"""Port parity, model layer: the port's PGAT/WMR/BIM `encode`, `match` and
`match_all` against the JAX `TaxoExpan` (XLA path), with the JAX
parameters carried over by `weights.params_from_jax`; every matcher kind;
GAT without positions and a two-layer stack.

Inputs are made with numpy from a seed. Tolerance 1e-4 (float32,
model-level outputs through two layers and a matcher)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch.models import TaxoExpan as TorchTaxoExpan
from taxoexpan_torch.models.matching import Matcher as TorchMatcher
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from taxoexpan_tpu.models.matching import Matcher as JaxMatcher
from taxoexpan_tpu.ops import star as jstar

TOL = dict(rtol=1e-4, atol=1e-4)
P, S = 3, 6
N = P + 1 + S
D = 12
B = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(**kw):
    arch = dict(in_dim=D, hidden_dim=8, out_dim=6, pos_dim=4, num_layers=1,
                heads=[2, 1], max_parents=P, expand_factor=S)
    arch.update(kw)
    methods = (arch.pop("propagation_method", "PGAT"),
               arch.pop("readout_method", "WMR"),
               arch.pop("matching_method", "BIM"))
    jm = JaxTaxoExpan(*methods, kernel="xla", **arch)
    tm = TorchTaxoExpan(*methods, **arch)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tm.init(torch.Generator().manual_seed(0)))
    return jm, jp, tm, tp


def _egonets(rng):
    ngp = rng.integers(0, P + 1, (B,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (B,)).astype(np.int32)
    ngp[0] = nsib[0] = 0
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    x *= np.asarray(jstar.node_mask(jnp.asarray(ngp), jnp.asarray(nsib),
                                    P, N))[..., None]
    return x, ngp, nsib


@pytest.mark.parametrize("kw", [
    {},
    {"raw_channel": True},
    {"readout_method": "CR", "propagation_method": "GAT"},
    {"num_layers": 2, "heads": [2, 2, 1], "readout_method": "MR"},
], ids=["pgat_wmr_bim", "raw_channel", "gat_cr", "two_layers_mr"])
def test_encode_and_match_all(rng, kw):
    jm, jp, tm, tp = _models(**kw)
    x, ngp, nsib = _egonets(rng)
    qf = rng.normal(size=(5, D)).astype(np.float32)
    encode = jax.jit(functools.partial(jm.encode, rng=jax.random.PRNGKey(0),
                                       train=False))
    want = encode(jp, jnp.asarray(x), jnp.asarray(ngp), jnp.asarray(nsib))
    t = [torch.from_numpy(a) for a in (x, ngp, nsib)]
    with torch.no_grad():
        got = tm.encode(tp, *t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            tm.match_all(tp, got, torch.from_numpy(qf)).numpy(),
            np.asarray(jm.match_all(jp, want, jnp.asarray(qf))), **TOL)
        qb = qf[np.arange(B) % 5]
        np.testing.assert_allclose(
            tm.match(tp, got, torch.from_numpy(qb)).numpy(),
            np.asarray(jm.match(jp, want, jnp.asarray(qb))), **TOL)


def test_structure_prior_init():
    """The raw-channel identity block is seeded by both inits."""
    _, jp, tm, _ = _models(raw_channel=True)
    w = tm.init(torch.Generator().manual_seed(1))["match"]["w"]
    l_dim = tm.readout.l_dim
    jw = np.asarray(jp["match"]["w"])
    bound = 1.0 / np.sqrt(l_dim + D)
    for m in (w.numpy(), jw):
        np.testing.assert_array_less(np.abs(m[l_dim:] - np.eye(D)),
                                     bound + 1e-6)


@pytest.mark.parametrize("kind", ["MLP", "PMLP", "BIM", "LBM", "NTN"])
def test_matchers(rng, kind):
    jmat = JaxMatcher(kind, 7, 5, 6)
    tmat = TorchMatcher(kind, 7, 5, 6)
    jp = jax.jit(jmat.init)(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tmat.init(torch.Generator().manual_seed(0)))
    scale = 0.1 if kind == "LBM" else 1.0
    hg = (rng.normal(size=(4, 7)) * scale).astype(np.float32)
    qf = (rng.normal(size=(3, 5)) * scale).astype(np.float32)
    th, tq = torch.from_numpy(hg), torch.from_numpy(qf)
    np.testing.assert_allclose(
        tmat.apply_all(tp, th, tq).numpy(),
        np.asarray(jmat.apply_all(jp, jnp.asarray(hg), jnp.asarray(qf))),
        **TOL)
    np.testing.assert_allclose(
        tmat.apply(tp, th[:3], tq).numpy(),
        np.asarray(jmat.apply(jp, jnp.asarray(hg[:3]), jnp.asarray(qf))),
        **TOL)


def test_params_from_jax_goes_by_key_path():
    _, jp, tm, _ = _models()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    template = tm.init(torch.Generator().manual_seed(0))
    got = params_from_jax(tree, template)
    np.testing.assert_array_equal(
        got["propagate"]["layers"][1]["attn_r"].numpy(),
        tree["propagate"]["layers"][1]["attn_r"])
    np.testing.assert_array_equal(got["readout"]["emb"].numpy(),
                                  tree["readout"]["emb"])
    # extra or missing keys, or another shape, are an architecture mismatch
    bad = dict(tree, match={"w": tree["match"]["w"], "b": np.zeros(1)})
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(bad, template)
    bad = dict(tree, match={"w": tree["match"]["w"].T})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, template)
    # aux heads are carried along
    aux = [{"readout": {}, "match": {"w": np.ones((2, 2), np.float32)}}]
    got = params_from_jax(dict(tree, aux=aux), template)
    assert got["aux"][0]["match"]["w"].shape == (2, 2)
