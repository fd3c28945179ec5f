"""The repo's other three configuration files through both packages:
`configs/config.wordnet.json` (PGAT, WMR, BIM, the final layer 1 x 300,
N = 54), `config.semeval_noun.json` (LBM, pos 100, N = 64) and
`config.synthetic.json` (in 64, LBM, N = 30). Each is loaded as
published, its widths divided down (in / hidden / out / pos by 25, 25 and
8) and everything else kept: propagation, readout, matcher, heads, its
expand_factor, and the 13 grandparent slots `chip_smoke.py` builds every
path with. One parameter tree in the JAX model's layout, drawn with numpy
(the shapes from `jax.eval_shape` of its init, which compiles nothing: a
jitted init costs 1.1-1.6 s a configuration on the CPU), is carried into
the port with `weights.params_from_jax`; on one numpy batch at dropout 0
the port's graph embeddings and scores of the eval form (the serving
path) and the InfoNCE loss of the train form's scores are held to the JAX
package's eval form (kernel "xla", the plain reference of its Pallas
kernels).
Tolerance 1e-4 relative and absolute (float32 through two layers and the
matcher; LBM's exp keeps the scores' relative error)."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from taxoexpan_torch import builders as t_builders
from taxoexpan_torch import losses as t_losses
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import builders as j_builders
from taxoexpan_tpu import losses as j_losses

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# configuration file -> the divisor of its widths
CUTS = {"config.wordnet.json": 25, "config.semeval_noun.json": 25,
        "config.synthetic.json": 8}
P = 13               # grandparent slots
G, C = 2, 4          # groups x candidates
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, so that parallel test workers do not oversubscribe
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut_config(name: str) -> tuple[dict, int]:
    """The file's arch block with its widths divided down and dropout 0,
    and its expand_factor."""
    cfg = json.loads((CONFIGS / name).read_text())
    args = dict(cfg["arch"]["args"])
    for key in ("in_dim", "hidden_dim", "out_dim", "pos_dim"):
        assert args[key] % CUTS[name] == 0, key
        args[key] //= CUTS[name]
    for key in ("feat_drop", "attn_drop", "hidden_drop", "out_drop"):
        args[key] = 0.0
    return {"args": args}, cfg["train_data_loader"]["args"]["expand_factor"]


def _batch(rng, d: int, s: int):
    b, n = G * C, P + 1 + s
    ngp = rng.integers(0, P + 1, (b,)).astype(np.int32)
    nsib = rng.integers(0, s + 1, (b,)).astype(np.int32)
    ngp[0] = nsib[0] = 0
    ngp[1], nsib[1] = P, s
    valid = np.concatenate([np.arange(P)[None] < ngp[:, None],
                            np.ones((b, 1), bool),
                            np.arange(s)[None] < nsib[:, None]], axis=1)
    x = rng.normal(size=(b, n, d)).astype(np.float32) * valid[..., None]
    qf = rng.normal(size=(b, d)).astype(np.float32)
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    return x, ngp, nsib, qf


@pytest.mark.parametrize("name", sorted(CUTS))
def test_config_file_matches_jax(name):
    arch, s = _cut_config(name)
    jm = j_builders.build_model({"args": dict(arch["args"], kernel="xla")},
                                max_parents=P, expand_factor=s)
    tm = t_builders.build_model(arch, max_parents=P, expand_factor=s)
    # kept as published: matcher, readout, heads, the egonet layout
    assert (tm.matcher.kind, type(tm.readout).__name__) == (
        jm.matcher.kind, type(jm.readout).__name__)
    assert tm.propagate.layer_specs[-1][2] == arch["args"]["heads"][-1]
    rng = np.random.default_rng(7)
    jp = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.1).astype(a.dtype),
        jax.eval_shape(jm.init, jax.random.PRNGKey(2)))
    tp = params_from_jax(jp, tm.init(torch.Generator().manual_seed(0)))
    x, ngp, nsib, qf = _batch(rng, arch["args"]["in_dim"], s)
    labels = np.zeros((G, C), np.float32)
    labels[:, 0] = 1.0
    mask = np.ones((G, C), bool)

    @jax.jit
    def jax_side(params):
        # at dropout 0 the train form computes the eval form's values: one
        # JAX encode (its compile is most of this test's time) is the
        # reference for both of the port's forms
        hg = jm.encode(params, x, ngp, nsib, rng=jax.random.PRNGKey(0),
                       train=False)
        scores = jm.match(params, hg, qf)
        return (hg, scores,
                j_losses.info_nce_loss(scores.reshape(G, C), labels, mask))

    want = [np.asarray(a) for a in jax_side(jp)]
    t = [torch.from_numpy(a) for a in (x, ngp, nsib, qf)]
    with torch.no_grad():
        hg = tm.encode(tp, *t[:3])
        scores = tm.match(tp, hg, t[3])
        s_t = tm.match(tp, tm.encode(tp, *t[:3], train=True),
                       t[3]).reshape(G, C)
        loss = t_losses.info_nce_loss(s_t, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    assert hg.shape == want[0].shape
    np.testing.assert_allclose(hg.numpy(), want[0], **TOL)
    np.testing.assert_allclose(scores.numpy(), want[1], **TOL)
    np.testing.assert_allclose(float(loss), float(want[2]), **TOL)
