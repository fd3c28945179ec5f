"""Port parity, pos_mode "concat" (the position embeddings appended to each
layer's input as columns, taxoexpan_tpu/models/propagation.py:387-411,
:520-530): PGAT and PGCN against the JAX package.

- Eval scores and the grads of one train step (dropout 0, every leaf:
  pos_emb and layer 0's fc rows of the pe columns reach their grads only
  through layer 0's input grad, propagation.py:541-542) against the JAX
  model with kernel="xla", at rtol 1e-5 / atol 1e-5 (float32 through two
  layers at these widths; sums in another order).
- PGAT concat in bf16 against the JAX Pallas path (kernel="pallas",
  interpret mode, which takes the concatenated input whole: no slot
  biases, no pe path), at tests/test_torch_bf16.py's model bound: scores
  2e-3 of their largest value, the loss 1e-4, each grad 5e-3 of its leaf's
  largest value.
- bias against concat, the port alone, eval: the same scores from one
  parameter tree (tests/test_pos_bias.py:17's rtol 2e-4 / atol 1e-5).
- Layer 0's input grad summed over a two-rank mp group (heads [2, 2]: both
  layers head-sharded; the pe columns' grads are summed with their pos_emb
  leaf by the trainer's all-reduce over the world) against the JAX
  model's grads of the whole batch, at 1e-5, in tests/test_torch_tp.py's
  simulated process groups.

Inputs made with numpy from a seed and handed to both sides; JAX params
drawn with numpy from the shapes of `jax.eval_shape(init)` and carried
into the port by weights.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch.data.egobatch import EgoBatch, GroupBatch
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer, batch_to
from taxoexpan_torch.tree import tree_leaves, tree_leaves_with_path
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import losses as jlosses
from taxoexpan_tpu.data.egobatch import EgoBatch as JEgo
from taxoexpan_tpu.data.egobatch import GroupBatch as JGroup
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from tests.test_torch_tp import _layouts, _run_ranks, sim_dist  # noqa: F401

P, S = 3, 4
N = P + 1 + S
G, C, V = 4, 3, 30
ARCH = dict(in_dim=6, hidden_dim=4, out_dim=5, pos_dim=3, num_layers=1,
            heads=[2, 2], feat_drop=0.0, attn_drop=0.0, hidden_drop=0.0,
            out_drop=0.0, max_parents=P, expand_factor=S)
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread, so that parallel test workers do
    not oversubscribe the machine; restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed: int):
    """A GroupBatch (an empty and a full egonet first), its JAX twin and a
    feature table."""
    rng = np.random.default_rng(seed)
    b = G * C
    ngp = rng.integers(0, P + 1, (b,)).astype(np.int32)
    nsib = rng.integers(0, S + 1, (b,)).astype(np.int32)
    ngp[:2], nsib[:2] = (0, P), (0, S)
    ids = rng.integers(0, V, (b, N)).astype(np.int32)
    qids = rng.integers(0, V, (G,)).astype(np.int32)
    labels = np.zeros((G, C), np.float32)
    labels[:, 0] = 1.0
    mask = np.ones((G, C), bool)
    table = rng.normal(size=(V, ARCH["in_dim"])).astype(np.float32)
    batch = GroupBatch(ego=EgoBatch(ids, ngp, nsib), query_ids=qids,
                       query_feats=None, labels=labels, cand_mask=mask)
    jbatch = JGroup(ego=JEgo(*map(jnp.asarray, (ids, ngp, nsib))),
                    query_ids=jnp.asarray(qids), query_feats=None,
                    labels=jnp.asarray(labels), cand_mask=jnp.asarray(mask))
    return batch, jbatch, table


def _port_model(method: str, pos_mode: str, dtype: str = "float32"):
    return tbuilders.build_model(
        {"args": dict(ARCH, propagation_method=method, pos_mode=pos_mode,
                      compute_dtype=dtype)},
        max_parents=P, expand_factor=S)


def _models(method: str, dtype: str = "float32", kernel: str = "xla"):
    """The JAX model (pos_mode "concat"), one parameter tree in its layout
    drawn with numpy, the port's model and that tree carried over."""
    jm = JaxTaxoExpan(method, "WMR", "BIM", kernel=kernel,
                      compute_dtype=dtype, pos_mode="concat", **ARCH)
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.4).astype(a.dtype),
        jax.eval_shape(jm.init, jax.random.PRNGKey(3)))
    tm = _port_model(method, "concat", dtype)
    return jm, jp, tm, params_from_jax(jp, tm.init(torch.Generator()))


def _jax_side(jm, jp, jbatch, table) -> dict:
    """JAX's scores, loss and grads of a train step at dropout 0 (at rates
    0 its train forward is its eval forward: no mask is drawn)."""
    t = jnp.asarray(table)

    @jax.jit
    def run(p):
        def loss_fn(q):
            s = jm.forward(q, jbatch, t, rng=jax.random.PRNGKey(1),
                           train=True)
            return jlosses.info_nce_loss(s, jbatch.labels,
                                         jbatch.cand_mask), s
        (loss, scores), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return scores, loss, grads

    scores, loss, grads = run(jp)
    return {"scores": np.asarray(scores), "loss": float(loss),
            "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(
                grads)]}


def _port_side(tm, tp, batch, table, layout=None, save_dir=None) -> dict:
    """The port's eval scores (of the layout's dp share: the whole batch
    here), and the loss and the reduced grads of Trainer.train_step."""
    opt = toptim.Optimizer(opt_type="SGD", lr=0.0)
    trainer = Trainer(tm, tp, opt, opt.init(tp), loss_name="info_nce_loss",
                      metric_names=["macro_mr"], feature_table=table,
                      train_loader=None, save_dir=save_dir, device="cpu",
                      layout=layout)
    tb = batch_to(batch, CPU)
    with torch.no_grad():
        scores = tm.forward(trainer.params, tb, trainer.feature_table)
    loss, grads = trainer.train_step(tb, 7, return_grads=True)
    return {"scores": scores.numpy(), "loss": float(loss),
            "grads": [g.numpy() for g in tree_leaves(grads)],
            "paths": [p for p, _ in tree_leaves_with_path(grads)]}


_PAIRS: dict = {}


def _pair(method: str, tmp_path_factory):
    """(method, JAX's results, the port's, JAX's params) on `_batch(1)`,
    once a method in this module."""
    if method not in _PAIRS:
        jm, jp, tm, tp = _models(method)
        batch, jbatch, table = _batch(1)
        _PAIRS[method] = (method, _jax_side(jm, jp, jbatch, table),
                          _port_side(tm, tp, batch, table,
                                     save_dir=tmp_path_factory.mktemp(
                                         method)), jp)
    return _PAIRS[method]


@pytest.fixture(params=["PGAT", "PGCN"])
def concat_pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory)


def test_concat_eval_matches_jax(concat_pair):
    """PGAT (pooled final layer) and PGCN in pos_mode "concat": the eval
    scores against the JAX model's."""
    _method, want, got, _jp = concat_pair
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)


def test_concat_grads_match_jax(concat_pair):
    """One train step at dropout 0: the loss and every leaf's grad against
    JAX's; the pos_emb grads of layer 0 come only through its input grad,
    so they are nonzero only with need_dx on at layer 0."""
    _method, want, got, _jp = concat_pair
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert len(got["grads"]) == len(want["grads"])
    for path, g, w in zip(got["paths"], got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, **TOL, err_msg=str(path))
    pe0 = got["grads"][got["paths"].index(
        ("propagate", "pos_emb", 0, "emb"))]
    assert np.abs(pe0).max() > 1e-4


def test_pgat_concat_bf16_matches_jax_pallas(tmp_path):
    """PGAT concat with compute_dtype "bfloat16" against the JAX Pallas
    path in interpret mode (its fused kernels take the concatenated input,
    layer 0 with its input grad): scores 2e-3 of their largest value, the
    loss 1e-4, each grad 5e-3 of its leaf's largest value (both sides round
    layer outputs to bf16 from float32 sums in another order)."""
    jm, jp, tm, tp = _models("PGAT", "bfloat16", "pallas")
    batch, jbatch, table = _batch(2)
    want = _jax_side(jm, jp, jbatch, table)
    got = _port_side(tm, tp, batch, table, save_dir=tmp_path)
    scale = float(np.abs(want["scores"]).max())
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=2e-3 * scale)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for path, g, w in zip(got["paths"], got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, rtol=0, err_msg=str(path),
                                   atol=5e-3 * float(np.abs(w).max()))


@pytest.mark.parametrize("method", ["PGAT", "PGCN"])
def test_bias_and_concat_agree(method):
    """One parameter tree, both modes, the port alone: the same eval scores
    (as tests/test_pos_bias.py:17 holds the JAX package's)."""
    batch, _jbatch, table = _batch(3)
    tb = batch_to(batch, CPU)
    bias, concat = (_port_model(method, mode) for mode in ("bias", "concat"))
    params = bias.init(torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = bias.forward(params, tb, torch.from_numpy(table))
        got = concat.forward(params, tb, torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=1e-5)


def test_concat_mp_layer0_grad_sum_matches_jax(  # noqa: F811
        sim_dist, tmp_path, tmp_path_factory):
    """PGAT concat on dp 1 x mp 2 simulated ranks (heads [2, 2]: both
    layers head-sharded, layer 0 with its input grad on): every rank's
    reduced grads, pos_emb's included, against the JAX model's grads of the
    whole batch at 1e-5, and equal on both ranks; the eval scores too."""
    _method, want, _got, jp = _pair("PGAT", tmp_path_factory)
    batch, _jbatch, table = _batch(1)

    def rank(r, layout):
        tm = _port_model("PGAT", "concat")
        tp = params_from_jax(jp, tm.init(torch.Generator()))
        got = _port_side(tm, tp, batch, table, layout=layout,
                         save_dir=tmp_path / f"r{r}")
        assert tm.propagate.sharded_layers() == [0, 1]
        return got

    ranks = _run_ranks(rank, _layouts(1, 2))
    for got in ranks:
        np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
        for path, g, w in zip(got["paths"], got["grads"], want["grads"]):
            np.testing.assert_allclose(g, w, **TOL, err_msg=str(path))
    for a, b in zip(ranks[0]["grads"], ranks[1]["grads"]):
        np.testing.assert_array_equal(a, b)
