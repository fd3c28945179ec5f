"""Port parity, the baselines: `simple_structure`, `xgb_features` and
`simple_mlp` of `taxoexpan_torch.baselines` against the JAX package's on
the same synthetic taxonomy.

Tolerances: simple_structure's metrics and the xgb features, supervision
and queue are exact (the same numpy code on the same inputs). simple_mlp
(MLP, DeepSetMLP, DeepAPGMLP at tiny widths, on the CPU, one torch thread)
from the JAX baseline's own parameters: eval-mode scores and the BCE loss
1e-5 (float32 through three layers, a sum over the batch); one Adam step's
parameters 1e-6 (elementwise float32 updates). The JAX step draws its
dropout from jax.random and the port's from a torch.Generator, bits that
never match, so the step is compared at dropout 0 (the JAX baseline's
hard-coded rate set to 0 for the test); the port's learning check trains
with dropout."""
import sys

import jax
import numpy as np
import pytest
import torch

from taxoexpan_torch.baselines import simple_mlp as tsm
from taxoexpan_torch.baselines import simple_structure as tss
from taxoexpan_torch.baselines import xgb_features as txf
from taxoexpan_torch.data.synthetic import synthetic_taxonomy as t_synth
from taxoexpan_tpu.baselines import simple_mlp as jsm
from taxoexpan_tpu.baselines import simple_structure as jss
from taxoexpan_tpu.baselines import xgb_features as jxf
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy as j_synth

WIDTHS = dict(first_hidden=16, second_hidden=8, negative_size=4, lr=1e-2,
              seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def taxonomies():
    jt = j_synth(num_nodes=200, dim=16, seed=3)
    tt = t_synth(num_nodes=200, dim=16, seed=3)
    np.testing.assert_array_equal(tt.features, jt.features)
    return jt, tt


# --------------------------------------------------------- simple_structure

@pytest.mark.parametrize("beta", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("agg", ["sum", "mean", "min", "max"])
def test_simple_structure_matches_jax(taxonomies, agg, beta):
    jt, tt = taxonomies
    got, want = tss.evaluate(tt, agg=agg, beta=beta), \
        jss.evaluate(jt, agg=agg, beta=beta)
    assert got == want
    assert got["macro_mr"] < got["num_candidates"] / 2.5


# ------------------------------------------------------------- xgb_features

def test_xgb_features_match_jax(taxonomies):
    """Per-pair and batched features (leaves, roots, hubs, the query's own
    parent), the supervision matrix and the negative queue, equal to the
    JAX package's."""
    jt, tt = taxonomies
    jfe, tfe = jxf.FeatureExtractor(jt), txf.FeatureExtractor(tt)
    train = [int(t) for t in tt.train_node_ids]
    cands = sorted(set(train[::7]) | {
        int(np.argmax(np.diff(tt.children.indptr))),
        int(np.argmin(np.diff(tt.parents.indptr)))})
    for q in train[:4] + [int(t) for t in tt.test_node_ids[:2]]:
        cc = sorted(set(cands) | set(tt.parents.neighbors(q).tolist()))
        got = tfe.extract_features_batch(q, cc)
        assert got.shape == (len(cc), txf.NUM_FEATURES)
        np.testing.assert_array_equal(got, jfe.extract_features_batch(q, cc))
        for c in cc[:5]:
            assert tfe.extract_features(q, c) == jfe.extract_features(q, c)
    tx, ty = txf.generate_supervision(tt, negative_size=3, seed=2)
    jx, jy = jxf.generate_supervision(jt, negative_size=3, seed=2)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert ty.sum() > 0 and (ty == 0).sum() > 0
    tq = txf.NegativeQueue(list(range(40)) * 2, seed=1)
    jq = jxf.NegativeQueue(list(range(40)) * 2, seed=1)
    for i in range(12):
        assert tq.sample(i, 7) == jq.sample(i, 7)
        assert tq.sample_avoid_positive_set({i, i + 1}, 9) == \
            jq.sample_avoid_positive_set({i, i + 1}, 9)


def test_xgb_trainer_gated_on_xgboost(monkeypatch):
    """Without xgboost the tuner and the trainer raise naming it (as
    tests/test_baselines.py expects of the JAX package's); the tuner's
    hill climb with an objective of its own visits the grid as the JAX
    package's does."""
    monkeypatch.setitem(sys.modules, "xgboost", None)   # import fails
    with pytest.raises(RuntimeError, match="xgboost"):
        txf.tune_booster(np.zeros((4, 2)), np.zeros(4), np.zeros((2, 2)),
                         np.zeros(2))
    with pytest.raises(RuntimeError, match="xgboost"):
        txf.train_booster(np.zeros((4, 2)), np.zeros(4))
    grid = {"a": [1, 2, 3], "b": [10, 20], "c": [5, 5]}
    runs = []
    for mod in (txf, jxf):
        calls = []

        def objective(params):
            calls.append(dict(params))
            return float(-abs(params["a"] - 2) * 10
                         + (params["b"] if params["a"] == 2 else 0))
        best = mod.tune_booster(grid=grid, defaults={"a": 0, "b": 0, "c": 0},
                                train_fn=objective)
        runs.append((best, calls))
    assert runs[0] == runs[1]
    assert runs[0][0] == ({"a": 2, "b": 20, "c": 5}, 20.0)


# --------------------------------------------------------------- simple_mlp

def _jax_no_dropout(monkeypatch):
    """The JAX baseline's dropout rate (hard-coded 0.5) set to 0."""
    head, sets = jsm._apply_head, jsm._apply_set
    monkeypatch.setattr(jsm, "_apply_head",
                        lambda p, x, rng, train, drop=0.5:
                        head(p, x, rng, train, 0.0))
    monkeypatch.setattr(jsm, "_apply_set",
                        lambda p, ids, embed, rng, train, drop=0.5:
                        sets(p, ids, embed, rng, train, 0.0))


@pytest.mark.parametrize("model", tsm.MODELS)
def test_simple_mlp_matches_jax(taxonomies, model, monkeypatch):
    """From the JAX baseline's parameters: the same sampled batch, the
    eval-mode scores of every candidate for a test query, the batch loss
    and one Adam step (dropout 0)."""
    _jax_no_dropout(monkeypatch)
    jt, tt = taxonomies
    jb = jsm.SimpleMLPBaseline(jt, model=model, **WIDTHS)
    tb = tsm.SimpleMLPBaseline(tt, model=model, device="cpu", **WIDTHS)
    tb.model.drop = 0.0
    tb.load_jax_params(jax.tree_util.tree_map(np.asarray, jb.params))
    assert tb.train_edges == jb.train_edges
    batch = tb._sample_batch(tb.train_edges[:6])
    for got, want in zip(batch, jb._sample_batch(jb.train_edges[:6])):
        np.testing.assert_array_equal(got, want)

    # eval-mode scores of one query against every train candidate
    cand = np.asarray(tt.train_node_ids, np.int32)
    sets = [tb._sets_for(int(a), -1) for a in cand]
    sibs = np.asarray([s for s, _ in sets], np.int32)
    gps = np.asarray([g for _, g in sets], np.int32)
    q = int(tt.test_node_ids[0])
    jscore = jax.jit(lambda p, *a: jb.score(p, *a, jax.random.PRNGKey(0),
                                            False))
    want = np.asarray(jscore(jb.params, cand, np.full_like(cand, q), sibs,
                             gps))
    np.testing.assert_allclose(tb.scores(cand, sibs, gps, q), want,
                               rtol=1e-5, atol=1e-5)

    # one Adam step: its loss, then every parameter
    params, _state, jloss = jb._step(jb.params, jb.opt_state,
                                     *map(np.asarray, batch),
                                     jax.random.PRNGKey(1))
    tloss = tb.step(*batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    tree = tb.model.param_tree()
    want = jax.tree_util.tree_map(np.asarray, params)
    assert sorted(tree) == sorted(want)
    for name in tree:
        for layer in tree[name]:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    tree[name][layer][leaf].detach().numpy(),
                    want[name][layer][leaf], rtol=1e-6, atol=1e-6,
                    err_msg=f"{name}.{layer}.{leaf}")


@pytest.mark.parametrize("model", tsm.MODELS)
def test_simple_mlp_learns(model):
    """tests/test_baselines.py's learning run of the JAX baseline (400
    nodes, default widths, 6 epochs with dropout) on the port: the mean
    batch loss falls, the metrics are finite, and the MLP ranks test
    parents well ahead of chance (about half the candidates)."""
    taxo = t_synth(num_nodes=400, dim=16, seed=3)
    b = tsm.SimpleMLPBaseline(taxo, model=model, negative_size=8, lr=1e-2,
                              device="cpu")
    losses = b.train(epochs=6, batch_size=64, log=lambda *_: None)
    assert losses[-1] < 0.9 * losses[0], losses
    res = b.evaluate()
    assert res["num_queries"] > 0 and np.isfinite(res["macro_mr"])
    if model == "MLP":
        assert res["macro_mr"] < len(taxo.train_node_ids) / 2.5, res
