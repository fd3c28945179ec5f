"""Port parity, the whole serving path: the port's TaxonomyRanker
(evaluate metrics and case-study predictions, predict_parents) against the
JAX ranker on a tiny synthetic taxonomy, with the JAX parameters carried
over; the port's sampler egonets and top-k mask against the JAX package's.

Ranks are integers, so the metrics and the predicted parents must be equal;
the scores behind them agree to float32 rounding and this seed has no
near-ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch.data.synthetic import synthetic_taxonomy as t_synth
from taxoexpan_torch.evaluation.ranker import TaxonomyRanker as TRanker
from taxoexpan_torch.evaluation.ranker import _topk_mask as t_topk_mask
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import builders as jbuilders
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy as j_synth
from taxoexpan_tpu.evaluation import TaxonomyRanker as JRanker
from taxoexpan_tpu.evaluation.ranker import _topk_mask as j_topk_mask

CFG = {"expand_factor": 6, "normalize_embed": True, "sampling_mode": 0,
       "cache_refresh_time": 16}
ARCH = {"propagation_method": "PGAT", "readout_method": "WMR",
        "matching_method": "BIM", "in_dim": 16, "hidden_dim": 8,
        "out_dim": 8, "pos_dim": 4, "num_layers": 1, "heads": [2, 1]}
METRICS = ["macro_mr", "micro_mr", "hit_at_1", "hit_at_3", "mrr_scaled_10"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def taxonomies():
    jt = j_synth(num_nodes=100, dim=16, seed=4)
    tt = t_synth(num_nodes=100, dim=16, seed=4)
    np.testing.assert_array_equal(tt.features, jt.features)
    np.testing.assert_array_equal(tt.edges, jt.edges)
    assert tt.test_node_ids == jt.test_node_ids
    return jt, tt


def _rankers(taxonomies, test_topk, raw_channel):
    jt, tt = taxonomies
    js = jbuilders.build_sampler(jt, CFG, "test", test_topk=test_topk)
    ts = tbuilders.build_sampler(tt, CFG, "test", test_topk=test_topk)
    arch = {"args": dict(ARCH, raw_channel=raw_channel)}
    jm = jbuilders.build_model(arch, max_parents=js.max_parents,
                               expand_factor=js.expand_factor)
    tm = tbuilders.build_model(arch, max_parents=ts.max_parents,
                               expand_factor=ts.expand_factor)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tm.init(torch.Generator().manual_seed(0)))
    kw = dict(encode_chunk=16, query_chunk=4)
    return (JRanker(jm, jp, js, js.node_features, **kw),
            TRanker(tm, tp, ts, ts.node_features, device="cpu", **kw))


def test_anchor_ego_batch_matches(taxonomies):
    jt, tt = taxonomies
    cfg = dict(CFG, expand_factor=2)          # some anchors get sampled
    js = jbuilders.build_sampler(jt, cfg, "test")
    ts = tbuilders.build_sampler(tt, cfg, "test")
    assert ts.max_parents == js.max_parents
    assert ts.node2masks == js.node2masks
    anchors = np.asarray(js.candidate_positions)
    je, te = js.anchor_ego_batch(anchors), ts.anchor_ego_batch(anchors)
    for name in ("node_ids", "ngp", "nsib"):
        np.testing.assert_array_equal(getattr(te, name),
                                      np.asarray(getattr(je, name)))
    assert ts.eval_negatives(ts.node_list[0]) == \
        js.eval_negatives(js.node_list[0])


@pytest.mark.parametrize("test_topk,raw_channel,prior_lambda", [
    (-1, False, None), (5, False, None), (-1, True, 0.5)],
    ids=["full_pool", "test_topk", "raw_channel_prior"])
def test_ranker_matches_jax(taxonomies, test_topk, raw_channel,
                            prior_lambda):
    jr, tr = _rankers(taxonomies, test_topk, raw_channel)
    np.testing.assert_allclose(tr.encode_all_anchors().numpy(),
                               np.asarray(jr.encode_all_anchors()),
                               rtol=1e-4, atol=1e-4)
    for mode in (1, 0):
        jres, jcases = jr.evaluate(METRICS, mode, case_study=True,
                                   prior_lambda=prior_lambda)
        tres, tcases = tr.evaluate(METRICS, mode, case_study=True,
                                   prior_lambda=prior_lambda)
        assert tres == pytest.approx(jres, rel=1e-12)
        assert tcases == jcases
    novel = jr.sampler.node_features[jr.sampler.node_list[:3]] + 0.05
    for mode in (1, 0):
        assert tr.predict_parents(novel, mode, topk=4,
                                  prior_lambda=prior_lambda) == \
            jr.predict_parents(novel, mode, topk=4,
                               prior_lambda=prior_lambda)
    np.testing.assert_allclose(tr.score(novel), jr.score(novel),
                               rtol=1e-4, atol=1e-4)
    if raw_channel:
        lams = [0.0, 0.5, 4.0]
        assert tr.select_prior_lambda(lams, 1, "macro_mr") == \
            jr.select_prior_lambda(lams, 1, "macro_mr")


def test_prior_lambda_needs_raw_channel(taxonomies):
    _, tr = _rankers(taxonomies, -1, False)
    with pytest.raises(ValueError, match="raw_channel"):
        tr.evaluate(METRICS, 1, prior_lambda=1.0)


def test_topk_mask_ties_and_short_rows():
    inf = np.inf
    dist = np.asarray([[0.3, 0.1, 0.3, 0.3, inf, 0.2],
                       [inf, 0.5, inf, inf, inf, inf],
                       [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 3, 4):
        np.testing.assert_array_equal(
            t_topk_mask(torch.from_numpy(dist), k).numpy(),
            np.asarray(j_topk_mask(jnp.asarray(dist), k)))


def test_rank_chunks_keep_only_their_top5(taxonomies, monkeypatch):
    """evaluate collects each query chunk's top-5 columns; each must own
    its [q, 5] storage, not be a slice of the chunk's sorted [q, C] int64
    indices, which would keep every chunk's alive to the end of the
    ranking (at MAG-Full scale 17,777 x 319,446 x 8 bytes = 45 GB, the
    peak device memory of test_fast -b 30000 was 54.75 GB). Ranks and
    predictions as before."""
    from taxoexpan_torch.evaluation import ranker as ranker_mod
    _, tt = taxonomies
    ts = tbuilders.build_sampler(tt, CFG, "test")
    tm = tbuilders.build_model({"args": ARCH}, max_parents=ts.max_parents,
                               expand_factor=ts.expand_factor)
    ranker = TRanker(tm, tm.init(torch.Generator().manual_seed(0)), ts,
                     ts.node_features, device="cpu", query_chunk=2)
    tops = []
    top = ranker_mod._stable_top

    def kept(key, n):
        out = top(key, n)
        tops.append((out, key.shape))
        return out
    monkeypatch.setattr(ranker_mod, "_stable_top", kept)
    result, cases = ranker.evaluate(METRICS, 1, case_study=True)
    assert len(tops) == -(-len(ts.node_list) // 2) > 1
    for out, (q, c) in tops:
        assert c > 5 and out.shape == (q, 5)
        assert out.untyped_storage().nbytes() == q * 5 * 8
    assert len(cases) == 1 + len(ts.node_list)
    assert np.isfinite(result["macro_mr"])
