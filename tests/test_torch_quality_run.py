"""The plumbing of the port's reference-scale quality run
(`python -m taxoexpan_torch.reference_scale_run`): the port's
`synthetic_taxonomy_v2` equals the JAX package's array for array, the
port's numpy copy of the simple_parent baseline gives the JAX one's
metrics (exactly: the same numpy computation), and the run goes end to end
on the CPU at a tiny size (150 nodes, dim 16, widths 8 / 4, 16 groups a
batch, 2 epochs, no tensorboard writer), writing its report with the cuts,
the per-epoch split and the test metrics beside the TPU run's."""
import numpy as np
import pytest
import torch

from taxoexpan_torch import reference_scale_run
from taxoexpan_torch.baselines import simple_parent as t_parent
from taxoexpan_torch.data.synthetic import synthetic_taxonomy_v2 as t_v2
from taxoexpan_tpu.baselines import simple_parent as j_parent
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy_v2 as j_v2

V2 = dict(num_nodes=400, dim=16, max_children=40, noise=1.0, seed=42)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here and in the run's subprocesses, so that
    parallel test workers do not oversubscribe the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def taxonomies():
    return j_v2(**V2), t_v2(**V2)


def test_synthetic_v2_matches_jax(taxonomies):
    jt, tt = taxonomies
    np.testing.assert_array_equal(tt.features, jt.features)
    np.testing.assert_array_equal(tt.edges, jt.edges)
    for split in ("train_node_ids", "validation_node_ids", "test_node_ids"):
        assert list(getattr(tt, split)) == list(getattr(jt, split)), split
    assert tt.vocab == jt.vocab and len(tt.test_node_ids) > 5


def test_simple_parent_matches_jax(taxonomies):
    jt, tt = taxonomies
    want, got = j_parent.evaluate(jt), t_parent.evaluate(tt)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == value, key


def test_simple_parent_in_query_chunks_matches_jax(taxonomies, monkeypatch):
    """simple_parent holds [QUERY_CHUNK, C] distances at a time (at MAG-Full
    scale the whole matrix is 17,777 x 319,446 float32, 22.7 GB): chunks
    of 3 queries give the JAX baseline's unchunked metrics exactly."""
    jt, tt = taxonomies
    monkeypatch.setattr(t_parent, "QUERY_CHUNK", 3)
    want, got = j_parent.evaluate(jt), t_parent.evaluate(tt)
    assert len(tt.test_node_ids) > 3 * 3
    for key, value in want.items():
        assert got[key] == value, key


def test_reference_scale_run_end_to_end_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "REPORT.md"
    res = reference_scale_run.main([
        "--device", "cpu", "--work", str(tmp_path / "work"), "--out",
        str(out), "--nodes", "150", "--dim", "16", "--hidden", "8", "--pos",
        "4", "--batch_size", "16", "--epochs", "2", "--no_tensorboard",
        "--eval_batch_size", "64"])
    assert [r["epoch"] for r in res["epochs"]] == [1, 2]
    for row in res["epochs"]:
        assert {"wait_s", "step_s", "sync_s", "valid_s", "checkpoint_s",
                "egonets_per_sec"} <= set(row)
    assert all(np.isfinite(res["metrics"][m])
               for m in reference_scale_run.QUALITY)
    text = out.read_text()
    assert "cut: 150 nodes, in_dim 16, hidden_dim 8, out_dim 8, pos_dim 4, " \
        "batch_size 16, 2 epochs, no tensorboard writer" in text
    assert "| macro_mr | " in text and "1.0886075949367089" in text
    assert "- card: cpu (no card)" in text
    assert (tmp_path / "work" / "train.log").exists()
    # the evaluation's anchor chunk passed through to test_fast, and every
    # stage, memory peak and the checkpoint's size in the report
    assert "test_fast -r model_best.ckpt -b 64" in text
    stages = res["stages"]
    assert {"data", "samplers"} == set(stages["train_setup"])
    assert {"data", "checkpoint", "encode", "rank"} == set(
        stages["eval_stages"])
    for run in ("train_memory", "eval_memory"):
        assert stages[run]["device_bytes"] == 0    # the CPU
        assert stages[run]["host_rss_kib"] > 0
    assert stages["ckpt_bytes"] > 0 and "not logged" not in text
    assert res["simple_parent"]["num_queries"] > 0
