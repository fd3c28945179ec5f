"""Port parity, the data-parallel slice: the K6 plain version against the
JAX ring exchange, `partitioned_gather` against JAX's per rank, the shard
layout and bucket capacity, the rank fold of the dropout seeds, the
rules of the `parallel` block, and a 2-rank `python -m
taxoexpan_torch.train` (gloo on the CPU, partitioned feature table) against JAX's Trainer on a dp = 2 mesh.

The JAX side runs jitted on the virtual CPU devices (its Pallas ring
kernel in interpret mode, as tests/test_halo.py runs it); the port runs
the P ranks' local halves in one process with the K6 plain version as the
exchange. Gathers are exact: rows compare equal, NaN where a bucket
overflowed. The 2-rank epoch takes the JAX trainer tests' own tolerances
(tests/test_parallel.py): loss rtol 1e-4, params atol 2e-5 (float32 sums
in another order; dropout 0). It trains with SGD: AMSGrad's
g / (sqrt(v) + 1e-8) turns float32 rounding of a near-zero grad into a
step of up to lr (tests/test_torch_train.py), which an epoch of steps
compounds past any fixed tolerance between two frameworks; SGD's update is
linear in the grad, and AMSGrad is held to optax there."""
import json
import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch import train as t_train
from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
from taxoexpan_torch.models.propagation import fold_rank
from taxoexpan_torch.ops import dropout, halo_kernels
from taxoexpan_torch.parallel import distributed, mesh
from taxoexpan_torch.parallel import partition as tpart
from taxoexpan_torch.parallel.halo import RingExchange
from taxoexpan_torch.training import checkpoint as tckpt
from taxoexpan_torch.tree import tree_leaves
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import builders as jbuilders
from taxoexpan_tpu.data.loader import GroupBatchLoader as JLoader
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy as j_synth
from taxoexpan_tpu.parallel import make_mesh
from taxoexpan_tpu.parallel import partition as jpart
from taxoexpan_tpu.parallel.halo import ring_exchange
from taxoexpan_tpu.train import Trainer as JTrainer
from taxoexpan_tpu.train import checkpoint as jckpt

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests move small tensors; on a machine shared by parallel test
    workers torch's default of one intra-op thread a core oversubscribes
    it, so the module runs on one thread and restores the setting after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(p):
    return make_mesh({"dp": p}, jax.devices()[:p])


def _put(x, mesh):
    return jax.device_put(x, NamedSharding(mesh, P("dp")))


# ------------------------------------------------------------------- K6

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_ring_exchange(dtype):
    """Each rank's answers of the port's K6 plain version equal JAX's ring
    kernel's (interpret mode, 4 devices), zeros on out-of-range slots."""
    p, v, d, cap = 4, 64, 4, 8
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(v, d)).astype(np.float32)
    if dtype == "bfloat16":
        feats = np.asarray(jnp.asarray(feats, jnp.bfloat16).astype(
            jnp.float32))
    # local slots: rows 0..15 of a 16-row shard, a third out of range
    req = rng.integers(0, v // p, size=(p, p, cap)).astype(np.int32)
    req[..., ::3] = rng.integers(v // p, 4 * v, size=req[..., ::3].shape)
    mesh = _mesh(p)
    table = jpart.shard_table(feats.astype(jnp.dtype(dtype)), mesh, "dp")
    ring = jax.jit(jax.shard_map(
        lambda t, r: ring_exchange(t, r[0], axis="dp", p=p,
                                   interpret=True)[None],
        mesh=mesh, in_specs=(P("dp", None), P("dp")), out_specs=P("dp"),
        check_vma=False))
    want = np.asarray(ring(table, _put(req, mesh)))
    shards = [torch.from_numpy(s).to(getattr(torch, dtype))
              for s in tpart.shard_table(feats, p)]
    for r in range(p):
        got = halo_kernels.halo_gather(shards, torch.from_numpy(req[r]))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want[r])
    assert not want[:, :, ::3].any()       # out-of-range slots: zero rows


# ---------------------------------------------------- partitioned_gather

def _ids(case, rng):
    if case == "dense":
        return rng.integers(0, 128, size=(16, 5)).astype(np.int32)
    if case == "duplicates":     # tests/test_parallel.py:230
        return np.repeat(8 * rng.integers(0, 8, size=(16, 1)), 5,
                         axis=1).astype(np.int32)
    # overflow (tests/test_parallel.py:246): 20 distinct ids a rank, all
    # owned by rank 0, against buckets of 8
    return np.concatenate([4 * rng.permutation(32)[:20]
                           for _ in range(4)]).reshape(16, 5).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_gather():
    mesh = _mesh(4)
    fn = jax.jit(lambda t, i: jpart.partitioned_gather(
        t, i, mesh, "dp", capacity_factor=1.0, impl="all_to_all"))
    feats = np.random.default_rng(2).normal(size=(128, 4)).astype(
        np.float32)
    return mesh, fn, feats, jpart.shard_table(feats, mesh, "dp")


@pytest.mark.parametrize("case", ["dense", "duplicates", "overflow"])
def test_partitioned_gather_matches_jax(jax_gather, case):
    """Per rank, the port's partitioned_gather (dedup, bucketing by owner,
    cap, NaN poisoning, un-bucketing; the K6 plain version as the
    exchange) equals JAX's on a dp = 4 mesh."""
    mesh, fn, feats, table = jax_gather
    ids = _ids(case, np.random.default_rng(3))
    want = np.asarray(fn(table, _put(ids, mesh)))
    shards = [torch.from_numpy(s) for s in tpart.shard_table(feats, 4)]
    exchange = lambda req: halo_kernels.halo_gather(shards, req)  # noqa
    counter = torch.zeros((), dtype=torch.int64)
    for r, ids_r in enumerate(np.split(ids, 4)):
        got = tpart.partitioned_gather(torch.from_numpy(ids_r), exchange, 4,
                                       capacity_factor=1.0, overflow=counter)
        np.testing.assert_array_equal(got.numpy(), want[4 * r:4 * r + 4])
    poisoned = np.isnan(want).any(axis=-1)
    np.testing.assert_array_equal(want[~poisoned], feats[ids[~poisoned]])
    assert poisoned.any() == (case == "overflow") == (int(counter) > 0)


def test_shard_table_and_bucket_capacity():
    feats = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    for p in (1, 2, 4):
        want = np.asarray(jpart.shard_table(feats, _mesh(p), "dp"))
        np.testing.assert_array_equal(tpart.shard_table(feats, p),
                                      want.reshape(p, -1, 3))
    for n, p, f in [(512, 8, 2.0), (512, 8, 1.0), (10, 8, 2.0), (4, 8, 2.0),
                    (512, 1, 2.0), (131072, 2, 2.0), (64, 2, 2.0)]:
        assert tpart.bucket_capacity(n, p, f) == \
            jpart.bucket_capacity(n, p, f)


def test_halo_impl_selection(monkeypatch):
    monkeypatch.delenv("TAXOEXPAN_HALO", raising=False)
    assert tpart.halo_impl() == "all_to_all"
    monkeypatch.setenv("TAXOEXPAN_HALO", "ring")
    assert tpart.halo_impl() == "ring"
    monkeypatch.setenv("TAXOEXPAN_HALO", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        tpart.halo_impl()
    with pytest.raises(ValueError, match="CUDA IPC"):
        RingExchange(torch.zeros(4, 2), None, torch.device("cpu"))


def test_refuses_tensor_parallel_only(monkeypatch, caplog):
    """The `parallel` block's rules (the JAX train.py:69-106): dp x mp must
    match the processes; mp falls back to 1 with a warning where it does
    not divide the processes or divides none of the head counts."""
    assert mesh.layout() is None and mesh.layout(1) is None
    with pytest.raises(ValueError, match="dp=2"):
        mesh.layout(dp=2)
    with pytest.raises(ValueError, match="mp=2"):
        mesh.layout(mp=2)

    def config(par, heads=(4, 1)):
        return {"arch": {"args": {"heads": list(heads)}}, "parallel": par}
    with caplog.at_level(logging.WARNING, logger="taxoexpan_torch.train"):
        assert t_train._parallel(config({"mp": 2})) == (None, "replicated")
    assert "parallel.mp=2 does not divide 1 processes" in caplog.text
    # two processes: the layout the block asks for
    calls = []
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "layout", lambda dp, mp: calls.append((dp, mp)))
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="taxoexpan_torch.train"):
        t_train._parallel(config({"mp": 2}, heads=(1, 3)))
        assert "divides none of the head counts [1, 3]" in caplog.text
        caplog.clear()
        t_train._parallel(config({"mp": 2}))
        t_train._parallel(config({"dp": 1, "mp": 2}))
        t_train._parallel(config({"dp": 2}))
    assert not caplog.text
    assert calls == [(None, 1), (None, 2), (1, 2), (2, 1)]


# -------------------------------------------------------------- seeds

def test_rank_seed_fold():
    """seed + rank * 1_000_003 in int32 wraparound, as the JAX package's
    shard_map bodies fold the 'dp' index (propagation.py:138, :173); two
    ranks draw different masks."""
    seeds = np.array([0, 5, 2_147_483_646, 1_999_999_999], np.int32)
    for rank in (0, 1, 3, 2_000):
        want = np.asarray(jnp.asarray(seeds) + jnp.int32(rank)
                          * jnp.int32(1_000_003))
        got = [fold_rank(int(s), rank) for s in seeds]
        np.testing.assert_array_equal(np.asarray(got, np.int64), want)
    masks = [dropout.slot_mask(fold_rank(123, r), dropout.STREAM_FEAT, 4, 8,
                               16, 0.5, torch.device("cpu"))
             for r in (0, 1)]
    assert (masks[0] != masks[1]).any()
    model = tbuilders.build_model(
        {"args": {"propagation_method": "PGCN", "in_dim": 6,
                  "hidden_dim": 4, "out_dim": 4, "pos_dim": 2,
                  "feat_drop": 0.5, "hidden_drop": 0.5, "out_drop": 0.5}},
        max_parents=2, expand_factor=3)
    params = model.init(torch.Generator().manual_seed(0))["propagate"]
    x = torch.ones((2, 6, 6))
    ngp, nsib = torch.tensor([2, 1]), torch.tensor([3, 2])
    outs = []
    for rank in (0, 1):
        model.propagate.rank = rank
        outs.append(model.propagate.apply(
            params, x, ngp, nsib, 2, gen=torch.Generator().manual_seed(9),
            train=True))
    assert not torch.equal(*outs)


# ------------------------------------------------ the 2-rank CLI vs JAX

ARCH = {"propagation_method": "PGAT", "readout_method": "WMR",
        "matching_method": "BIM", "in_dim": 16, "hidden_dim": 8,
        "out_dim": 8, "pos_dim": 4, "num_layers": 1, "heads": [2, 1],
        "feat_drop": 0.0, "attn_drop": 0.0, "kernel": "xla"}
LOADER = {"sampling_mode": 1, "batch_size": 6, "negative_size": 5,
          "expand_factor": 6, "normalize_embed": True,
          "cache_refresh_time": 16, "num_workers": 0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_cli_matches_jax_dp_trainer(tmp_path):
    """Two `python -m taxoexpan_torch.train -d cpu` rank processes (gloo,
    partitioned table, the default all_to_all exchange, full-catalog
    validation through the ranker's data-parallel encode) train one epoch
    from a JAX checkpoint; rank 0's checkpoint and the epoch loss equal
    JAX's Trainer on a dp = 2 partitioned mesh, and the logged validation
    equals the single-process ranker's on the trained params."""
    taxo = j_synth(num_nodes=150, dim=16, seed=3)
    taxo.save(str(tmp_path / "data.pickle.bin"))
    loader = dict(LOADER, data_path=str(tmp_path / "data.pickle.bin"))
    config = {
        "name": "dp", "seed": 0,
        "arch": {"type": "TaxoExpan", "args": ARCH},
        "train_data_loader": {"args": loader},
        "validation_data_loader": {"args": dict(loader, sampling_mode=0,
                                                negative_size=12)},
        "optimizer": {"type": "SGD", "args": {"lr": 1e-2}},
        "loss": "info_nce_loss", "metrics": ["macro_mr", "hit_at_1"],
        "trainer": {"epochs": 1, "save_dir": str(tmp_path / "saved"),
                    "save_period": 1, "monitor": "off",
                    "tensorboardX": False, "full_validation_every": 1},
        "parallel": {"dp": 2, "feature_mode": "partitioned"}}
    # one set of params for both packages, drawn with numpy in JAX's layout;
    # the JAX loader on its Python backend, batch for batch the port's
    sampler = jbuilders.build_sampler(taxo, loader, "train")
    jm = jbuilders.build_model(config["arch"],
                               max_parents=sampler.max_parents,
                               expand_factor=sampler.expand_factor)
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    jopt = jbuilders.build_optimizer_from_config(config["optimizer"],
                                                 config["trainer"])
    start = tmp_path / "start"
    start.mkdir()
    (start / "config.json").write_text(json.dumps(config))
    jckpt.save_checkpoint(start / "epoch0.ckpt", params=jp,
                          opt_state=jopt.init(jp), epoch=0,
                          monitor_best=0.0, config=config)

    # the two ranks run while the JAX side computes
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("TAXOEXPAN_HALO", None)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "taxoexpan_torch.train", "-d", "cpu",
         "-r", str(start / "epoch0.ckpt"), "--coordinator", coord,
         "--num_processes", "2", "--process_id", str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    try:
        jt = JTrainer(jm, jp, jopt, jopt.init(jp), loss_name=config["loss"],
                      metric_names=config["metrics"],
                      feature_table=sampler.node_features,
                      train_loader=JLoader(sampler, batch_size=6, seed=0,
                                           prefetch=0, backend="python"),
                      config=dict(config, trainer=dict(
                          config["trainer"], full_validation_every=0)),
                      mesh=_mesh(2),
                      feature_mode="partitioned", save_dir=tmp_path / "jax",
                      rng_seed=0)
        jlog = jt._train_epoch(1)
        outputs = [proc.communicate(timeout=120)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0, out[-3000:]

    run = next((tmp_path / "saved" / "models" / "dp").iterdir())
    reports = [json.loads((run / f"report-rank{r}.json").read_text())
               for r in (0, 1)]
    assert [r["feature_mode"] for r in reports] == ["partitioned"] * 2
    assert reports[0]["log"] == reports[1]["log"] | {
        k: reports[0]["log"][k] for k in ("egonets_per_sec",
                                          "edges_per_sec", "timing",
                                          "epoch_seconds")}
    np.testing.assert_allclose(reports[0]["log"]["loss"], jlog["loss"],
                               rtol=1e-4)
    state = tckpt.load_checkpoint(run / "checkpoint-epoch1.ckpt")
    assert not (run / "checkpoint-epoch1.ckpt.tmp").exists()
    for a, b in zip(tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(jt.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)

    # full-catalog validation of the 2-rank run == the single-process ranker
    tm = tbuilders.build_model(config["arch"],
                               max_parents=sampler.max_parents,
                               expand_factor=sampler.expand_factor)
    params = params_from_jax(state["params"],
                             tm.init(torch.Generator().manual_seed(0)))
    fv = tbuilders.build_sampler(
        taxo, dict(config["validation_data_loader"]["args"],
                   max_parents=sampler.max_parents), "validation")
    res, _ = TaxonomyRanker(tm, params, fv, fv.node_features,
                            device="cpu").evaluate(config["metrics"], 1)
    for m in config["metrics"]:
        np.testing.assert_allclose(reports[0]["log"]["val_" + m], res[m],
                                   rtol=1e-6)
