"""Port parity, the model-parallel slice: head tensor parallelism over 'mp'
(models/propagation.py, the trainer's gradient reduction, parallel/mesh.py)
and multi-process evaluation, each against the JAX package.

- The TP forward, the loss and every leaf's gradient of the port's 4 ranks
  (dp 2 x mp 2, heads [2, 2]: layer 0 per slot and gathered, the final
  layer pooled and summed) against JAX's `_fused_call_spmd` on a
  {"dp": 2, "mp": 2} mesh, its Pallas kernels in interpret mode, as
  tests/test_parallel.py:84-137 runs it (rtol 2e-4, atol 1e-5), and once
  in bf16 (tests/test_torch_bf16.py's tolerances: outputs 2e-3 and grads
  5e-3 of their largest value, the loss 1e-4). The port's ranks run as
  threads of this process, their groups simulated in-process
  (`_SimGroup`: every torch.distributed call of parallel/distributed.py on
  a shared rendezvous), so the collectives run the package's own code.
- PGCN on the same dp 2 x mp 2 layout against JAX's `_gcn_call_spmd`:
  GCN has no heads, so every layer runs whole on the mp ranks and every
  leaf's grad is summed over dp alone.
- The launch counters by heads, which tell a sharded launch from a whole
  one.
- The seed fold of a head-sharded layer, and none on a replicated one.
- `python -m taxoexpan_torch.train -d cpu` as 2 gloo processes with
  "parallel": {"dp": 1, "mp": 2} for one epoch against JAX's Trainer on a
  {"dp": 1, "mp": 2} mesh from the same checkpoint (loss rtol 1e-4, params
  atol 2e-5, SGD, as tests/test_torch_parallel.py's 2-rank test), then
  `test_fast -m` and `infer -m` as 2 gloo processes on its checkpoint
  against the single process: the same metrics and predictions, files
  from process 0 alone.
"""
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from taxoexpan_torch import builders as tbuilders
from taxoexpan_torch import test_fast as t_test_fast
from taxoexpan_torch.data.egobatch import EgoBatch, GroupBatch
from taxoexpan_torch.models.propagation import fold_rank
from taxoexpan_torch.ops import dropout
from taxoexpan_torch.parallel import distributed
from taxoexpan_torch.parallel.mesh import DataParallel, Layout
from taxoexpan_torch.training import checkpoint as tckpt
from taxoexpan_torch.training import optim as toptim
from taxoexpan_torch.training.trainer import Trainer, batch_to
from taxoexpan_torch.tree import tree_leaves
from taxoexpan_torch.weights import params_from_jax
from taxoexpan_tpu import builders as jbuilders
from taxoexpan_tpu.data.egobatch import EgoBatch as JEgo
from taxoexpan_tpu.data.egobatch import GroupBatch as JGroup
from taxoexpan_tpu.data.loader import GroupBatchLoader as JLoader
from taxoexpan_tpu.data.synthetic import synthetic_taxonomy as j_synth
from taxoexpan_tpu.losses import info_nce_loss
from taxoexpan_tpu.models import TaxoExpan as JaxTaxoExpan
from taxoexpan_tpu.parallel import make_mesh
from taxoexpan_tpu.train import Trainer as JTrainer
from taxoexpan_tpu.train import checkpoint as jckpt

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors on a machine shared by parallel test workers: one
    intra-op thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------- simulated process groups

class _Rendezvous:
    """The shared state of one simulated group: a slot a member."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=60)


class _SimGroup:
    """One member's handle of a simulated group; `exchange` hands every
    member's tensor to every member."""

    def __init__(self, rdv: _Rendezvous, rank: int):
        self.rdv, self.rank = rdv, rank

    def exchange(self, t: torch.Tensor) -> list:
        self.rdv.slots[self.rank] = t.detach().clone()
        self.rdv.barrier.wait()
        parts = list(self.rdv.slots)
        self.rdv.barrier.wait()
        return parts


class _SimDist:
    """The torch.distributed calls parallel/distributed.py makes, on
    `_SimGroup` handles (sums in rank order)."""

    @staticmethod
    def all_gather(parts, src, group):
        for part, t in zip(parts, group.exchange(src)):
            part.copy_(t)

    @staticmethod
    def all_reduce(t, group):
        parts = group.exchange(t)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        t.copy_(total)


def _layouts(dp: int, mp: int) -> list[Layout]:
    """Rank r's Layout of dp x mp simulated ranks (dp index r // mp, mp
    index r % mp, as parallel/mesh.py lays them out)."""
    world = _Rendezvous(dp * mp)
    dps = [_Rendezvous(dp) for _ in range(mp)]
    mps = [_Rendezvous(mp) for _ in range(dp)]
    out = []
    for r in range(dp * mp):
        d, m = divmod(r, mp)
        out.append(Layout(
            world=DataParallel(dp * mp, r, "gloo", _SimGroup(world, r)),
            dp=DataParallel(dp, d, "gloo", _SimGroup(dps[m], d)),
            mp=DataParallel(mp, m, "gloo", _SimGroup(mps[d], m))
            if mp > 1 else None))
    return out


def _run_ranks(fn, layouts: list) -> list:
    """fn(rank, layout) on a thread a rank; their results in rank order
    (a rank's exception re-raised)."""
    results, errors = [None] * len(layouts), []

    def run(r):
        try:
            results[r] = fn(r, layouts[r])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            for lay in layouts:    # release the peers from their barriers
                for grp in (lay.world, lay.dp, lay.mp):
                    if grp is not None:
                        grp.group.rdv.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,))
               for r in range(len(layouts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a rank thread did not finish"
    if errors:
        raise errors[0]
    return results


@pytest.fixture
def sim_dist(monkeypatch):
    monkeypatch.setattr(distributed, "dist", _SimDist)


# ------------------------------------------ the TP step against JAX's SPMD

ARCH = dict(in_dim=16, hidden_dim=8, out_dim=8, pos_dim=4, num_layers=1,
            heads=[2, 2], feat_drop=0.0, attn_drop=0.0, hidden_drop=0.0,
            out_drop=0.0, max_parents=3, expand_factor=7)
G, C, V = 8, 4, 100


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    b, n = G * C, ARCH["max_parents"] + 1 + ARCH["expand_factor"]
    ego = (rng.integers(0, V, (b, n)).astype(np.int32),
           rng.integers(0, 4, (b,)).astype(np.int32),
           rng.integers(0, 8, (b,)).astype(np.int32))
    ego[1][:2] = [0, 3]
    ego[2][:2] = [0, 7]
    labels = np.zeros((G, C), np.float32)
    labels[:, 0] = 1.0
    return (ego, rng.integers(0, V, (G,)).astype(np.int32), labels,
            rng.normal(size=(V, 16)).astype(np.float32))


@pytest.fixture(scope="module", params=[
    ("PGAT", "float32"), ("PGAT", "bfloat16"), ("PGCN", "float32")],
    ids=["float32", "bfloat16", "pgcn-float32"])
def jax_spmd(request):
    """JAX's forward (eval scores), loss and grads on a dp 2 x mp 2 mesh
    (`_fused_call_spmd` for GAT, `_gcn_call_spmd` for GCN; interpret-mode
    Pallas), with its params."""
    method, dtype = request.param
    jm = JaxTaxoExpan(method, "WMR", "BIM", kernel="pallas",
                      compute_dtype=dtype, **ARCH)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    (ids, ngp, nsib), qids, labels, table = _batch(1)
    mesh = make_mesh({"dp": 2, "mp": 2}, jax.devices()[:4])
    jm.propagate.spmd = (mesh, "dp")
    shard = lambda a: jax.device_put(a, NamedSharding(mesh, P("dp")))  # noqa
    batch = JGroup(ego=JEgo(shard(ids), shard(ngp), shard(nsib)),
                   query_ids=shard(qids), query_feats=None,
                   labels=shard(labels),
                   cand_mask=shard(np.ones((G, C), bool)))
    t = jnp.asarray(table)

    def loss_fn(p):
        s = jm.forward(p, batch, t, rng=jax.random.PRNGKey(1), train=True)
        return info_nce_loss(s, batch.labels, batch.cand_mask)
    scores = jax.jit(lambda p: jm.forward(
        p, batch, t, rng=jax.random.PRNGKey(1), train=False))(jp)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    return method, dtype, jax.tree_util.tree_map(np.asarray, jp), {
        "scores": np.asarray(scores), "loss": float(loss),
        "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}


def _port_ranks(method: str, dtype: str, jp, dp: int, mp: int):
    """Every rank's (eval scores of its dp share, its share's loss, the
    grads its Trainer.train_step reduced) for the batch of `_batch(1)`."""
    (ids, ngp, nsib), qids, labels, table = _batch(1)
    full = GroupBatch(ego=EgoBatch(ids, ngp, nsib), query_ids=qids,
                      query_feats=None, labels=labels,
                      cand_mask=np.ones((G, C), bool))

    def rank(r, layout):
        model = tbuilders.build_model(
            {"args": dict(ARCH, propagation_method=method,
                          compute_dtype=dtype)},
            max_parents=ARCH["max_parents"],
            expand_factor=ARCH["expand_factor"])
        params = params_from_jax(jp, model.init(torch.Generator()))
        opt = toptim.Optimizer(opt_type="SGD", lr=0.0)
        trainer = Trainer(model, params, opt, opt.init(params),
                          loss_name="info_nce_loss",
                          metric_names=["macro_mr"], feature_table=table,
                          train_loader=None, save_dir=_TMP[0] / f"r{r}",
                          device="cpu", layout=layout)
        assert model.propagate.sharded_layers() == (
            [0, 1] if method == "PGAT" else [])
        share = batch_to(distributed.rank_share(full, layout.dp.rank,
                                                layout.dp.size),
                         torch.device("cpu"))
        with torch.no_grad():
            scores = model.forward(trainer.params, share,
                                   trainer.feature_table)
        loss, grads = trainer.train_step(share, 7, return_grads=True)
        return scores.numpy(), float(loss), [g.numpy() for g in
                                              tree_leaves(grads)]
    return _run_ranks(rank, _layouts(dp, mp))


_TMP: list = []


@pytest.fixture(autouse=True)
def _tmp(tmp_path):
    _TMP[:] = [tmp_path]


def _close(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                                   atol=(2e-3 if what == "scores" else 5e-3)
                                   * float(np.abs(want).max()))


def test_tp_step_matches_jax_spmd(jax_spmd, sim_dist):
    """dp 2 x mp 2, dropout 0: PGAT heads [2, 2] (a per-slot sharded layer,
    gathered, and a pooled sharded layer, summed) against JAX's
    `_fused_call_spmd`, and PGCN (no heads: every layer whole on both mp
    ranks, every leaf's grad summed over dp alone) against its
    `_gcn_call_spmd`, on the same mesh: every rank's eval scores (its dp
    share's), its share's loss summed over dp, and every leaf's reduced
    grad; the reduced grads equal on every rank."""
    method, dtype, jp, want = jax_spmd
    ranks = _port_ranks(method, dtype, jp, 2, 2)
    scores = np.concatenate([ranks[0][0], ranks[2][0]])
    _close(scores, want["scores"], dtype, "scores")
    np.testing.assert_allclose(ranks[0][1] + ranks[2][1], want["loss"],
                               rtol=2e-4 if dtype == "float32" else 1e-4)
    assert len(ranks[0][2]) == len(want["grads"])
    for i, (got, w) in enumerate(zip(ranks[0][2], want["grads"])):
        _close(got, w, dtype, f"grad leaf {i}")
    for r in (1, 2, 3):             # the same reduced grads everywhere
        for a, b in zip(ranks[0][2], ranks[r][2]):
            np.testing.assert_array_equal(a, b)
    for r in (1, 3):                 # mp ranks: the same share, same scores
        np.testing.assert_array_equal(ranks[r][0], ranks[r - 1][0])


def test_count_launch_by_heads():
    """A launch counted with the layer's heads on the rank goes to its
    dtype's total and to "<heads>" or "<heads>[bf16]" in
    `launches_by_heads`, which tells a head-sharded launch from a whole
    one; an empty batch counts nothing."""
    from taxoexpan_torch.ops.launch import count_launch

    def wrapper():
        pass
    wrapper.launches = wrapper.launches_bf16 = 0
    wrapper.launches_by_heads = {}
    x = torch.zeros((3, 4))
    for heads, t in ((2, x), (2, x), (1, x), (2, x.bfloat16()),
                     (2, x[:0])):
        count_launch(wrapper, t, heads)
    assert (wrapper.launches, wrapper.launches_bf16) == (3, 1)
    assert wrapper.launches_by_heads == {"2": 2, "1": 1, "2[bf16]": 1}


# ------------------------------------------------------------ seed fold

def test_tp_seed_fold(sim_dist, monkeypatch):
    """A head-sharded layer's seed is seed + d * 1_000_003 + m * 7_368_787
    in int32 wraparound (propagation.py:138-140), and its mp ranks draw
    distinct masks; a layer replicated over mp keeps the dp fold alone, so
    with dropout on the mp ranks' replicated final layer, and the graph
    embeddings after it, stay equal bit for bit."""
    from taxoexpan_torch.models import propagation
    seeds = np.array([0, 5, 2_147_483_646, 1_999_999_999], np.int32)
    for d, m in [(0, 1), (1, 1), (3, 2), (2_000, 5)]:
        want = np.asarray(jnp.asarray(seeds)
                          + jnp.int32(d) * jnp.int32(1_000_003)
                          + jnp.int32(m) * jnp.int32(7_368_787))
        got = [fold_rank(int(s), d, m) for s in seeds]
        np.testing.assert_array_equal(np.asarray(got, np.int64), want)
    masks = [dropout.slot_mask(fold_rank(123, 0, m), dropout.STREAM_FEAT, 4,
                               8, 16, 0.5, torch.device("cpu"))
             for m in (0, 1)]
    assert (masks[0] != masks[1]).any()

    seen = {}
    for name in ("gat_layer", "gat_layer_pooled"):
        def record(*args, _fn=getattr(propagation, name), **kw):
            seen.setdefault(threading.get_ident(), []).append(kw["seed"])
            return _fn(*args, **kw)
        monkeypatch.setattr(propagation, name, record)
    (ids, ngp, nsib), _q, _l, table = _batch(2)
    arch = dict(ARCH, heads=[2, 1], feat_drop=0.5, attn_drop=0.5)

    def rank(r, layout):
        model = tbuilders.build_model(
            {"args": dict(arch, propagation_method="PGAT")},
            max_parents=ARCH["max_parents"],
            expand_factor=ARCH["expand_factor"])
        params = model.init(torch.Generator().manual_seed(0))
        model.propagate.mp = layout.mp
        assert model.propagate.sharded_layers() == [0]
        feats = torch.from_numpy(table[ids]) * torch.from_numpy(
            (np.arange(ids.shape[1]) < 1 + ngp[:, None] + nsib[:, None])
            [..., None].astype(np.float32))
        hg = model.encode(params, feats, torch.from_numpy(ngp),
                          torch.from_numpy(nsib),
                          gen=torch.Generator().manual_seed(9), train=True)
        return hg.detach(), seen[threading.get_ident()]
    (hg0, s0), (hg1, s1) = _run_ranks(rank, _layouts(1, 2))
    raw = int(torch.randint(0, 2_147_483_647, (2,),
                            generator=torch.Generator().manual_seed(9))[0])
    assert s0[0] == fold_rank(raw, 0, 0) != s1[0] == fold_rank(raw, 0, 1)
    assert s0[1] == s1[1]                     # the replicated final layer
    assert torch.equal(hg0, hg1)


# ------------------------------------- the CLIs as gloo processes vs JAX

CLI_ARCH = {"propagation_method": "PGAT", "readout_method": "WMR",
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


def _ranks(args: list, per_rank=lambda r: []) -> list:
    """Two `python -m <args> --coordinator ...` gloo processes, started."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    coord = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", *args, "--coordinator", coord,
         "--num_processes", "2", "--process_id", str(r), *per_rank(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]


def _finish(procs: list) -> list:
    try:
        outs = [proc.communicate(timeout=120)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def tp_cli(tmp_path_factory):
    """One epoch of `python -m taxoexpan_torch.train -d cpu` as 2 gloo
    processes, "parallel": {"dp": 1, "mp": 2} (heads [2, 1]: layer 0
    sharded, the final layer replicated), from a JAX checkpoint, while
    JAX's Trainer trains the same epoch on a {dp: 1, mp: 2} mesh; and,
    meanwhile, `test_fast -m` and `infer -m` as 2 gloo processes each on
    that checkpoint (rank 1 given file names of its own, which must stay
    unwritten)."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    taxo = j_synth(num_nodes=150, dim=16, seed=3)
    taxo.save(str(tmp / "data.pickle.bin"))
    # the port's ranks on the Python sampler, as the JAX loader below
    loader = dict(LOADER, data_path=str(tmp / "data.pickle.bin"),
                  backend="python")
    config = {
        "name": "tp", "seed": 0,
        "arch": {"type": "TaxoExpan", "args": CLI_ARCH},
        "train_data_loader": {"args": loader},
        "validation_data_loader": {"args": dict(loader, sampling_mode=0,
                                                negative_size=12)},
        "test_data_loader": {"args": dict(loader, sampling_mode=0)},
        "optimizer": {"type": "SGD", "args": {"lr": 1e-2}},
        "loss": "info_nce_loss", "metrics": ["macro_mr", "hit_at_1"],
        "trainer": {"epochs": 1, "save_dir": str(tmp / "saved"),
                    "save_period": 1, "monitor": "off",
                    "tensorboardX": False, "full_validation_every": 1},
        "parallel": {"dp": 1, "mp": 2}}
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
    start = tmp / "start"
    start.mkdir()
    (start / "config.json").write_text(json.dumps(config))
    ckpt = start / "epoch0.ckpt"
    jckpt.save_checkpoint(ckpt, params=jp, opt_state=jopt.init(jp),
                          epoch=0, monitor_best=0.0, config=config)
    novel = tmp / "novel.tsv"
    novel.write_text("".join(
        f"new term {i}\t" + " ".join(f"{v:.6f}" for v in row) + "\n"
        for i, row in enumerate(rng.normal(size=(5, 16)))))

    train = _ranks(["taxoexpan_torch.train", "-d", "cpu", "-r", str(ckpt)])
    evals = _ranks(["taxoexpan_torch.test_fast", "-d", "cpu", "-m", "-r",
                    str(ckpt)], lambda r: ["-c", str(tmp / f"case{r}.tsv")])
    infers = _ranks(["taxoexpan_torch.infer", "-d", "cpu", "-m", "-r",
                     str(ckpt), "-t", str(novel)],
                    lambda r: ["-s", str(tmp / f"infer{r}.tsv")])
    try:
        jt = JTrainer(jm, jp, jopt, jopt.init(jp), loss_name=config["loss"],
                      metric_names=config["metrics"],
                      feature_table=sampler.node_features,
                      train_loader=JLoader(sampler, batch_size=6, seed=0,
                                           prefetch=0, backend="python"),
                      config=dict(config, trainer=dict(
                          config["trainer"], full_validation_every=0)),
                      mesh=make_mesh({"dp": 1, "mp": 2}, jax.devices()[:2]),
                      save_dir=tmp / "jax", rng_seed=0)
        jlog = jt._train_epoch(1)
        outs = {"train": _finish(train), "test_fast": _finish(evals),
                "infer": _finish(infers)}
    finally:
        for proc in train + evals + infers:
            proc.kill()
    return {"tmp": tmp, "config": config, "taxo": taxo, "sampler": sampler,
            "ckpt": ckpt, "novel": novel, "jt": jt, "jlog": jlog,
            "outs": outs}


def test_tp_cli_matches_jax_mp_trainer(tp_cli):
    """Rank 0's checkpoint and the epoch loss of the 2-process mp = 2 run
    equal JAX's Trainer on a {dp: 1, mp: 2} mesh; both ranks log the same
    epoch, report their dp and mp indices and end with the same params
    bit for bit; the logged full-catalog validation (the ranker with the
    heads split) equals the single-process ranker's on the trained
    params."""
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    run = next((tp_cli["tmp"] / "saved" / "models" / "tp").iterdir())
    reports = [json.loads((run / f"report-rank{r}.json").read_text())
               for r in (0, 1)]
    assert [(r["dp_index"], r["mp_index"], r["dp"], r["mp"])
            for r in reports] == [(0, 0, 1, 2), (0, 1, 1, 2)]
    assert reports[0]["params_sha256"] == reports[1]["params_sha256"]
    assert reports[0]["log"] == reports[1]["log"] | {
        k: reports[0]["log"][k] for k in ("egonets_per_sec",
                                          "edges_per_sec", "timing",
                                          "epoch_seconds")}
    assert "process layout: dp 1 x mp 2" in tp_cli["outs"]["train"][0]
    np.testing.assert_allclose(reports[0]["log"]["loss"],
                               tp_cli["jlog"]["loss"], rtol=1e-4)
    state = tckpt.load_checkpoint(run / "checkpoint-epoch1.ckpt")
    for a, b in zip(tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(tp_cli["jt"].params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)
    config, sampler = tp_cli["config"], tp_cli["sampler"]
    tm = tbuilders.build_model(config["arch"],
                               max_parents=sampler.max_parents,
                               expand_factor=sampler.expand_factor)
    params = params_from_jax(state["params"],
                             tm.init(torch.Generator().manual_seed(0)))
    fv = tbuilders.build_sampler(
        tp_cli["taxo"], dict(config["validation_data_loader"]["args"],
                             max_parents=sampler.max_parents), "validation")
    res, _ = TaxonomyRanker(tm, params, fv, fv.node_features,
                            device="cpu").evaluate(config["metrics"], 1)
    for m in config["metrics"]:
        np.testing.assert_allclose(reports[0]["log"]["val_" + m], res[m],
                                   rtol=1e-6)


def test_multiprocess_test_fast_and_infer(tp_cli):
    """`test_fast -m` and `infer -m` as 2 gloo processes (anchor encoding
    split over them) write what the single process writes: the case study
    (every query's predictions and metrics) and the predictions, equal;
    only process 0 writes."""
    from taxoexpan_torch import infer as t_infer
    tmp, ckpt = tp_cli["tmp"], str(tp_cli["ckpt"])
    for out in tp_cli["outs"]["test_fast"] + tp_cli["outs"]["infer"]:
        assert "Sharding anchor encoding over 2 processes" in out
    single = t_test_fast.main(t_test_fast.parse_args(
        ["-r", ckpt, "-d", "cpu", "-c", str(tmp / "case_single.tsv")]))
    assert np.isfinite(list(single.values())).all()
    t_infer.main(t_infer.parse_args(["-r", ckpt, "-d", "cpu", "-t",
                                     str(tp_cli["novel"]), "-s",
                                     str(tmp / "infer_single.tsv")]))
    for name in ("case", "infer"):
        assert (tmp / f"{name}0.tsv").read_text() == \
            (tmp / f"{name}_single.tsv").read_text()
        assert not (tmp / f"{name}1.tsv").exists()
    assert f"'macro_mr': {single['macro_mr']!r}" in \
        tp_cli["outs"]["test_fast"][0]
