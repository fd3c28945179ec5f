"""Training runtime (port of `taxoexpan_tpu/train/trainer.py`).

One train step is model.forward (in train mode: for GAT/PGAT the K1/K3
train-form kernels, K2/K4 in the backward; for GCN/PGCN the K5 train form
and K5b) -> loss -> torch.autograd.grad -> the optimizer's update (a model
with auxiliary MTL heads: model.forward_heads and the mean of the per-head
losses, trainer.py:257-283; evaluation uses the primary head), with a
torch.Generator derived from (seed, epoch, batch) for the dropout seeds
(trainer.py:266, :370). Epoch-level semantics
follow the JAX trainer: mean loss over batches, sampled validation
(metrics averaged over validation batches) or full-catalog validation
through the ranker every `full_validation_every` epochs, ReduceLROnPlateau
on validation metric 0 (mode min) or 2 (mode max), "min val_macro_mr"
style monitoring with early stop, periodic checkpoints plus model_best,
and resume.

Data parallelism (`dp`, one process a rank; trainer.py:180-235): every
rank samples the same host-global batch and trains on its contiguous share
of groups, with the rank folded into the dropout seeds (models/
propagation.py:fold_rank). The losses are sums over groups, so the step's
gradient is the SUM of the ranks' gradients: one all-reduce a step, before
the optimizer's update (an average, as DistributedDataParallel takes it,
would divide the gradient by the number of ranks). The feature table is
replicated on every rank (`feature_mode="replicated"`) or row-partitioned
across them (`"partitioned"`): then egonet and query features come through
`parallel/partition.py:partitioned_gather` and the exchange that
TAXOEXPAN_HALO selects (all_to_all, or ring on K6). The epoch's losses,
summed over the ranks, and the count of its steps' overflowed halo
requests come back in one readback an epoch, the sampled validation's
overflow in a second one after it (both in the epoch log's
`halo_overflow`); sampled validation scores each rank's share and
all-gathers the scores; full-catalog validation runs the ranker's
data-parallel encode. Checkpoints and the tensorboard writer are rank 0's;
every rank resumes from the same checkpoint.

Head tensor parallelism (`layout.mp`, parallel/mesh.py; the JAX trainer's
{"dp", "mp"} mesh): the ranks of one dp group split the batch as above,
the mp ranks of one dp index take the same share and split the heads of
the GAT layers whose head count mp divides (models/propagation.py). Params
and optimizer state stay whole and equal on every rank
(trainer.py:193-208). The grads of those layers' leaves (fc, attn_l,
attn_r and their pos_emb rows, which feed every head) are partial on each
mp rank, this rank's heads' part, and are summed over the world; every
other leaf lies after the mp gather or sum, gets the same grad on every
mp rank and is summed over the dp group alone. The epoch's losses are
summed over the dp group, validation gathers scores and encodings over it,
and the dropout seeds of a sharded layer fold the mp index in.

The runtime around the epochs (trainer.py:173-177, :366-377, :442-462,
:510-518, :610-693):
- the profiler window: with `profile_dir`, torch.profiler traces batches
  `_profile_window` = (10, 15) of epoch 1 (CPU and CUDA activity), closes
  the window on finished work (the device synchronised) and exports a
  Chrome trace, profile_dir/trace.json (under data parallelism
  profile_dir/rank<r>/trace.json);
- checkpoints in the background: the foreground clones params and
  optimizer state on the device, a non-daemon thread reads the clone back
  once and writes the epoch checkpoint and model_best from that one host
  snapshot; at most two writes in flight, each joining its predecessor;
  joined at the end of `train` and before `resume`;
- the validation prefetch: the sampled validation's batches are sampled
  and staged on a thread during the train epoch and joined in
  `_valid_epoch`, which runs before the epoch's one loss readback (none on
  full-validation epochs);
- parameter histograms after each sampled validation, with a tensorboard
  writer, one a parameter leaf named by its key path.
"""
from __future__ import annotations

import hashlib
import json
import logging
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import metrics as metrics_mod
from ..data.egobatch import EgoBatch, GroupBatch
from ..losses import get_loss
from ..ops import star
from ..parallel import distributed
from ..parallel.mesh import Layout
from ..parallel.partition import (halo_impl, make_exchange,
                                  partitioned_gather, shard_table)
from ..tree import (tree_leaves, tree_leaves_with_path, tree_map,
                    tree_unflatten)
from ..weights import params_to, to_numpy
from ..writer import TensorboardWriter
from . import checkpoint as ckpt_mod
from .optim import PlateauScheduler, get_lr

STEP_STRIDE = 1_000_003   # step index = epoch * STEP_STRIDE + batch


def step_generator(seed: int, step_idx: int) -> torch.Generator:
    """The per-step generator of the dropout seeds: a pure function of
    (seed, step index), like the JAX trainer's fold_in(key(seed), step)."""
    return torch.Generator().manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (step_idx & 0xFFFFFFFF))


def batch_to(batch: GroupBatch, device: torch.device) -> GroupBatch:
    """The batch's arrays as tensors on `device` (pinned, asynchronous
    copies on CUDA)."""
    def put(a):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t
    ego = batch.ego
    return GroupBatch(ego=EgoBatch(node_ids=put(ego.node_ids),
                                   ngp=put(ego.ngp), nsib=put(ego.nsib)),
                      query_ids=put(batch.query_ids),
                      query_feats=put(batch.query_feats),
                      labels=put(batch.labels),
                      cand_mask=put(batch.cand_mask))


class _DeviceFeed:
    """Stage batches on the device from a background thread, with the
    host-side batch statistics (egonet and edge counts). Yields
    (host_batch, device_batch, n_egonets, n_edges); with `dp` (a dp group)
    the device batch is this dp index's share of the host batch, the
    counts the whole batch's."""

    def __init__(self, loader, device: torch.device, depth: int = 2,
                 dp=None):
        self.loader = loader
        self.device = device
        self.depth = depth
        self.dp = dp

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: list[BaseException] = []

        def producer():
            try:
                for batch in self.loader:
                    n_egonets = int(np.asarray(batch.cand_mask).sum())
                    ngp = np.asarray(batch.ego.ngp)
                    nsib = np.asarray(batch.ego.nsib)
                    n_edges = int(ngp.sum() + nsib.sum()
                                  + (ngp + 1 + nsib).sum())
                    share = batch if self.dp is None else \
                        distributed.rank_share(batch, self.dp.rank,
                                               self.dp.size)
                    q.put((batch, batch_to(share, self.device), n_egonets,
                           n_edges))
            except BaseException as e:  # surface in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]


class Trainer:
    def __init__(self, model, params: dict, optimizer, opt_state: dict, *,
                 loss_name: str,
                 metric_names: list[str],
                 feature_table,
                 train_loader,
                 valid_loader=None,
                 config: dict | None = None,
                 lr_scheduler: PlateauScheduler | None = None,
                 save_dir: str | Path = "saved/run",
                 log_dir: str | Path | None = None,
                 rng_seed: int = 0,
                 start_epoch: int = 1,
                 monitor_best: float | None = None,
                 full_valid_sampler=None,
                 device: torch.device | str = "cuda",
                 encode_chunk: int = 4096,
                 layout: Layout | None = None,
                 feature_mode: str = "replicated",
                 profile_dir: str | Path | None = None):
        """`layout`: the run's dp x mp process layout (parallel/mesh.py),
        None for a single process."""
        self.device = torch.device(device)
        self.layout = layout
        dp = layout.dp if layout is not None else None
        if feature_mode not in ("replicated", "partitioned"):
            raise ValueError(f"unknown feature_mode {feature_mode!r}")
        if feature_mode == "partitioned" and dp is None:
            raise ValueError("feature_mode='partitioned' requires data "
                             "parallelism (a run of several processes)")
        self.dp = dp
        self.feature_mode = feature_mode
        self.model = model
        # the rank's dropout seeds (models/propagation.py:fold_rank) and
        # the heads' mp group
        model.propagate.rank = dp.rank if dp is not None else 0
        model.propagate.mp = layout.mp if layout is not None else None
        self.params = params_to(params, self.device)
        self.optimizer = optimizer
        self.opt_state = params_to(opt_state, self.device)
        self.loss_name = loss_name
        self.loss_fn = get_loss(loss_name)
        self.metric_names = list(metric_names)
        self.metric_fns = [metrics_mod.get_metric(m) for m in metric_names]
        self.rank_mode = 1 if loss_name.startswith("info_nce") else 0
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.lr_scheduler = lr_scheduler
        self.config = config or {}
        self.logger = logging.getLogger("trainer")
        self.encode_chunk = encode_chunk

        cfg_t = self.config.get("trainer", {})
        self.epochs = cfg_t.get("epochs", 10)
        self.save_period = cfg_t.get("save_period", 1)
        self.monitor = cfg_t.get("monitor", "off")
        # the port's own key: synchronise after each step and log the step
        # times (a device wait per step; off by default)
        self.step_timing = bool(cfg_t.get("step_timing", False))
        if self.monitor == "off":
            self.mnt_mode, self.mnt_metric = "off", None
            self.mnt_best = 0.0
            self.early_stop = float("inf")
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            assert self.mnt_mode in ("min", "max")
            self.mnt_best = float("inf") if self.mnt_mode == "min" \
                else float("-inf")
            self.early_stop = cfg_t.get("early_stop", float("inf"))
        if monitor_best is not None:
            self.mnt_best = monitor_best
        self.start_epoch = start_epoch

        # full-catalog validation every K epochs; monitor, plateau and early
        # stop act only on those epochs when K > 1
        self.full_valid_sampler = full_valid_sampler
        self.full_validation_every = int(
            cfg_t.get("full_validation_every", 0) or 0)
        if self.full_validation_every > 0 and full_valid_sampler is None:
            raise ValueError("trainer.full_validation_every is set but no "
                             "full_valid_sampler was provided")
        self._full_ranker = None
        # the sampled validation's batches, staged during the train epoch
        self._valid_prefetch = None

        # the profiler window: batches [start, stop] of epoch 1
        self.profile_dir = Path(profile_dir) if profile_dir else None
        self._profile_window = (10, 15)
        self._profiler = None

        # background checkpoint writes in flight (oldest first) and their
        # errors
        self._ckpt_pending: list[threading.Thread] = []
        self._ckpt_errors: list[BaseException] = []

        self.checkpoint_dir = Path(save_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.writer = TensorboardWriter(
            log_dir or self.checkpoint_dir,
            enabled=cfg_t.get("tensorboardX", False) and self._primary)
        self.rng_seed = rng_seed
        table = np.asarray(feature_table, dtype=np.float32)
        self.feature_table = self.exchange = None
        if feature_mode == "partitioned":
            self.halo = halo_impl()
            self.exchange = make_exchange(
                torch.from_numpy(shard_table(table, dp.size)[dp.rank]), dp,
                self.device, self.halo)
            # overflowed halo requests, read back once an epoch
            self._overflow = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        else:
            self.halo = None
            self.feature_table = torch.from_numpy(table).to(self.device)

    @property
    def _primary(self) -> bool:
        """Rank 0 (or the single process): the one that writes."""
        return self.layout is None or self.layout.world.rank == 0

    def _sharded_leaves(self, params: dict) -> list[bool]:
        """Per leaf of `params`: whether it belongs to a head-sharded GAT
        layer (its weights or its pos_emb rows), whose grad is partial on
        each mp rank."""
        layers = set(self.model.propagate.sharded_layers())
        return [len(path) > 2 and path[0] == "propagate"
                and path[1] in ("layers", "pos_emb") and path[2] in layers
                for path, _leaf in tree_leaves_with_path(params)]

    def _reduce_grads(self, grads: list, sharded: list[bool]) -> list:
        """The global batch's gradient: each leaf's grad summed over the
        world (a head-sharded layer's leaves) or over the dp group (the
        rest), in one all-reduce of the flattened grads a group."""
        out = list(grads)
        for group, pick in ((self.layout.world, True),
                            (self.layout.dp, False)):
            idx = [i for i, s in enumerate(sharded) if s == pick]
            if not idx or group.size == 1:
                continue
            flat = distributed.all_reduce_sum(
                torch.cat([grads[i].reshape(-1) for i in idx]), group)
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    # ---------------------------------------------------- model inputs
    def _ego_feats(self, ids, ngp, nsib) -> torch.Tensor:
        """Egonet features [B, N, D] of device ids [B, N], invalid slots
        zeroed: from the replicated table, or through the halo exchange of
        the row-partitioned one (trainer.py:217-235)."""
        if self.feature_mode == "replicated":
            return self.model.gather_feats(self.feature_table, ids.long(),
                                           ngp, nsib)
        feats = partitioned_gather(ids, self.exchange, self.dp.size,
                                   overflow=self._overflow)
        mask = star.node_mask(ngp, nsib, self.model.max_parents,
                              ids.shape[1])
        return feats * mask[..., None].to(feats.dtype)

    def _query_feats(self, batch: GroupBatch) -> torch.Tensor:
        """Query features [G, D]; the loader gives query ids, which go
        through the exchange like the egonets' on the partitioned table."""
        if batch.query_feats is not None:
            return batch.query_feats
        if self.feature_mode == "replicated":
            return self.feature_table[batch.query_ids.long()]
        return partitioned_gather(batch.query_ids, self.exchange,
                                  self.dp.size, overflow=self._overflow)

    # ------------------------------------------------------------ one step
    def train_step(self, batch: GroupBatch, step_idx: int,
                   return_grads: bool = False):
        """Loss, grads and the optimizer's update for one device batch;
        returns the loss (a device scalar, not read back; with `dp` this
        rank's share of it), and with `return_grads` also the grads (a tree
        like the params; with `dp` summed over the ranks)."""
        gen = step_generator(self.rng_seed, step_idx)
        params = tree_map(lambda x: x.detach().requires_grad_(True),
                          self.params)
        leaves = tree_leaves(params)
        ego = batch.ego
        with torch.enable_grad():
            feats = self._ego_feats(ego.node_ids, ego.ngp, ego.nsib)
            qf = self._query_feats(batch)
            if self.model.aux_heads:
                all_scores = self.model.forward_heads_with_feats(
                    params, batch, feats, qf, gen=gen, train=True)
                loss = torch.stack([
                    self.loss_fn(s, batch.labels, batch.cand_mask)
                    for s in all_scores]).mean()
            else:
                scores = self.model.forward_with_feats(
                    params, batch, feats, qf, gen=gen, train=True)
                loss = self.loss_fn(scores, batch.labels, batch.cand_mask)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if self.layout is not None:
            grads = self._reduce_grads(grads, self._sharded_leaves(params))
        grads = tree_unflatten(params, grads)
        self.params, self.opt_state = self.optimizer.update(
            grads, self.opt_state, tree_map(lambda x: x.detach(), params))
        if return_grads:
            return loss.detach(), grads
        return loss.detach()

    # ----------------------------------------------------------- epochs
    def _train_epoch(self, epoch: int) -> dict:
        n_batches = n_egonets = n_edges = 0
        losses, step_s = [], []
        t_wait = t_step = 0.0
        t_epoch = time.time()
        full_epoch = (self.full_validation_every > 0
                      and epoch % self.full_validation_every == 0)
        sampled_valid = self.valid_loader is not None and not full_epoch
        if sampled_valid:
            self._valid_prefetch = self._start_valid_prefetch()
        t0 = time.time()
        for batch_idx, (_host, dev_batch, b_egonets, b_edges) in enumerate(
                _DeviceFeed(self.train_loader, self.device, dp=self.dp)):
            t1 = time.time()
            if (self.profile_dir is not None and epoch == 1
                    and batch_idx == self._profile_window[0]):
                self._start_profile()
            losses.append(self.train_step(dev_batch,
                                          epoch * STEP_STRIDE + batch_idx))
            if (self._profiler is not None
                    and batch_idx == self._profile_window[1]):
                self._stop_profile()
            if self.step_timing:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                step_s.append(time.time() - t1)
            n_egonets += b_egonets
            n_edges += b_edges
            n_batches += 1
            t2 = time.time()
            t_wait += t1 - t0
            t_step += t2 - t1
            t0 = t2
        if self._profiler is not None:   # an epoch shorter than the window
            self._stop_profile()
        # the epoch's losses and overflowed halo requests, on the device
        vals = torch.stack(losses).double() if losses else \
            torch.zeros(0, dtype=torch.float64, device=self.device)
        if self.feature_mode == "partitioned":
            vals = torch.cat([vals, self._overflow.double()[None]])
            self._overflow.zero_()
        # the sampled validation runs before the epoch's one loss readback
        # (trainer.py:387-399): its host work overlaps the device's drain
        # of the train steps, which its first score readback then waits
        # for (on these epochs valid_s holds that drain, sync_s the rest)
        valid_log, t_valid = {}, 0.0
        if sampled_valid:
            t_v = time.time()
            valid_log = self._valid_epoch(epoch)
            t_valid = time.time() - t_v
        # one readback of the epoch's losses (with dp summed over the
        # ranks, the overflowed halo requests riding along)
        t_s = time.time()
        if self.dp is not None:
            vals = distributed.all_reduce_sum(vals, self.dp)
        loss_vals = vals.cpu().numpy()
        overflow = {}
        if self.feature_mode == "partitioned":
            loss_vals, overflow["train"] = loss_vals[:-1], int(loss_vals[-1])
            self._warn_overflow(epoch, "training", overflow["train"])
        t_sync = time.time() - t_s
        dt = max(time.time() - t_epoch, 1e-9)
        for i, lv in enumerate(loss_vals):
            self.writer.set_step((epoch - 1) * len(self.train_loader) + i)
            self.writer.add_scalar("loss", float(lv))
        log = {"loss": float(loss_vals.sum()) / max(n_batches, 1),
               "egonets_per_sec": round(n_egonets / dt, 1),
               "edges_per_sec": round(n_edges / dt, 1),
               "timing": {"wait_s": round(t_wait, 2),
                          "step_s": round(t_step, 2),
                          "sync_s": round(t_sync, 2)}}
        if step_s:
            log["step_ms"] = [round(1e3 * s, 3) for s in step_s]
        if overflow:
            log["halo_overflow"] = overflow
        self.writer.add_scalar("edges_per_sec", n_edges / dt)

        if sampled_valid:
            log.update(valid_log)
            log["timing"]["valid_s"] = round(t_valid, 2)
            if self.feature_mode == "partitioned":
                # validation's gathers count into the same device scalar:
                # read it back now, so the epoch reports its own overflow
                overflow["valid"] = self._overflow_readback()
                self._warn_overflow(epoch, "validation", overflow["valid"])
            if self.full_validation_every > 0:
                # off-epoch of a K > 1 schedule: sampled metrics are logged
                # but must not reach the monitor or the plateau
                log["val_sampled_metrics"] = log.pop("val_metrics")
                log["_monitor_eligible"] = False
        if full_epoch:
            t_v = time.time()
            log.update(self._full_valid(epoch))
            log["timing"]["valid_s"] = round(time.time() - t_v, 2)
            log["full_validation"] = True

        if self.lr_scheduler is not None and "val_metrics" in log:
            idx = 0 if self.lr_scheduler.mode == "min" else 2
            self.opt_state, _ = self.lr_scheduler.step(
                log["val_metrics"][idx], self.opt_state)
        log["lr"] = get_lr(self.opt_state)
        return log

    def _overflow_readback(self) -> int:
        """The overflowed halo requests counted since the last readback,
        summed over the ranks; the counter starts again from 0."""
        vals = self._overflow.double()[None]
        self._overflow.zero_()
        if self.dp is not None:
            vals = distributed.all_reduce_sum(vals, self.dp)
        return int(vals.cpu()[0])

    def _warn_overflow(self, epoch: int, phase: str, count: int) -> None:
        if count:
            self.logger.warning(
                "partitioned_gather: %d requests overflowed their halo "
                "buckets in epoch %d's %s and were poisoned with NaN; raise "
                "capacity_factor", count, epoch, phase)

    @torch.no_grad()
    def eval_scores(self, batch: GroupBatch) -> torch.Tensor:
        """Eval-mode scores [G, C] of a device batch, its egonets encoded in
        chunks of `encode_chunk` (a validation batch at config.mag.json
        holds over 32k egonets). With `dp` the batch is this rank's share
        and the scores of every rank's share come back, in rank order."""
        ego = batch.ego
        model, params = self.model, self.params
        hg = []
        for s in range(0, ego.node_ids.shape[0], self.encode_chunk):
            sl = slice(s, s + self.encode_chunk)
            feats = self._ego_feats(ego.node_ids[sl], ego.ngp[sl],
                                    ego.nsib[sl])
            hg.append(model.encode(params, feats, ego.ngp[sl], ego.nsib[sl]))
        g, c = batch.labels.shape
        qf = self._query_feats(batch)
        scores = model.match(params, torch.cat(hg),
                             qf.repeat_interleave(c, dim=0)).reshape(g, c)
        if self.dp is not None:
            scores = distributed.all_gather_cat(scores, self.dp)
        return scores

    def _staged_valid_batches(self) -> list:
        """The sampled validation's batches as (labels, cand_mask, device
        batch), sampled and staged in the validation loader's order."""
        return [(host.labels, host.cand_mask, dev) for host, dev, _ne, _ee
                in _DeviceFeed(self.valid_loader, self.device, dp=self.dp)]

    def _start_valid_prefetch(self):
        """Sample and stage the sampled validation's batches on a thread
        while the train epoch runs (trainer.py:442-462): the same batches
        as sampling them inline, since the validation loader is iterated
        once either way; `_valid_epoch` joins the thread. Returns (thread,
        batches, errors)."""
        staged: list = []
        err: list[BaseException] = []

        def produce():
            try:
                staged.extend(self._staged_valid_batches())
            except BaseException as e:  # surface in _valid_epoch
                err.append(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        return t, staged, err

    def _valid_epoch(self, epoch: int) -> dict:
        """Sampled validation: metrics averaged over validation batches,
        then the parameter histograms. The batches come from the prefetch
        the train epoch started (`_valid_prefetch`), joined here, or are
        sampled and staged here (the inline form); every batch's scores
        are dispatched before the first is read back."""
        prefetch, self._valid_prefetch = self._valid_prefetch, None
        if prefetch is None:
            staged = self._staged_valid_batches()
        else:
            thread, staged, err = prefetch
            thread.join()
            if err:
                raise err[0]
        scores = [self.eval_scores(dev) for _l, _m, dev in staged]
        totals = np.zeros(len(self.metric_fns))
        for batch_idx, ((labels, cand_mask, _dev), s) in enumerate(
                zip(staged, scores)):
            all_ranks = metrics_mod.ranks_from_groups(
                s.cpu().numpy(), labels, cand_mask, mode=self.rank_mode)
            self.writer.set_step((epoch - 1) * len(self.valid_loader)
                                 + batch_idx, "valid")
            for i, fn in enumerate(self.metric_fns):
                val = fn(all_ranks)
                totals[i] += val
                self.writer.add_scalar(self.metric_names[i], val)
        self._histograms()
        return {"val_metrics": (totals / max(len(staged), 1)).tolist()}

    def _histograms(self) -> None:
        """One histogram a parameter leaf, named by its key path joined
        with "/" (trainer.py:510-518); only with a tensorboard writer."""
        if self.writer.writer is None:
            return
        for path, leaf in tree_leaves_with_path(self.params):
            self.writer.add_histogram("/".join(map(str, path)),
                                      leaf.detach().cpu().numpy())

    # ---------------------------------------------------- profiler window
    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    @property
    def _rank_name(self) -> str:
        """rank<r>, and with mp > 1 its dp and mp indices:
        rank<r>-dp<d>-mp<m>."""
        lay = self.layout
        name = f"rank{lay.world.rank}"
        if lay.mp is not None:
            name += f"-dp{lay.dp.rank}-mp{lay.mp.rank}"
        return name

    def _stop_profile(self) -> Path:
        """Close the window on finished work (the device synchronised, as
        the JAX trainer blocks on the loss, trainer.py:374-376) and export
        its Chrome trace: profile_dir/trace.json, or under data
        parallelism profile_dir/rank<r>/trace.json (rank<r>-dp<d>-mp<m>
        with mp > 1)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = self.profile_dir if self.layout is None \
            else self.profile_dir / self._rank_name
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
        self.logger.info("profiler trace of epoch 1, batches %d-%d: %s",
                         *self._profile_window, path)
        return path

    def _full_valid(self, epoch: int) -> dict:
        """Full-catalog validation: every validation query ranked against
        all candidate positions by the TaxonomyRanker (the test_fast
        engine on the validation split), re-pointed at the current params
        with `refresh`."""
        from ..evaluation.ranker import TaxonomyRanker
        if self._full_ranker is None:
            s = self.full_valid_sampler
            self._full_ranker = TaxonomyRanker(
                self.model, self.params, s, s.node_features,
                encode_chunk=self.encode_chunk, device=self.device,
                layout=self.layout)
        else:
            self._full_ranker.refresh(self.params)
        result, _ = self._full_ranker.evaluate(self.metric_names,
                                               self.rank_mode)
        vals = [float(result[m]) for m in self.metric_names]
        self.writer.set_step(epoch, "valid")
        for name, v in zip(self.metric_names, vals):
            self.writer.add_scalar("full_" + name, v)
        return {"val_metrics": vals}

    # ------------------------------------------------------------ train
    def train(self) -> dict:
        """The epoch loop with monitoring, early stop and checkpoints; under
        data parallelism, then each rank's report file. The checkpoint
        writes in flight land before it returns, also after an exception.
        The halo exchange is closed when the loop ends normally (its
        tear-down is collective); after an exception the process exit
        releases it."""
        try:
            final_log = self._train_loop()
        finally:
            self._join_ckpt()
        if self.exchange is not None:
            self.exchange.close()
        if self.layout is not None:
            self._write_report(final_log)
        return final_log

    def _write_report(self, log: dict) -> None:
        """Rank r's last epoch log, kernel launch counts (a GAT wrapper's
        bf16 kernel under "<name>[bf16]"; its launches by the rank's heads
        under "launches_by_heads"), its dp and mp indices and a
        digest of its final params, as report-rank<r>.json in the run
        directory (the rank processes' only record: the log and
        checkpoints are rank 0's)."""
        from ..ops import gat_kernels, gcn_kernels, halo_kernels
        launches = {name: w.launches for mod in (
            gat_kernels, gcn_kernels, halo_kernels)
            for name, w in mod.WRAPPERS.items()}
        launches.update({f"{name}[bf16]": w.launches_bf16
                         for name, w in gat_kernels.WRAPPERS.items()})
        by_heads = {name: dict(w.launches_by_heads)
                    for name, w in gat_kernels.WRAPPERS.items()}
        lay = self.layout
        rank = lay.world.rank
        digest = hashlib.sha256()
        for leaf in tree_leaves(self.params):
            digest.update(leaf.detach().cpu().numpy().tobytes())
        report = {"rank": rank, "world_size": lay.world.size,
                  "dp_index": lay.dp.rank, "dp": lay.dp.size,
                  "mp_index": lay.mp_index, "mp": lay.mp_size,
                  "params_sha256": digest.hexdigest(),
                  "device": str(self.device),
                  "feature_mode": self.feature_mode, "halo": self.halo,
                  "log": log, "launches": launches,
                  "launches_by_heads": by_heads}
        path = self.checkpoint_dir / f"report-rank{rank}.json"
        path.write_text(json.dumps(report, indent=1))

    def _train_loop(self) -> dict:
        not_improved_count = 0
        final_log: dict = {}
        for epoch in range(self.start_epoch, self.epochs + 1):
            t0 = time.time()
            result = self._train_epoch(epoch)
            monitor_eligible = result.pop("_monitor_eligible", True)
            log = {"epoch": epoch,
                   "epoch_seconds": round(time.time() - t0, 2)}
            for key, value in result.items():
                if key == "val_metrics":
                    log.update({"val_" + m: value[i]
                                for i, m in enumerate(self.metric_names)})
                elif key == "val_sampled_metrics":
                    log.update({"val_sampled_" + m: value[i]
                                for i, m in enumerate(self.metric_names)})
                else:
                    log[key] = value
            for key, value in log.items():
                self.logger.info("    %-15s: %s", key, value)
            final_log = log

            best = False
            if self.mnt_mode != "off" and monitor_eligible:
                if self.mnt_metric not in log:
                    self.logger.warning(
                        "Warning: Metric '%s' not found; disabling model "
                        "performance monitoring.", self.mnt_metric)
                    self.mnt_mode = "off"
                else:
                    value = log[self.mnt_metric]
                    improved = (value <= self.mnt_best
                                if self.mnt_mode == "min"
                                else value >= self.mnt_best)
                    if improved:
                        self.mnt_best = value
                        not_improved_count = 0
                        best = True
                    else:
                        not_improved_count += 1
                    if not_improved_count > self.early_stop:
                        self.logger.info(
                            "Validation performance didn't improve for %s "
                            "epochs. Training stops.", self.early_stop)
                        break
            if epoch % self.save_period == 0:
                t_c = time.time()
                self._save_checkpoint(epoch, save_best=best)
                self.logger.info("    %-15s: %s", "checkpoint_s",
                                 round(time.time() - t_c, 2))
        self.writer.close()
        return final_log

    # ------------------------------------------------------ checkpoints
    def _save_checkpoint(self, epoch: int, save_best: bool = False) -> None:
        """Checkpoint without stalling the epoch loop on the readback
        (trainer.py:610-693): the foreground clones params and optimizer
        state on the device; a non-daemon thread reads the clone back once
        and writes the epoch checkpoint and, if best, model_best from that
        one host snapshot. At most two writes are in flight, each joining
        its predecessor first, so the files land in epoch order. Only rank
        0 writes (every rank holds the same params)."""
        if not self._primary:
            return
        self._ckpt_pending = [t for t in self._ckpt_pending if t.is_alive()]
        while len(self._ckpt_pending) >= 2:
            self._ckpt_pending.pop(0).join()
        # clones, not references: the snapshot is what these params are
        # now. The trainer's work and the writer's readback both run on the
        # device's default stream, so the readback follows the clones.
        snap = tree_map(lambda v: v.detach().clone()
                        if isinstance(v, torch.Tensor) else v,
                        (self.params, self.opt_state))
        paths = [self.checkpoint_dir / f"checkpoint-epoch{epoch}.ckpt"]
        self.logger.info("Saving checkpoint: %s ...", paths[0])
        if save_best:
            self.logger.info("Saving current best: model_best.ckpt ...")
            paths.append(self.checkpoint_dir / "model_best.ckpt")
        kw = dict(epoch=epoch, monitor_best=self.mnt_best, config=self.config,
                  scheduler_state=self.lr_scheduler.state_dict()
                  if self.lr_scheduler else None)
        prev = self._ckpt_pending[-1] if self._ckpt_pending else None

        def write():
            try:
                if prev is not None:
                    prev.join()
                self._write_checkpoint(paths, *to_numpy(snap), **kw)
            except BaseException as e:  # raised by _join_ckpt
                self._ckpt_errors.append(e)

        # non-daemon: the interpreter's exit waits for the write
        t = threading.Thread(target=write, daemon=False)
        t.start()
        self._ckpt_pending.append(t)

    @staticmethod
    def _write_checkpoint(paths: list, params, opt_state, **kw) -> None:
        """One snapshot into every file of `paths` (atomic writes)."""
        for path in paths:
            ckpt_mod.save_checkpoint(path, params=params,
                                     opt_state=opt_state, **kw)

    def _join_ckpt(self) -> None:
        """Wait for the checkpoint writes in flight; raise the first error
        one of them met."""
        pending, self._ckpt_pending = self._ckpt_pending, []
        for t in pending:
            t.join()
        if self._ckpt_errors:
            err, self._ckpt_errors = self._ckpt_errors[0], []
            raise err

    def resume(self, path: str | Path) -> None:
        """Restore params, optimizer state, epoch, monitor best and the
        scheduler from a checkpoint of either package, after the
        checkpoint writes in flight have landed."""
        self._join_ckpt()
        state = ckpt_mod.load_checkpoint(path)
        self.params, self.opt_state = ckpt_mod.restore_into(
            state, model=self.model, optimizer=self.optimizer,
            config=self.config, device=self.device)
        self.start_epoch = state["epoch"] + 1
        self.mnt_best = state["monitor_best"]
        if self.lr_scheduler is not None and state.get("scheduler"):
            self.lr_scheduler.load_state_dict(state["scheduler"])
        self.logger.info("Checkpoint loaded. Resume training from epoch %s",
                         self.start_epoch)
