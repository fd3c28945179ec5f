"""Training traffic: the port's trainer step as users run an epoch.

Set-up builds one `Trainer` (`taxoexpan_torch/training/trainer.py`) with
the configuration's model, AMSGrad state and `GroupBatchLoader` (the
native sampler, the configuration's batch, negatives and expand factor)
on a taxonomy generated from the seed, and drives it through its first
steps: `first_steps` of them are kept for the correctness comparison, the
rest only warm. The window then calls `Trainer.train_step` back to back on
the batches `_DeviceFeed` stages (feed depth 2), epoch after epoch as the
loader reshuffles, and ends in a device sync once `seconds` have passed.
No validation runs. The same trainer object runs set-up and window.

Traffic keys: `data` (num_nodes, max_children, noise), `first_steps`,
`warmup_steps`, `section_steps` and `section_start` (the traced stretch,
in steps after the window's start), `sample_batches` (how many of the
first steps' batches the reference re-checks egonet by egonet).
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import check, work
from ..reference import data as ref_data
from ..reference import model as ref
from ..frozen import dropout_hash as dh
from ..tracing import PropagationProbe, Tracer
from ..weights import make_params
from .common import (derive_seeds, generate, program_taxonomy, sync,
                     unit_rows)


class Setup:
    """The program's objects and what the first steps left for the
    check."""


def _copy(tree):
    """A copy of a tree of tensors (dicts and lists), every leaf cloned."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def build(cell, seed: int, device, spans) -> Setup:
    from taxoexpan_torch import builders
    from taxoexpan_torch.training.trainer import Trainer
    cfg, traffic = cell.config, cell.traffic
    st = Setup()
    st.cfg, st.traffic, st.device = cfg, traffic, device
    st.seeds = derive_seeds(seed)
    with spans.span("generate"):
        st.tax = generate(traffic, cfg["arch"], st.seeds["data"])
    with spans.span("build"):
        taxonomy = program_taxonomy(st.tax)
        lcfg = dict(cfg["train_data_loader"]["args"])
        sampler = builders.build_sampler(taxonomy, lcfg, "train")
        st.loader = builders.build_loader(sampler, lcfg,
                                          seed=st.seeds["loader"])
        st.model = builders.build_model(
            cfg["arch"], max_parents=sampler.max_parents,
            expand_factor=sampler.expand_factor)
        st.probe = PropagationProbe(st.model)
        st.params0 = make_params(cfg["arch"], st.seeds["weights"], device)
        # the program gets a copy: whatever it does to its state in place,
        # the reference starts from these
        params = _copy(st.params0)
        optimizer = builders.build_optimizer_from_config(
            cfg["optimizer"], cfg.get("trainer"))
        # the trainer makes its checkpoint directory; it stays empty
        st.save_dir = tempfile.mkdtemp(prefix="bench_train_")
        st.trainer = Trainer(
            st.model, params, optimizer, optimizer.init(params),
            loss_name=cfg["loss"], metric_names=cfg.get("metrics", []),
            feature_table=sampler.node_features, train_loader=st.loader,
            config=cfg, save_dir=st.save_dir,
            rng_seed=st.seeds["steps"], device=device)
    st.p = sampler.max_parents
    st.n = sampler.max_parents + 1 + sampler.expand_factor
    st.epoch = 0
    st.batch_in_epoch = 0
    st.feed = None
    return st


def next_batch(st):
    """(host batch, device batch, step index) from the feed, a new epoch
    (the loader reshuffled) when one ends."""
    from taxoexpan_torch.training.trainer import STEP_STRIDE, _DeviceFeed
    while True:
        if st.feed is None:
            st.feed = iter(_DeviceFeed(st.loader, st.device))
        item = next(st.feed, None)
        if item is not None:
            break
        st.feed = None
        st.epoch += 1
        st.batch_in_epoch = 0
    host, dev, _n_egonets, _n_edges = item
    idx = st.epoch * STEP_STRIDE + st.batch_in_epoch
    st.batch_in_epoch += 1
    return host, dev, idx


def first_steps(st, spans) -> None:
    """The first steps through the window's own call and feed, keeping
    their batches, losses, and copies of the optimizer's first moment
    after step 1 and of the params after the last of them (copies: a
    program that updates its state in place must not change them)."""
    tr = st.trainer
    st.first = []
    for k in range(st.traffic["first_steps"]):
        host, dev, idx = next_batch(st)
        with spans.span("first_step"):
            loss = tr.train_step(dev, idx)
        st.first.append({"host": host, "idx": idx, "loss": loss})
        if k == 0:
            st.mu1 = _copy(tr.opt_state["mu"])
    st.params_k = _copy(tr.params)
    for _ in range(st.traffic["warmup_steps"]):
        _host, dev, idx = next_batch(st)
        tr.train_step(dev, idx)
    sync(st.device)


def window(st, seconds: float, trace: bool, spans) -> dict:
    """Steps back to back for `seconds`, then a device sync. Each step's
    wait for its batch and its call's time on the host (ms), its epoch and
    whether a traced section held it are kept (`step_log`)."""
    tr = st.trainer
    arch = st.cfg["arch"]
    tr_cfg = st.traffic
    tracer = Tracer(st.device, st.probe, spans, tr_cfg["section_start"],
                    tr_cfg["section_steps"]) if trace else None
    sec_steps = []
    steps = egonets = 0
    ops = 0.0
    losses, log = [], []
    sync(st.device)
    t0 = time.perf_counter()
    while True:
        if tracer is not None:
            tracer.before(steps)
        traced = tracer is not None and tracer.running
        ta = time.perf_counter()
        with spans.span("feed_wait"):
            host, dev, idx = next_batch(st)
        tb = time.perf_counter()
        losses.append(tr.train_step(dev, idx))
        tc = time.perf_counter()
        log.append((1e3 * (tb - ta), 1e3 * (tc - tb), st.epoch, traced))
        mask = np.asarray(host.cand_mask).reshape(-1)
        r, e, b = work.rows_edges(host.ego.ngp, host.ego.nsib, mask)
        step_ops = work.train_step_ops(arch, r, e, b)
        ops += step_ops
        egonets += b
        steps += 1
        if traced:
            if tracer.active is tracer.host:
                sec_steps.append((r, e, b))
            tracer.after({"ops": step_ops})
        if time.perf_counter() - t0 >= seconds and (
                tracer is None or not tracer.running):
            break
    sync(st.device)
    window_s = time.perf_counter() - t0
    vals = torch.stack(losses).double().cpu().numpy()
    rec = {"t0": t0, "window_s": window_s, "steps": steps, "egonets": egonets,
           "ops": ops, "failed": int((~np.isfinite(vals)).sum()),
           "attempted": steps, "step_log": log}
    if tracer is not None:
        tracer.record(rec)
        if tracer.done:
            bound_ms = sum(
                work.propagation_bound_ms(arch, r, e, b, n=st.n,
                                          backward=False)
                + work.propagation_bound_ms(arch, r, e, b, n=st.n,
                                            backward=True)
                for r, e, b in sec_steps)
            rec["prop_bound_s"] = bound_ms / 1e3
    return rec


def window_note(rec: dict) -> str:
    """One line on the window's steps for standard error: the steps and
    epochs, and by percentile each step's wait for its batch and its
    call's time on the host (ms)."""
    log = np.asarray(rec["step_log"], dtype=np.float64)
    if not len(log):
        return "window: no step"
    q = (50, 90, 99)
    feed = np.percentile(log[:, 0], q)
    call = np.percentile(log[:, 1], q)
    return (f"window: {rec['steps']} steps over {int(log[-1, 2] - log[0, 2]) + 1}"
            f" epochs, {1e3 * rec['window_s'] / rec['steps']:.3f} ms a step;"
            f" batch wait ms p50/p90/p99 {feed[0]:.3f}/{feed[1]:.3f}/"
            f"{feed[2]:.3f} (sum {log[:, 0].sum() / 1e3:.3f} s);"
            f" step call ms p50/p90/p99 {call[0]:.3f}/{call[1]:.3f}/"
            f"{call[2]:.3f}")


def release(st) -> None:
    """Drop the program's state (the trainer, its feed and loader) so the
    reference runs on a freed device."""
    st.first_params = st.params_k
    st.trainer = st.feed = st.loader = st.model = st.probe = None
    shutil.rmtree(st.save_dir, ignore_errors=True)
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------- the check

def reference_steps(st, *, tf32: bool = False, fault: str | None = None):
    """The plain reference's first steps on the same batches, weights and
    dropout seeds: (losses, step 1's grads {leaf: tensor}, the params after
    the last step), in float32 with TF32 off (`tf32`: on, the control).
    `fault` plants a fault in the reference put in the program's place:
    "half_batch" (the loss over the first half of the groups, doubled),
    "score_altered" (the first group's positive score raised by 1 where
    the matcher produces it)."""
    dev = st.device
    arch = st.cfg["arch"]
    lr = st.cfg["optimizer"]["args"]["lr"]
    table = torch.from_numpy(unit_rows(st.tax.features)).to(dev)
    flat = {k: v.detach().clone() for k, v in ref.flatten(st.params0).items()}
    state = {"count": 0, **{m: {k: torch.zeros_like(v) for k, v in
                                flat.items()} for m in ("mu", "nu",
                                                        "nu_max")}}
    layers = arch["args"].get("num_layers", 1) + 1
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    losses, grads1 = [], None
    try:
        for step in st.first:
            hb = step["host"]
            ids = torch.from_numpy(np.asarray(hb.ego.node_ids)).to(dev)
            ngp = torch.from_numpy(np.asarray(hb.ego.ngp)).to(dev)
            nsib = torch.from_numpy(np.asarray(hb.ego.nsib)).to(dev)
            cm = torch.from_numpy(np.asarray(hb.cand_mask)).to(dev)
            q = torch.from_numpy(np.asarray(hb.query_ids)).to(dev).long()
            seeds = dh.layer_seeds(st.seeds["steps"], step["idx"], layers)
            leaves = {k: v.requires_grad_(True) for k, v in flat.items()}
            params = ref.unflatten(leaves, st.params0)
            with torch.enable_grad():
                feats = ref.gather(table, ids, ngp, nsib, st.p)
                hg = ref.encode(params, arch, feats, ngp, nsib, st.p,
                                seeds=seeds)
                g, c = cm.shape
                scores = ref.bilinear(params, hg,
                                      table[q].repeat_interleave(c, 0))
                scores = scores.reshape(g, c)
                if fault == "score_altered":
                    scores = scores + torch.nn.functional.one_hot(
                        torch.tensor(0, device=dev), g * c).reshape(g, c)
                if fault == "half_batch":
                    loss = 2.0 * ref.info_nce(scores[:g // 2], cm[:g // 2])
                else:
                    loss = ref.info_nce(scores, cm)
                keys = list(leaves)
                gs = torch.autograd.grad(loss, [leaves[k] for k in keys])
            grads = dict(zip(keys, gs))
            if grads1 is None:
                grads1 = {k: v.detach() for k, v in grads.items()}
            losses.append(float(loss.detach()))
            flat, state = ref.amsgrad_step(
                {k: v.detach() for k, v in leaves.items()}, grads, state, lr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
        torch.backends.cudnn.allow_tf32 = old
    return losses, grads1, flat


def program_readings(st):
    """The program's losses of the first steps, step 1's gradient as the
    optimizer got it (mu after one step = (1 - b1) g) and the params after
    the last first step."""
    from taxoexpan_torch.training.optim import B1
    losses = [float(s["loss"]) for s in st.first]
    grads = {k: v / (1.0 - B1) for k, v in ref.flatten(st.mu1).items()}
    return losses, grads, ref.flatten(st.first_params)


def compare(st, prog, refr) -> dict:
    """The numbers compared: the losses' largest relative gap, and by the
    median leaf the gap of the first gradient's norm and of the params'
    change's norm (leaves with a reference gradient under a thousandth of
    the median leaf's left out of the change). By the worst leaf both
    swing from seed to seed: a GAT layer's attention vectors, whose
    logits' rounding can cross leaky_relu's kink, read 1e-6 on most seeds
    and up to 1.3e-4 (gradient) and 1.5e-2 (change) on a few (PERF.md,
    the benchmark's findings)."""
    p_losses, p_grads, p_params = prog
    r_losses, r_grads, r_params = refr
    p0 = ref.flatten(st.params0)
    keep = check.moving_leaves(r_grads)
    return {
        "loss_gap": check.loss_gap(p_losses, r_losses),
        "grad_median_gap": check.median_norm_gap(p_grads, r_grads),
        "update_median_gap": check.median_norm_gap(
            {k: p_params[k] - p0[k] for k in keep},
            {k: r_params[k] - p0[k] for k in keep}),
    }


def batch_mismatch(st) -> int:
    """Egonets of the first `sample_batches` batches that the reference's
    own graph does not give."""
    graph = ref_data.WorkingGraph(st.tax, "train")
    graph.check_expand(st.cfg["train_data_loader"]["args"]["expand_factor"])
    if graph.max_parents != st.p:
        return -1
    bad = 0
    for step in st.first[:st.traffic["sample_batches"]]:
        hb = step["host"]
        bad += ref_data.batch_mismatches(
            graph, np.asarray(hb.ego.node_ids), np.asarray(hb.ego.ngp),
            np.asarray(hb.ego.nsib), np.asarray(hb.query_ids),
            np.asarray(hb.labels), np.asarray(hb.cand_mask))
    return bad


def run(cell, seed: int, seconds: float, trace: bool, device, spans,
        on_window_end) -> tuple[dict, dict]:
    """Set-up, first steps, window, then the check: (record, numbers)."""
    st = build(cell, seed, device, spans)
    first_steps(st, spans)
    rec = {"setup_done": time.perf_counter()}
    rec.update(window(st, seconds, trace, spans))
    on_window_end(rec)
    release(st)
    numbers = compare(st, program_readings(st), reference_steps(st))
    numbers["egonet_mismatch"] = batch_mismatch(st)
    return rec, numbers
