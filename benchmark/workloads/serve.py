"""Serving traffic: placing new concepts into a large taxonomy with the
port's ranker (`taxoexpan_torch/evaluation/ranker.py`), as `infer` does.

Set-up generates the taxonomy from the seed, builds the test-mode sampler,
the model and a `TaxonomyRanker` over infer's anchor set (the train and
test nodes) with the traffic's encode chunk, and makes one parameter set
(two with `refresh`) on the device. A request is a number of new concepts,
their features rows of the held-out test nodes drawn with replacement;
its answer is each concept's top-k parents on the host
(`predict_parents`, `test_topk` -1 as infer's default).

- `refresh` true: before each request `ranker.refresh` switches to the
  other parameter set and the whole catalog is encoded again
  (`encode_all_anchors`), as each `infer` call does under the checkpoint it
  loads. Otherwise the anchors are encoded once in set-up and kept.
- `rate_per_s`: an open loop, requests due at that rate and served in
  order, a request's latency running from when it was due; without it a
  closed loop of one client, which sends its next request when the answer
  to the last has come (the ranker saturated).

Every round of `sizes.round` requests holds the same sizes, the
stratified quantiles of a log-uniform draw on [low, high], in an order
drawn from the seed for each round (`Requests`); with a rate, the gaps
between a round's arrivals are the stratified quantiles of an exponential
draw at that rate (Poisson arrivals), in an order of their own. The
window serves whole rounds and closes at the end of the first round that
ends after `seconds`. So every run does the same work, in another order.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from .. import check, work
from ..reference import data as ref_data
from ..reference import model as ref
from ..tracing import PropagationProbe, Tracer
from ..weights import make_params
from .common import (derive_seeds, generate, program_taxonomy, sync,
                     unit_rows)


class Setup:
    pass


def round_sizes(traffic: dict) -> np.ndarray:
    """The sizes of a round, ascending: the stratified quantiles of a
    log-uniform draw on [low, high]."""
    s = traffic["sizes"]
    k = s["round"]
    u = (np.arange(k) + 0.5) / k
    return np.rint(s["low"] * (s["high"] / s["low"]) ** u).astype(np.int64)


def round_gaps(traffic: dict) -> np.ndarray | None:
    """The gaps (s) between a round's arrivals at the traffic's rate: the
    stratified quantiles of an exponential draw, scaled so that a round
    lasts `round / rate_per_s`; None for a closed loop."""
    rate = traffic.get("rate_per_s")
    if not rate:
        return None
    k = traffic["sizes"]["round"]
    g = -np.log1p(-(np.arange(k) + 0.5) / k)
    return g * (k / rate) / g.sum()


class Requests:
    """Request i: its size, when it is due (s after the window's start)
    and the test nodes whose features it carries. Round r's sizes and gaps
    each take an order drawn from the seed and r; the nodes are drawn from
    the seed at send time."""

    def __init__(self, traffic: dict, seed: int, test_ids: np.ndarray):
        self.sizes = round_sizes(traffic)
        self.gaps = round_gaps(traffic)
        self.seed = seed
        self.test_ids = test_ids
        self.sample_fraction = traffic["sample_fraction"]
        self._orders: dict = {}

    def _order(self, stream: int, r: int) -> np.ndarray:
        key = (stream, r)
        if key not in self._orders:
            self._orders[key] = np.random.default_rng(
                [self.seed, stream, r]).permutation(len(self.sizes))
        return self._orders[key]

    def size(self, i: int) -> int:
        r, j = divmod(i, len(self.sizes))
        return int(self.sizes[self._order(1 << 19, r)[j]])

    def due(self, i: int) -> float:
        r, j = divmod(i, len(self.sizes))
        gaps = self.gaps[self._order(1 << 22, r)]
        return float(r * self.gaps.sum() + gaps[:j].sum())

    def nodes(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1 << 20, i])
        return self.test_ids[rng.integers(0, len(self.test_ids),
                                          self.size(i))]

    def sampled(self, i: int) -> bool:
        """Kept for the check: a draw from the seed, and every request of
        the largest size in the first round."""
        if i < len(self.sizes) and self.size(i) == self.sizes.max():
            return True
        return np.random.default_rng([self.seed, 1 << 21, i]).random() < \
            self.sample_fraction


def build(cell, seed: int, device, spans) -> Setup:
    from taxoexpan_torch import builders
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    cfg, traffic = cell.config, cell.traffic
    st = Setup()
    st.cfg, st.traffic, st.device = cfg, traffic, device
    st.seeds = derive_seeds(seed)
    arch = cfg["arch"]
    with spans.span("generate"):
        st.tax = generate(traffic, arch, st.seeds["data"])
    with spans.span("build"):
        taxonomy = program_taxonomy(st.tax)
        tcfg = dict(cfg["test_data_loader"]["args"])
        tcfg["sampling_mode"] = 0
        sampler = builders.build_sampler(taxonomy, tcfg, "test",
                                         test_topk=traffic["test_topk"])
        st.model = builders.build_model(arch,
                                        max_parents=sampler.max_parents,
                                        expand_factor=sampler.expand_factor)
        st.probe = PropagationProbe(st.model)
        st.params = [make_params(arch, st.seeds[k], device) for k in
                     (("weights", "weights_b") if traffic["refresh"]
                      else ("weights",))]
        anchors = sorted(set(st.tax.train_node_ids)
                         | set(st.tax.test_node_ids))
        st.ranker = TaxonomyRanker(st.model, st.params[0], sampler,
                                   sampler.node_features,
                                   encode_chunk=traffic["encode_chunk"],
                                   anchors=anchors, device=device)
    st.p = sampler.max_parents
    st.n = sampler.max_parents + 1 + sampler.expand_factor
    st.features = unit_rows(st.tax.features)
    st.requests = Requests(traffic, st.seeds["requests"],
                           np.asarray(st.tax.test_node_ids, dtype=np.int64))
    with spans.span("encode_warm"):
        st.ranker.encode_all_anchors()
    # the largest and the smallest size: every query-chunk shape a request
    # can have runs once (a full chunk and a partial one)
    for size in (int(st.requests.sizes.max()), int(st.requests.sizes.min())):
        st.ranker.predict_parents(st.features[st.requests.test_ids[:size]],
                                  1, topk=traffic["topk"])
    if traffic["refresh"]:
        st.ranker.refresh(st.params[1])
        st.ranker.encode_all_anchors()
    return st


def _serve(st, i: int, spans) -> tuple[list, int]:
    """One request: (answers, parameter set)."""
    rk = st.ranker
    pset = i % len(st.params)
    qf = st.features[st.requests.nodes(i)]
    if st.traffic["refresh"]:
        with spans.span("refresh"):
            rk.refresh(st.params[pset])
        with spans.span("encode"):
            rk.encode_all_anchors()
    with spans.span("rank"):
        answers = rk.predict_parents(qf, 1, topk=st.traffic["topk"])
    return answers, pset


def window(st, seconds: float, trace: bool, spans) -> dict:
    tr = st.traffic
    req = st.requests
    k = len(req.sizes)
    rate = tr.get("rate_per_s")
    tracer = Tracer(st.device, st.probe, spans, tr["section_start"],
                    tr["section_requests"]) if trace else None
    latency, queue_wait, kept = [], [], {}
    queries = failed = 0
    sync(st.device)
    t0 = time.perf_counter()
    i = 0
    while True:
        due = t0 + req.due(i) if rate else None
        if i and i % k == 0 and (due if rate else time.perf_counter()) - t0 \
                >= seconds and (tracer is None or not tracer.running):
            break
        if tracer is not None:
            tracer.before(i)
        traced = tracer is not None and tracer.running
        now = time.perf_counter()
        if rate and now < due:
            time.sleep(due - now)
        start = time.perf_counter()
        if not rate:
            due = start
        answers, pset = _serve(st, i, spans)
        done = time.perf_counter()
        size = req.size(i)
        if not traced:
            latency.append((done - due) * 1e3)
            queue_wait.append((start - due) * 1e3)
        queries += size
        failed += int(len(answers) != size or any(
            len(a) != tr["topk"] for a in answers))
        if req.sampled(i):
            kept[i] = (np.asarray(answers, dtype=np.int64), pset)
        if traced:
            tracer.after({"queries": size, "encodes": int(tr["refresh"]),
                          "host_encodes": int(tr["refresh"] and
                                              tracer.active is tracer.host)})
        i += 1
    window_s = time.perf_counter() - t0
    st.kept = kept
    st.last_pset = (i - 1) % len(st.params)
    rec = {"t0": t0, "window_s": window_s, "requests": i, "queries": queries,
           "latency_ms": latency, "queue_wait_ms": queue_wait,
           "attempted": i, "failed": failed,
           "encodes": i if tr["refresh"] else 0}
    if tracer is not None:
        tracer.record(rec)
        if tracer.done:
            rec["section_encodes"] = int(rec["traced"]["host_encodes"])
            if not rec["section_encodes"]:
                rec["prop_kernel_s"] = None
    return rec


def count_work(st, rec: dict) -> None:
    """The window's model operations and the propagation layers' least
    time over the traced encodes, from the reference's own egonets: an
    encode of the catalog in the traffic's chunks, and the matching of the
    window's queries (hg @ W once a parameter set in use)."""
    _ids, ngp, nsib = st.ego
    arch = st.cfg["arch"]
    r, e, b = work.rows_edges(ngp, nsib)
    one = work.encode_ops(arch, r, e, b)
    rec["ops"] = (rec["encodes"] * one
                  + work.match_ops(arch, b, rec["queries"],
                                   max(rec["encodes"], 1)))
    traced = rec.get("traced")
    if traced:
        traced["ops"] = (traced.get("encodes", 0) * one
                         + work.match_ops(arch, b, traced.get("queries", 0),
                                          0))
    if "section_encodes" in rec:
        chunk = st.traffic["encode_chunk"]
        one = sum(work.propagation_bound_ms(
            arch, *work.rows_edges(ngp[s:s + chunk], nsib[s:s + chunk]),
            n=st.n, backward=False, train=False)
            for s in range(0, len(ngp), chunk))
        rec["prop_bound_s"] = rec["section_encodes"] * one / 1e3


def release(st) -> None:
    st.hg_prog = st.ranker._hg
    st.ranker = st.model = st.probe = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------- the check

def reference_hg(st, pset: int, *, tf32: bool = False) -> torch.Tensor:
    """The reference's graph embeddings of every candidate under parameter
    set `pset`, in blocks of the traffic's `reference_block` egonets."""
    dev = st.device
    graph = st.graph
    ids, ngp, nsib = st.ego
    table = torch.from_numpy(st.features).to(dev)
    out = []
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            blk = st.traffic["reference_block"]
            for s in range(0, len(ids), blk):
                i_ = torch.from_numpy(ids[s:s + blk]).to(dev)
                g_ = torch.from_numpy(ngp[s:s + blk]).to(dev)
                n_ = torch.from_numpy(nsib[s:s + blk]).to(dev)
                feats = ref.gather(table, i_, g_, n_, graph.max_parents)
                out.append(ref.encode(st.params[pset], st.cfg["arch"], feats,
                                      g_, n_, graph.max_parents))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return torch.cat(out)


def prepare_reference(st) -> None:
    st.graph = ref_data.WorkingGraph(st.tax, "test")
    st.graph.check_expand(st.cfg["test_data_loader"]["args"]["expand_factor"])
    st.ego = st.graph.ego_arrays(st.graph.candidates,
                                 st.cfg["test_data_loader"]["args"][
                                     "expand_factor"])


def top_gap(st, hg_ref: dict, answers: dict, *, tf32: bool = False) -> float:
    """By the worst answer, how far the reference's score of a returned
    parent lies below the reference's own k-th best, over the spread (std)
    of that concept's scores; inf for an answer that is no candidate or
    repeats one."""
    cand = st.graph.candidates
    worst = 0.0
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            for i, (ans, pset) in answers.items():
                nodes = st.requests.nodes(i)
                idx = np.searchsorted(cand, ans)
                idx_c = np.minimum(idx, len(cand) - 1)
                if ans.shape != (len(nodes), st.traffic["topk"]) or not (
                        cand[idx_c] == ans).all():
                    return math.inf
                if any(len(set(row)) != len(row) for row in ans.tolist()):
                    return math.inf
                for s in range(0, len(nodes), 256):
                    qf = torch.from_numpy(st.features[nodes[s:s + 256]]).to(
                        st.device)
                    sc = ref.all_pairs(st.params[pset], hg_ref[pset], qf)
                    best = torch.topk(sc, ans.shape[1], dim=1).values
                    got = torch.gather(sc, 1, torch.from_numpy(
                        idx_c[s:s + 256]).to(st.device))
                    spread = sc.std(dim=1, keepdim=True)
                    worst = max(worst, float(((best - got) / spread).max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return worst


def reference_answers(st, hg: dict, *, tf32: bool = False) -> dict:
    """The kept requests' top-k answers from embeddings `hg` by parameter
    set, scored by the reference's matcher (the control: the reference in
    the program's place)."""
    cand = st.graph.candidates
    k = st.traffic["topk"]
    out = {}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            for i, (_ans, pset) in st.kept.items():
                nodes = st.requests.nodes(i)
                rows = []
                for s in range(0, len(nodes), 256):
                    qf = torch.from_numpy(st.features[nodes[s:s + 256]]).to(
                        st.device)
                    sc = ref.all_pairs(st.params[pset], hg[pset], qf)
                    rows.append(torch.topk(sc, k, dim=1).indices.cpu())
                out[i] = (cand[torch.cat(rows).numpy()], pset)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, spans,
        on_window_end) -> tuple[dict, dict]:
    st = build(cell, seed, device, spans)
    rec = window(st, seconds, trace, spans)
    on_window_end(rec)
    release(st)
    prepare_reference(st)
    used = sorted({p for _a, p in st.kept.values()} | {st.last_pset})
    hg_ref = {p: reference_hg(st, p) for p in used}
    count_work(st, rec)
    numbers = {"hg_gap": check.row_gap(st.hg_prog, hg_ref[st.last_pset]),
               "top_gap": top_gap(st, hg_ref, st.kept)}
    rec["checked_requests"] = len(st.kept)
    return rec, numbers
