"""The workload builders at a tiny size: seeds, request-size draws, batch
shapes and egonet counts."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import spec
from benchmark.tracing import Spans
from benchmark.workloads import serve, train
from benchmark.workloads.common import derive_seeds


def test_seeds_are_fixed_and_31_bit():
    a, b = derive_seeds(2 ** 31 + 5), derive_seeds(2 ** 31 + 5)
    assert a == b and a != derive_seeds(2 ** 31 + 6)
    assert all(0 <= v < 2 ** 31 for v in a.values())
    assert len(set(a.values())) == len(a)


def test_round_sizes_are_stratified_log_uniform():
    tr = spec.resolve("pgat_mag.serve_refresh").traffic
    sizes = serve.round_sizes(tr)
    assert len(sizes) == tr["sizes"]["round"]
    assert sizes.min() >= tr["sizes"]["low"]
    assert sizes.max() <= tr["sizes"]["high"]
    logs = np.log(sizes)
    # equal steps in log size, up to the rounding to whole concepts
    assert np.allclose(np.diff(logs), np.log(16) / len(sizes),
                       atol=1.0 / sizes.min())
    # the mean of a log-uniform draw on [256, 4096] is about 1,385
    assert abs(sizes.mean() - 3840 / np.log(16)) < 60


def test_every_round_holds_the_same_sizes():
    tr = spec.resolve("pgat_mag.serve_cached").traffic
    req = serve.Requests(tr, 12345, np.arange(100, 200))
    k = len(req.sizes)
    rounds = [[req.size(r * k + j) for j in range(k)] for r in range(5)]
    assert all(sorted(r) == sorted(req.sizes.tolist()) for r in rounds)
    # each round in an order of its own, drawn from the seed
    assert len({tuple(r) for r in rounds}) == 5
    again = serve.Requests(tr, 12345, np.arange(100, 200))
    assert [again.size(i) for i in range(k)] == rounds[0]
    firsts = {tuple(serve.Requests(tr, s, np.arange(9)).size(j)
                    for j in range(k)) for s in range(10)}
    assert len(firsts) == 10
    nodes = req.nodes(3)
    assert len(nodes) == req.size(3) and set(nodes) <= set(range(100, 200))
    assert np.array_equal(nodes, serve.Requests(tr, 12345,
                                                np.arange(100, 200)).nodes(3))


def test_arrivals_at_a_rate_are_poisson_gaps_in_a_seeded_order():
    tr = dict(spec.resolve("pgat_mag.serve_cached").traffic, rate_per_s=8.0)
    assert serve.round_gaps(spec.resolve(
        "pgat_mag.serve_cached").traffic) is None
    gaps = serve.round_gaps(tr)
    k = tr["sizes"]["round"]
    assert len(gaps) == k and abs(gaps.sum() - k / 8.0) < 1e-9
    # the stratified quantiles of an exponential draw: rising, and the
    # largest about ln(2k) times the mean
    assert np.all(np.diff(gaps) > 0)
    assert 0.8 < gaps[-1] / gaps.mean() / np.log(2 * k) < 1.2
    req = serve.Requests(tr, 77, np.arange(9))
    due = np.array([req.due(i) for i in range(3 * k)])
    assert due[0] == 0.0 and np.all(np.diff(due) > 0)
    assert abs(due[k] - k / 8.0) < 1e-9 and abs(due[2 * k] - 2 * k / 8.0) \
        < 1e-9
    for r in range(2):
        assert np.allclose(np.sort(np.diff(due[r * k:(r + 1) * k + 1])),
                           gaps)
    other = serve.Requests(tr, 78, np.arange(9))
    assert not np.allclose(due[:k], [other.due(i) for i in range(k)])


def test_train_batches_and_counts(tiny):
    cell = tiny("pgat_mag.train")
    st = train.build(cell, 99, torch.device("cpu"), Spans())
    host, _dev, idx = train.next_batch(st)
    lcfg = cell.config["train_data_loader"]["args"]
    g, c = lcfg["batch_size"], 1 + lcfg["negative_size"]
    assert host.ego.node_ids.shape == (g * c, st.n)
    assert st.n == st.p + 1 + lcfg["expand_factor"]
    assert host.labels.shape == (g, c) and idx == 0
    rec = train.window(st, 0.2, False, Spans())
    assert rec["egonets"] <= rec["steps"] * g * c
    assert rec["egonets"] >= (rec["steps"] - 1) * g * c
    assert rec["failed"] == 0


def test_serve_window_serves_whole_rounds(tiny):
    cell = tiny("pgat_mag.serve_refresh")
    st = serve.build(cell, 98, torch.device("cpu"), Spans())
    rec = serve.window(st, 0.05, False, Spans())
    k = len(st.requests.sizes)
    assert rec["requests"] % k == 0 and rec["requests"] >= k
    assert rec["queries"] == sum(st.requests.size(i)
                                 for i in range(rec["requests"]))
    assert rec["encodes"] == rec["requests"]


def test_a_traced_window_keeps_its_sections_apart(tiny):
    """The traced stretch: a device-only section, then a host and device
    one, each of the traffic's units; their spans, time and work are kept
    out of the host-clock readings."""
    cell = tiny("pgat_mag.train")
    st = train.build(cell, 97, torch.device("cpu"), Spans())
    spans = Spans()
    rec = train.window(st, 0.05, True, spans)
    n = cell.traffic["section_steps"]
    assert rec["steps"] >= cell.traffic["section_start"] + 2 * n
    assert rec["section_units"] == n
    assert len(spans.intervals["traced.feed_wait"]) == 2 * n
    assert len(spans.intervals["feed_wait"]) == rec["steps"] - 2 * n
    assert 0 < rec["traced"]["ops"] < rec["ops"]
    assert 0 < rec["traced_s"] < rec["window_s"]
    assert rec["idle_summary"]["window_s"] > 0
    assert {"section_summary", "breakdown", "prop_kernel_s"} <= set(rec)
    assert sum(traced for *_, traced in rec["step_log"]) == 2 * n
    from benchmark import spec as sp
    untraced = [w + c for w, c, _e, t in rec["step_log"] if not t]
    assert sp.reader("step_ms_p50.train")(rec) == np.median(untraced)
    assert "events" not in rec and st.probe.marking is False

    cell = tiny("pgat_mag.serve_cached")
    st = serve.build(cell, 96, torch.device("cpu"), Spans())
    spans = Spans()
    rec = serve.window(st, 0.05, True, spans)
    n = cell.traffic["section_requests"]
    assert len(spans.intervals["traced.rank"]) == 2 * n
    assert len(rec["latency_ms"]) == rec["requests"] - 2 * n
    assert rec["traced"]["queries"] == sum(
        st.requests.size(i) for i in range(cell.traffic["section_start"],
                                           cell.traffic["section_start"]
                                           + 2 * n))
