"""Readings that the benchmark's fixed numbers were set from, on the chip:

    python3 -m benchmark.calibrate readings --workload <cell> \
        --seeds <n,n,...> --control <k> --out <file.json>
    python3 -m benchmark.calibrate sweep --workload <cell> --seed <n> \
        --rates <r,r,...> --seconds <s> --orders <k> --out <file.json>

`readings`: for every seed, the numbers that decide `correct` as a run
computes them (the program against the plain reference), without the
measured window for training and over one round of requests for serving;
for the first `k` seeds also the control's (the reference in TF32 put in
the program's place) and, for training, the planted faults' (the
reference in the program's place with half of the batch left out and the
mean taken over the rest, or with one score altered where it is
produced). A state left unchanged reads 1 by the training numbers'
measure and needs no run. The limits in `benchmark/limits/` lie between
the largest program reading and the smallest control or fault reading.

`sweep`: a serving cell at each offered rate (requests a second, Poisson
arrivals; 0 for a closed loop of one client, the highest rate the ranker
sustains), one set-up, `k` orders of the requests and arrivals (each
from a seed of its own): completed queries a second, the latency p50 and
p95, and the queue wait of the first and the last round (a wait that grows
from round to round is a backlog that grows).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _device():
    from taxoexpan_torch.device import resolve_device
    from taxoexpan_torch.ops import cuda_build
    dev = resolve_device("cuda")
    cuda_build.build_all()
    return dev


def train_readings(cell, seed: int, device, control: bool) -> dict:
    from . import check
    from .reference import model as ref
    from .tracing import Spans
    from .workloads import train as tw
    spans = Spans()
    st = tw.build(cell, seed, device, spans)
    tw.first_steps(st, spans)
    tw.release(st)
    fp32 = tw.reference_steps(st)
    prog = tw.program_readings(st)
    out = {"program": tw.compare(st, prog, fp32)}
    out["program"]["egonet_mismatch"] = tw.batch_mismatch(st)
    # by leaf, for the look at a number that swings
    p0 = ref.flatten(st.params0)
    out["program_by_leaf"] = {
        "grad": check.norm_gaps(prog[1], fp32[1]),
        "update": check.norm_gaps({k: prog[2][k] - p0[k] for k in p0},
                                  {k: fp32[2][k] - p0[k] for k in p0}),
        "grad_norm": {k: float(v.norm()) for k, v in fp32[1].items()},
        "losses": fp32[0]}
    if control:
        out["control_tf32"] = tw.compare(st, tw.reference_steps(st, tf32=True),
                                         fp32)
        for fault in ("half_batch", "score_altered"):
            out[f"fault_{fault}"] = tw.compare(
                st, tw.reference_steps(st, fault=fault), fp32)
    return out


def serve_readings(cell, seed: int, device, control: bool) -> dict:
    from . import check
    from .tracing import Spans
    from .workloads import serve as sw
    spans = Spans()
    cell.traffic = dict(cell.traffic, sample_fraction=1.0)
    st = sw.build(cell, seed, device, spans)
    sw.window(st, 0.0, False, spans)
    sw.release(st)
    sw.prepare_reference(st)
    used = sorted({p for _a, p in st.kept.values()} | {st.last_pset})
    hg_ref = {p: sw.reference_hg(st, p) for p in used}
    out = {"program": {"hg_gap": check.row_gap(st.hg_prog,
                                               hg_ref[st.last_pset]),
                       "top_gap": sw.top_gap(st, hg_ref, st.kept)},
           "requests_checked": len(st.kept)}
    if control:
        hg_c = {p: sw.reference_hg(st, p, tf32=True) for p in used}
        answers = sw.reference_answers(st, hg_c, tf32=True)
        out["control_tf32"] = {
            "hg_gap": check.row_gap(hg_c[st.last_pset],
                                    hg_ref[st.last_pset]),
            "top_gap": sw.top_gap(st, hg_ref, answers)}
    return out


def readings(args) -> dict:
    from . import spec
    device = _device()
    seeds = [int(s) for s in args.seeds.split(",")]
    res = {"workload": args.workload, "device":
           torch.cuda.get_device_name(device), "seeds": {}}
    for i, seed in enumerate(seeds):
        cell = spec.resolve(args.workload)
        t0 = time.perf_counter()
        fn = train_readings if cell.traffic["driver"] == "train" else \
            serve_readings
        res["seeds"][seed] = fn(cell, seed, device, i < args.control)
        res["seeds"][seed]["seconds"] = time.perf_counter() - t0
        print(json.dumps({seed: res["seeds"][seed]}), file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    return res


def sweep(args) -> dict:
    from . import spec
    from .tracing import Spans
    from .workloads import serve as sw
    device = _device()
    cell = spec.resolve(args.workload)
    spans = Spans()
    st = sw.build(cell, args.seed, device, spans)
    test_ids = st.requests.test_ids
    out = {"workload": args.workload,
           "device": torch.cuda.get_device_name(device), "rates": {}}
    k = cell.traffic["sizes"]["round"]
    for rate in (float(r) for r in args.rates.split(",")):
        st.traffic = dict(cell.traffic, rate_per_s=rate or None,
                          sample_fraction=0.0)
        runs = []
        for order in range(args.orders):
            st.requests = sw.Requests(st.traffic, args.seed * 1000 + order,
                                      test_ids)
            rec = sw.window(st, args.seconds, False, Spans())
            qw = np.asarray(rec["queue_wait_ms"])
            lat = np.asarray(rec["latency_ms"])
            runs.append({
                "requests": rec["requests"],
                "requests_per_s": rec["requests"] / rec["window_s"],
                "queries_per_s": rec["queries"] / rec["window_s"],
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p95": float(np.percentile(lat, 95)),
                "queue_wait_ms_first_round": float(qw[:k].mean()),
                "queue_wait_ms_last_round": float(qw[-k:].mean())})
            print(json.dumps({rate: runs[-1]}), file=sys.stderr, flush=True)
        out["rates"][rate] = runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", required=True)
    r.add_argument("--control", type=int, default=3)
    r.add_argument("--out", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--rates", required=True)
    s.add_argument("--seconds", type=float, default=10.0)
    s.add_argument("--orders", type=int, default=1)
    s.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    res = readings(args) if args.what == "readings" else sweep(args)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
