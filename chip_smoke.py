#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taxoexpan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device   - requires CUDA; prints the card's name and power limit
              (nvidia-smi) and turns TF32 off for full float32 products.
2. build    - builds every CUDA kernel from taxoexpan_torch/ops/csrc with
              nvcc for sm_90a (one nvcc per source, started together).
3. kernels  - each kernel against its plain PyTorch version on the card at
              the serving shapes of configs/config.mag.json (PGAT, in 250,
              hidden/out 500, pos 50, heads [4, 1]; 13 grandparent and 50
              sibling slots, N = 64) for one encode chunk of egonets, with
              random ngp/nsib including empty egonets; times of the kernel,
              its plain version and one torch.matmul of x @ W as a yardstick
              (`matmul_ms`: the product alone, not the layer, so the
              `library_ms` of the kernels line is null), beside the least
              time the card could take.
4. serving  - the port's serving path end to end through its entry
              points: a run directory with a synthetic taxonomy (4000
              nodes, dim 250), config.mag.json and the model from random
              weights (seeded) in the JAX checkpoint format; then
              `taxoexpan_torch.test_fast` (TaxonomyRanker.evaluate, the
              test_fast metrics) and `taxoexpan_torch.infer`
              (predict_parents for 8 novel terms), with the launch counters
              set to 0 just before and read just after. The card's graph
              embeddings are checked against the CPU plain path.
5. a `{"kernels": [...]}` line, then the card's nvidia-smi line, and last
   `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bandwidth and float32 outside the tensor cores (the kernels compute
# in full float32; TF32 would break parity with the plain versions)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# kernel vs plain version on the card: both float32, sums taken in another
# order (tiled K loop vs cuBLAS), so agreement is to rounding, not bits
RTOL, ATOL = 1e-4, 1e-4
MAG_P, MAG_S = 13, 50          # max_parents, expand_factor -> N = 64
BATCH = 4096                   # egonets per kernel call: one encode_chunk
NODES, N_NOVEL, SEED = 4000, 8, 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, want) -> dict:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    rel = diff / want.abs().clamp(min=ATOL)
    res = {"max_abs_err": float(diff.max()), "max_rel_err": float(rel.max()),
           "rtol": RTOL, "atol": ATOL}
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{res}")
    return res


# ----------------------------------------------------------------- phases

def phase_device() -> dict:
    import torch
    line = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"nvidia_smi": line, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build() -> None:
    from taxoexpan_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build_all()
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in logs.items()}
    emit("build", seconds=round(time.time() - t0, 3),
         sources=[f"taxoexpan_torch/ops/csrc/{n}.cu" for n in logs],
         ptxas=ptxas)


def mag_model():
    from taxoexpan_torch import builders
    cfg = json.loads((REPO / "configs" / "config.mag.json").read_text())
    model = builders.build_model(cfg["arch"], max_parents=MAG_P,
                                 expand_factor=MAG_S)
    return cfg, model


def random_egonets(gen, b: int, din: int, device):
    """Unit-norm features [B, 64, din] with random ngp in [0, 13] and nsib in
    [0, 50], invalid slots zeroed as gather_feats leaves them; the first
    rows are empty egonets (ngp = nsib = 0) and full ones."""
    import torch
    from taxoexpan_torch.ops import star
    n = MAG_P + 1 + MAG_S
    ngp = torch.randint(0, MAG_P + 1, (b,), generator=gen, dtype=torch.int32)
    nsib = torch.randint(0, MAG_S + 1, (b,), generator=gen,
                         dtype=torch.int32)
    ngp[:4] = torch.tensor([0, 0, MAG_P, MAG_P], dtype=torch.int32)
    nsib[:4] = torch.tensor([0, MAG_S, 0, MAG_S], dtype=torch.int32)
    x = torch.randn((b, n, din), generator=gen)
    x = x / x.norm(dim=-1, keepdim=True)
    x = x * star.node_mask(ngp, nsib, MAG_P, n)[..., None]
    return x.to(device), ngp.to(device), nsib.to(device)


def kernel_work(name: str, x, ops, ngp, nsib, heads: int, out_elems: int):
    """(bytes, operations) the function needs on these inputs: each input
    read once and the output written once; the x @ [fc | wa1 | wa2]
    products over the rows the output depends on, plus the aggregation."""
    b, n, din = x.shape
    hd = ops[0].shape[1]
    dh = hd // heads
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (x, *ops, ngp, nsib))
    nbytes = in_bytes + out_elems * 4
    ngp_sum = float(ngp.double().sum())
    if name == "gat_layer_fwd":
        rows = b * n                      # every slot is an output row
        agg = heads * dh * (3 * b * MAG_S + 2 * (ngp_sum + b)) + b * n * hd
    else:
        # invalid slots contribute nothing to the pools
        rows = float((ngp + 1 + nsib).double().sum())
        nsib_sum = float(nsib.double().sum())
        agg = heads * dh * (3 * nsib_sum + 2 * (ngp_sum + b) + ngp_sum)
    flops = 2.0 * rows * din * (hd + 2 * heads) + agg
    return nbytes, flops


def phase_kernels(batch: int, device) -> list[dict]:
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.weights import params_to
    _cfg, model = mag_model()
    gen = torch.Generator().manual_seed(SEED)
    prop = model.propagate
    params = params_to(model.init(gen), device)["propagate"]
    x0, ngp, nsib = random_egonets(gen, batch, prop.layer_specs[0][0]
                                   - prop.pos_dim, device)
    n = x0.shape[1]
    ops0 = prop.operands(params, 0, n, MAG_P)
    ops1 = prop.operands(params, 1, n, MAG_P)
    h0, h1 = prop.layer_specs[0][2], prop.layer_specs[1][2]
    with torch.no_grad():
        x1 = gk.gat_layer_fwd_plain(x0, *ops0, ngp, nsib, MAG_P, h0,
                                    out_alpha=0.01)
    cases = [
        ("gat_layer_fwd", "taxoexpan_tpu/ops/pallas_gat.py:838",
         lambda: gk.gat_layer_fwd(x0, *ops0, ngp, nsib, MAG_P, h0,
                                  out_alpha=0.01),
         lambda: gk.gat_layer_fwd_plain(x0, *ops0, ngp, nsib, MAG_P, h0,
                                        out_alpha=0.01),
         x0, ops0, h0),
        ("gat_layer_pooled_fwd", "taxoexpan_tpu/ops/pallas_gat.py:1105",
         lambda: gk.gat_layer_pooled_fwd(x1, *ops1, ngp, nsib, MAG_P, h1),
         lambda: gk.gat_layer_pooled_fwd_plain(x1, *ops1, ngp, nsib, MAG_P,
                                               h1),
         x1, ops1, h1),
    ]
    records = []
    for name, replaces, kernel, plain, x, ops, heads in cases:
        with torch.no_grad():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = compare(name, got, want)
            del want
            fc = ops[0]
            x2 = x.reshape(-1, x.shape[-1])
            ms = time_ms(kernel, 10)
            plain_ms = time_ms(plain, 5)
            matmul_ms = time_ms(lambda: x2 @ fc, 10)
        nbytes, flops = kernel_work(name, x, ops, ngp, nsib, heads,
                                    got.numel())
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
        rec = {"name": name, "route": "cuda",
               "source": "taxoexpan_torch/ops/csrc/gat_fwd.cu",
               "replaces": replaces, "batch": batch,
               "x_shape": list(x.shape), "fc_shape": list(fc.shape),
               **err, "ms": ms, "plain_ms": plain_ms,
               # no single PyTorch call computes the star-GAT layer; the
               # x @ fc product alone is timed as a yardstick
               "library_ms": None, "matmul_ms": matmul_ms,
               "matmul_call": "torch.matmul(x.reshape(-1, Din), fc)",
               "bytes": nbytes, "operations": flops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit("kernel", **rec)
        records.append(rec)
        del got
    return records


def phase_serving(device, num_nodes: int, n_novel: int, seed: int) -> dict:
    """The user's entry points, `python -m taxoexpan_torch.test_fast` and
    `python -m taxoexpan_torch.infer` (their main functions, in this
    process), on a run directory as the JAX train.py leaves it: dataset
    pickle, config.json, checkpoint."""
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch import infer as infer_cli
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.weights import (load_jax_checkpoint,
                                         restore_params, save_jax_checkpoint)

    cfg, model = mag_model()
    in_dim = cfg["arch"]["args"]["in_dim"]
    taxonomy = synthetic_taxonomy(num_nodes=num_nodes, dim=in_dim, seed=seed)
    rng = np.random.default_rng(seed)
    held = np.asarray(taxonomy.test_node_ids[:n_novel], dtype=np.int64)
    novel = taxonomy.features[held] + 0.1 * rng.normal(
        size=(len(held), in_dim)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp)
        taxonomy.save(str(run / "synthetic.pickle.bin"))
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"].update(
                data_path=str(run / "synthetic.pickle.bin"),
                max_parents=MAG_P, expand_factor=MAG_S)
        (run / "config.json").write_text(json.dumps(cfg))
        ckpt = str(run / "model_random.ckpt")
        save_jax_checkpoint(ckpt, model.init(
            torch.Generator().manual_seed(seed)), cfg)
        with open(run / "novel.txt", "w") as fout:
            for i, row in enumerate(novel):
                fout.write(f"novel term {i}\t{' '.join(map(str, row))}\n")

        # ---- the main path, with the launch counters around it
        gk.gat_layer_fwd.launches = 0
        gk.gat_layer_pooled_fwd.launches = 0
        t0 = time.time()
        metrics = test_fast_cli.main(test_fast_cli.parse_args(
            ["-r", ckpt, "-c", str(run / "case.tsv")]))
        t1 = time.time()
        preds = infer_cli.main(infer_cli.parse_args(
            ["-r", ckpt, "-t", str(run / "novel.txt"),
             "-s", str(run / "predictions.tsv")]))
        torch.cuda.synchronize()
        t2 = time.time()
        launches = {"gat_layer_fwd": gk.gat_layer_fwd.launches,
                    "gat_layer_pooled_fwd": gk.gat_layer_pooled_fwd.launches}

        # ---- checks
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"the serving path never launched "
                                     f"{name}")
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
        n_cases = len((run / "case.tsv").read_text().splitlines())
        n_pred_lines = len((run / "predictions.tsv").read_text()
                           .splitlines())
        state = load_jax_checkpoint(ckpt)
    test_cfg = dict(cfg["test_data_loader"]["args"], sampling_mode=0)
    sampler = builders.build_sampler(taxonomy, test_cfg, "test")
    if n_cases != 1 + len(sampler.node_list) or n_pred_lines != 1 + n_novel:
        raise AssertionError(f"case study has {n_cases} lines, predictions "
                             f"{n_pred_lines}")
    if len(preds) != n_novel or any(
            len(row) != 5 or not 0 <= min(row) <= max(row) < num_nodes
            for row in preds):
        raise AssertionError(f"malformed predictions {preds}")

    # the card's graph embeddings against the CPU plain path
    params = restore_params(state, model)
    ranker = TaxonomyRanker(model, params, sampler, sampler.node_features,
                            device=device)
    t3 = time.time()
    hg = ranker.encode_all_anchors()
    encode_s = time.time() - t3
    if not torch.isfinite(hg).all():
        raise AssertionError("non-finite graph embeddings")
    node_ids, ngp, nsib = (a[:256] for a in ranker._anchor_arrays())
    with torch.no_grad():
        ngp_t, nsib_t = torch.from_numpy(ngp), torch.from_numpy(nsib)
        feats = model.gather_feats(torch.from_numpy(sampler.node_features),
                                   torch.from_numpy(node_ids).long(),
                                   ngp_t, nsib_t)
        want = model.encode(params, feats, ngp_t, nsib_t)
    hg_check = compare("hg (card vs CPU plain path, first 256 anchors)",
                       hg[:256].cpu(), want)
    res = {"nodes": taxonomy.num_nodes, "dim": in_dim,
           "candidates": len(ranker.candidates),
           "queries": len(sampler.node_list),
           "encode_chunk": ranker.encode_chunk, "metrics": metrics,
           "test_fast_s": t1 - t0, "infer_s": t2 - t1, "encode_s": encode_s,
           "launches": launches, "novel_queries": n_novel,
           "predictions_head": preds[:2], "hg_vs_cpu": hg_check}
    emit("serving", **res)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU only", file=sys.stderr)
        return 2
    if not (REPO / "taxoexpan_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no taxoexpan_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from taxoexpan_torch.config import setup_logging
    setup_logging()          # the CLIs' stage timings, on stderr
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    info = phase_device()
    phase_build()
    records = phase_kernels(BATCH, device)
    serving = phase_serving(device, NODES, N_NOVEL, SEED)
    kernels = []
    for rec in records:
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": serving["launches"][rec["name"]],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
