#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taxoexpan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device   - requires CUDA; prints the card's name and power limit
              (nvidia-smi) and turns TF32 off for full float32 products.
2. build    - builds every CUDA kernel from taxoexpan_torch/ops/csrc with
              nvcc for sm_90a (one nvcc per source, started together).
3. masks    - the kernels' dropout generator on the card against the
              plain torch generator (ops/dropout.py): the pinned golden
              vector and 2**20 random (row, column) pairs, bit for bit.
4. kernels  - each kernel against its plain PyTorch version on the card at
              the shapes of configs/config.mag.json (PGAT, in 250,
              hidden/out 500, pos 50, heads [4, 1]; 13 grandparent and 50
              sibling slots, N = 64) for 4096 egonets (one encode chunk,
              one train step), with random ngp/nsib including empty and
              full egonets: K1 and K3 in eval form, K1 and K3 in train
              form (feature, pe and attention dropout at the config's 0.1,
              the pe path), K2 (layer 0's backward, need_dx off) and K4
              (the final layer's backward, need_dx on) with every gradient
              compared, the masks regenerated by the plain versions; times
              of the kernel, its plain version and one torch.matmul as a
              yardstick (`matmul_ms`: x @ W for a forward, the dW product
              x^T @ D for a backward; not the layer, so the `library_ms` of
              the kernels line is null), beside the least time the card
              could take.
5. serving  - the port's serving path end to end through its entry
              points: a run directory with a synthetic taxonomy (4000
              nodes, dim 250), config.mag.json and the model from random
              weights (seeded) in the JAX checkpoint format; then
              `taxoexpan_torch.test_fast` (TaxonomyRanker.evaluate, the
              test_fast metrics) and `taxoexpan_torch.infer`
              (predict_parents for 8 novel terms), with the launch counters
              set to 0 just before and read just after. The card's graph
              embeddings are checked against the CPU plain path.
6. training - `python -m taxoexpan_torch.train` (its main, in this
              process) on a run directory with a synthetic taxonomy (800
              nodes, dim 250: five full steps and one padded step of 128
              groups x 32 candidates = 4096 egonets an epoch) and
              config.mag.json at full width with full-catalog validation
              every epoch, for two epochs, the launch counters set to 0
              just before and read just after; checks a finite loss,
              changed params, the checkpoints, launches of K1/K3 train,
              K2 and K4; serves the best checkpoint through
              `taxoexpan_torch.test_fast`; and holds one train step on the
              card against the same step on the CPU plain path (same
              params, seeds and dropout; 4 groups at full width).
7. a `{"kernels": [...]}` line (K1/K3 eval launches from the serving
   phase, the train-path kernels' from the training phase), then the
   card's nvidia-smi line, and last `{"ok": true, "device": {...}}`.

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
# backward grads: dW and the slot sums reduce over all 262,144 rows of a
# batch in another order (split-K partial sums vs cuBLAS), with
# cancellation; held to 1e-3 relative plus 1e-3 of the grad's largest value
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-3
MAG_P, MAG_S = 13, 50          # max_parents, expand_factor -> N = 64
BATCH = 4096                   # egonets per kernel call: one encode_chunk
NODES, N_NOVEL, SEED = 4000, 8, 0
TRAIN_NODES, TRAIN_EPOCHS = 800, 2
REPLACES = {
    "gat_layer_fwd": "taxoexpan_tpu/ops/pallas_gat.py:838",
    "gat_layer_pooled_fwd": "taxoexpan_tpu/ops/pallas_gat.py:1105",
    "gat_layer_fwd_train": "taxoexpan_tpu/ops/pallas_gat.py:838",
    "gat_layer_pooled_fwd_train": "taxoexpan_tpu/ops/pallas_gat.py:1105",
    "gat_layer_bwd": "taxoexpan_tpu/ops/pallas_gat.py:991",
    "gat_layer_pooled_bwd": "taxoexpan_tpu/ops/pallas_gat.py:1188",
}


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


def compare(name: str, got, want, rtol=RTOL, atol=ATOL) -> dict:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    rel = diff / want.abs().clamp(min=max(atol, 1e-30))
    res = {"max_abs_err": float(diff.max()), "max_rel_err": float(rel.max()),
           "rtol": rtol, "atol": atol}
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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def fwd_work(pooled: bool, x, ops, pe_pack, ngp, nsib, heads: int,
             out_elems: int):
    """(bytes, operations) a forward needs on these inputs: each input read
    once and the output written once; the [x | pe] @ [fc | wa1 | wa2]
    products over the rows the output depends on, plus the aggregation."""
    b, n, din = x.shape
    hd = ops[0].shape[1]
    dh = hd // heads
    kx = din + (pe_pack[0].shape[1] if pe_pack else 0)
    nbytes = _nbytes(x, *ops, ngp, nsib, *(pe_pack or ())) + out_elems * 4
    ngp_sum = float(ngp.double().sum())
    if not pooled:
        rows = b * n                      # every slot is an output row
        agg = heads * dh * (3 * b * MAG_S + 2 * (ngp_sum + b)) + b * n * hd
    else:
        # invalid slots contribute nothing to the pools
        rows = float((ngp + 1 + nsib).double().sum())
        nsib_sum = float(nsib.double().sum())
        agg = heads * dh * (3 * nsib_sum + 2 * (ngp_sum + b) + ngp_sum)
    flops = 2.0 * rows * kx * (hd + 2 * heads) + agg
    return nbytes, flops


def bwd_work(x, ops, pe_pack, g, grads: dict, ngp, nsib, heads: int):
    """(bytes, operations) a backward needs on these inputs: inputs (x,
    weights, pe operands, the incoming grad) read once, the grads written
    once; over the rows the grads depend on (the valid slots: the incoming
    grad is zero on the others), the recompute of [x | pe] @ W, the dW
    product, the dx / dpe product and about 8 operations a (row, column)
    for the aggregation's backward."""
    b, n, din = x.shape
    hd = ops[0].shape[1]
    pos = pe_pack[0].shape[1] if pe_pack else 0
    wd, kx = hd + 2 * heads, din + pos
    nbytes = _nbytes(x, *ops, ngp, nsib, *(pe_pack or ()), g,
                     *grads.values())
    rows = float((ngp + 1 + nsib).double().sum())
    dx_cols = (din if grads.get("x") is not None else 0) + pos
    flops = 2.0 * rows * wd * (2 * kx + dx_cols) + 8.0 * rows * hd
    return nbytes, flops


def _bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "operations": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare_grads(name: str, got: dict, want: dict) -> dict:
    """Every grad the kernel returned against the plain version's."""
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for key, g in got.items():
        if g is None:
            continue
        scale = float(want[key].abs().max())
        res = compare(f"{name} d{key}", g, want[key], rtol=GRAD_RTOL,
                      atol=GRAD_ATOL_REL * scale)
        for k in worst:
            worst[k] = max(worst[k], res[k])
    return {**worst, "rtol": GRAD_RTOL, "atol": f"{GRAD_ATOL_REL} x max|grad|",
            "grads": sorted(k for k, v in got.items() if v is not None)}


def phase_masks(device) -> dict:
    """The dropout generator of the kernels against the plain version."""
    import torch
    from taxoexpan_torch.ops import dropout
    for (seed, stream, row, col), want in dropout.GOLDEN_BITS:
        got = dropout.bits(seed, stream, torch.tensor([row], device=device),
                           torch.tensor([col], device=device))
        if int(got[0]) != want:
            raise AssertionError(f"golden bits of {(seed, stream, row, col)}"
                                 f": card {int(got[0])}, pinned {want}")
    gen = torch.Generator().manual_seed(SEED)
    rows = torch.randint(0, 2 ** 32, (1 << 20,), generator=gen,
                         dtype=torch.int64)
    cols = torch.randint(0, 2 ** 32, (1 << 20,), generator=gen,
                         dtype=torch.int64)
    got = dropout.bits(7, 3, rows.to(device), cols.to(device)).cpu()
    mismatched = int((got != dropout.bits_plain(7, 3, rows, cols)).sum())
    if mismatched:
        raise AssertionError(f"{mismatched} of 2**20 bits differ between "
                             "the card and the plain generator")
    res = {"golden": len(dropout.GOLDEN_BITS), "random_pairs": 1 << 20,
           "mismatched": mismatched}
    emit("masks", **res)
    return res


def phase_kernels(batch: int, device, drop: float) -> list[dict]:
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import star
    from taxoexpan_torch.weights import params_to
    _cfg, model = mag_model()
    gen = torch.Generator().manual_seed(SEED)
    prop = model.propagate
    params = params_to(model.init(gen), device)["propagate"]
    x0, ngp, nsib = random_egonets(gen, batch, prop.layer_specs[0][0]
                                   - prop.pos_dim, device)
    n = x0.shape[1]
    ops0, _ = prop.operands(params, 0, n, MAG_P)
    ops1, _ = prop.operands(params, 1, n, MAG_P)
    # train form: the pe rows and W_p tail rows as pe_pack, zero biases
    tops0, pe0 = prop.operands(params, 0, n, MAG_P, pe_dropout=True)
    tops1, pe1 = prop.operands(params, 1, n, MAG_P, pe_dropout=True)
    h0, h1 = prop.layer_specs[0][2], prop.layer_specs[1][2]
    tkw0 = dict(pe_pack=pe0, seed=11, feat_drop=drop, attn_drop=drop)
    tkw1 = dict(pe_pack=pe1, seed=12, feat_drop=drop, attn_drop=drop)
    with torch.no_grad():
        x1 = gk.gat_layer_fwd_plain(x0, *ops0, ngp, nsib, MAG_P, h0,
                                    out_alpha=0.01)
        x1t = gk.gat_layer_train_plain(x0, *tops0, ngp, nsib, MAG_P, h0,
                                       out_alpha=0.01, **tkw0)
    valid = star.node_mask(ngp, nsib, MAG_P, n)[..., None]
    # incoming grads as the train step gives them: layer 1's dx is zero on
    # invalid slots; the pool grads are dense. Layer 0 fuses leaky_relu
    # (0.01), whose derivative jumps 100x at 0: where the recomputed
    # pre-activation lies within 1e-5 of 0, float32 rounding may put the
    # kernel and the plain version on different sides, so g0 is 0 there
    # and the comparison stays well-posed
    with torch.no_grad():
        pre = gk.gat_layer_train_plain(x0, *tops0, ngp, nsib, MAG_P, h0,
                                       **tkw0)
        away = pre.abs() > 1e-5
        near_kink_share = 1.0 - float(away.double().mean())
        del pre
    g0 = (torch.randn(x1t.shape, generator=gen).to(device) * 1e-3) * valid \
        * away
    del away
    g1 = torch.randn((batch, 3, prop.out_dim), generator=gen).to(device) \
        * 1e-2
    fwd, bwd = "taxoexpan_torch/ops/csrc/gat_fwd.cu", \
        "taxoexpan_torch/ops/csrc/gat_bwd.cu"
    cases = [
        ("gat_layer_fwd", fwd, False, x0, ops0, None, h0,
         lambda: gk.gat_layer_fwd(x0, *ops0, ngp, nsib, MAG_P, h0,
                                  out_alpha=0.01),
         lambda: gk.gat_layer_fwd_plain(x0, *ops0, ngp, nsib, MAG_P, h0,
                                        out_alpha=0.01)),
        ("gat_layer_pooled_fwd", fwd, True, x1, ops1, None, h1,
         lambda: gk.gat_layer_pooled_fwd(x1, *ops1, ngp, nsib, MAG_P, h1),
         lambda: gk.gat_layer_pooled_fwd_plain(x1, *ops1, ngp, nsib, MAG_P,
                                               h1)),
        ("gat_layer_fwd_train", fwd, False, x0, tops0, pe0, h0,
         lambda: gk.gat_layer_fwd_train(x0, *tops0, ngp, nsib, MAG_P, h0,
                                        out_alpha=0.01, **tkw0),
         lambda: gk.gat_layer_train_plain(x0, *tops0, ngp, nsib, MAG_P, h0,
                                          out_alpha=0.01, **tkw0)),
        ("gat_layer_pooled_fwd_train", fwd, True, x1t, tops1, pe1, h1,
         lambda: gk.gat_layer_pooled_fwd_train(x1t, *tops1, ngp, nsib,
                                               MAG_P, h1, **tkw1),
         lambda: gk.gat_layer_train_plain(x1t, *tops1, ngp, nsib, MAG_P, h1,
                                          pooled=True, **tkw1)),
        # layer 0's backward in the train step: need_dx off (fixed input
        # features), slot-bias grads off (zero biases on the pe path)
        ("gat_layer_bwd", bwd, False, x0, tops0, pe0, h0,
         lambda: gk.gat_layer_bwd(g0, x0, *tops0, ngp, nsib, MAG_P, h0,
                                  out_alpha=0.01, need_dx=False,
                                  need_dbias=False, **tkw0),
         lambda: gk.gat_layer_bwd_plain(g0, x0, *tops0, ngp, nsib, MAG_P, h0,
                                        out_alpha=0.01, need_dx=False,
                                        **tkw0)),
        ("gat_layer_pooled_bwd", bwd, True, x1t, tops1, pe1, h1,
         lambda: gk.gat_layer_pooled_bwd(g1, x1t, *tops1, ngp, nsib, MAG_P,
                                         h1, need_dx=True, need_dbias=False,
                                         **tkw1),
         lambda: gk.gat_layer_bwd_plain(g1, x1t, *tops1, ngp, nsib, MAG_P,
                                        h1, pooled=True, need_dx=True,
                                        **tkw1)),
    ]
    records = []
    for name, source, pooled, x, ops, pe_pack, heads, kernel, plain in cases:
        backward = name.endswith("_bwd")
        x2 = x.reshape(-1, x.shape[-1])
        fc = ops[0]
        with torch.no_grad():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            if backward:
                err = compare_grads(name, got, want)
            else:
                err = compare(name, got, want)
            del want
            ms = time_ms(kernel, 5 if backward else 10)
            plain_ms = time_ms(plain, 3)
            if backward:
                d = torch.randn((x2.shape[0], fc.shape[1] + 2 * heads),
                                device=device)
                matmul_ms = time_ms(lambda: x2.T @ d, 5)
                call = "torch.matmul(x.reshape(-1, Din).T, D [B*N, H*Dh+2H])"
                del d
                nbytes, flops = bwd_work(x, ops, pe_pack,
                                         g1 if pooled else g0, got, ngp,
                                         nsib, heads)
            else:
                matmul_ms = time_ms(lambda: x2 @ fc, 10)
                call = "torch.matmul(x.reshape(-1, Din), fc)"
                nbytes, flops = fwd_work(pooled, x, ops, pe_pack, ngp, nsib,
                                         heads, got.numel())
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": REPLACES[name], "batch": batch,
               "x_shape": list(x.shape), "fc_shape": list(fc.shape),
               "pe": pe_pack is not None,
               **({"near_kink_share": near_kink_share}
                  if name == "gat_layer_bwd" else {}),
               "dropout": drop if pe_pack is not None else 0.0,
               **err, "ms": ms, "plain_ms": plain_ms,
               # no single PyTorch call computes the star-GAT layer or its
               # backward; one product alone is timed as a yardstick
               "library_ms": None, "matmul_ms": matmul_ms,
               "matmul_call": call, **_bound(nbytes, flops)}
        emit("kernel", **rec)
        records.append(rec)
        del got
        torch.cuda.empty_cache()
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


def compare_train_step(device, cfg: dict, taxonomy, params: dict,
                       groups: int = 4) -> dict:
    """One train step (forward, loss, grads, AMSGrad update) on the card
    against the same step on the CPU plain path: same params, batch, step
    index (so the same dropout seeds and masks), full width.

    Tolerances: loss 1e-4 relative; each grad to 1e-3 of its leaf's largest
    value plus 1e-6 of the step's largest grad (float32 through two layers,
    sums over 8192 slots in another order; a leaf whose grad vanishes
    analytically, such as the final layer's attn_r wherever both sibling
    logits share a sign, holds rounding noise only); each updated param to
    1e-5 where its grad is at least max(1e-6, 1e-3 of the leaf's largest),
    and within 2 * lr elsewhere: AMSGrad's first step
    lr * g / (|g| + 1e-8) turns float32 rounding of a near-zero grad into
    any step in [-lr, lr]."""
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.training.trainer import Trainer, batch_to
    from taxoexpan_torch.tree import tree_leaves
    train_cfg = dict(cfg["train_data_loader"]["args"], batch_size=groups,
                     num_workers=0)
    sampler = builders.build_sampler(taxonomy, train_cfg, "train")
    model = builders.build_model(cfg["arch"], max_parents=sampler.max_parents,
                                 expand_factor=sampler.expand_factor)
    batch = next(iter(builders.build_loader(sampler, train_cfg)))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for dev in (device, torch.device("cpu")):
            opt = builders.build_optimizer_from_config(cfg["optimizer"],
                                                       cfg["trainer"])
            tr = Trainer(model, params, opt, opt.init(params),
                         loss_name=cfg["loss"], metric_names=cfg["metrics"],
                         feature_table=sampler.node_features,
                         train_loader=None, save_dir=tmp, device=dev)
            t0 = time.time()
            loss, grads = tr.train_step(batch_to(batch, dev), 12345,
                                        return_grads=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append((float(loss), time.time() - t0,
                        [g.cpu() for g in tree_leaves(grads)],
                        [q.cpu() for q in tree_leaves(tr.params)]))
    (l_gpu, s_gpu, g_gpu, p_gpu), (l_cpu, s_cpu, g_cpu, p_cpu) = out
    lr = float(cfg["optimizer"]["args"]["lr"])
    if not np.isfinite(l_gpu) or abs(l_gpu - l_cpu) > 1e-4 * abs(l_cpu):
        raise AssertionError(f"train step loss: card {l_gpu}, CPU {l_cpu}")
    worst_g = worst_p = 0.0
    n_tiny = n_all = 0
    step_max = max(float(g.abs().max()) for g in g_cpu)
    for gg, gc, pg, pc in zip(g_gpu, g_cpu, p_gpu, p_cpu):
        scale = float(gc.abs().max())
        dg = float((gg - gc).abs().max())
        if dg > 1e-3 * scale + 1e-6 * step_max:
            raise AssertionError(f"train step grad differs by {dg} (leaf "
                                 f"max {scale}, step max {step_max})")
        worst_g = max(worst_g, dg / max(scale, 1e-6 * step_max))
        tiny = gc.abs() < max(1e-6, 1e-3 * scale)
        dp = (pg - pc).abs()
        if bool((dp[~tiny] > 1e-5).any()) or bool((dp[tiny] > 2 * lr).any()):
            raise AssertionError(f"train step params differ by "
                                 f"{float(dp.max())}")
        if bool((~tiny).any()):
            worst_p = max(worst_p, float(dp[~tiny].max()))
        n_tiny += int(tiny.sum())
        n_all += tiny.numel()
    return {"egonets": int(batch.labels.size), "loss_card": l_gpu,
            "loss_cpu": l_cpu, "step_s_card_first": s_gpu,
            "step_s_cpu": s_cpu, "max_grad_err_rel_to_leaf_max": worst_g,
            "largest_grad": step_max,
            "max_param_err_well_conditioned": worst_p,
            "near_zero_grad_share": n_tiny / max(n_all, 1)}


def phase_training(device, num_nodes: int, epochs: int, seed: int) -> dict:
    """`python -m taxoexpan_torch.train` (its main, in this process) on a
    synthetic run directory at config.mag.json's full width."""
    import numpy as np
    import torch
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch import train as train_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.tree import tree_leaves
    from taxoexpan_torch.weights import load_jax_checkpoint, restore_params

    cfg, model = mag_model()
    in_dim = cfg["arch"]["args"]["in_dim"]
    taxonomy = synthetic_taxonomy(num_nodes=num_nodes, dim=in_dim, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp)
        taxonomy.save(str(run / "synthetic.pickle.bin"))
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"].update(
                data_path=str(run / "synthetic.pickle.bin"),
                max_parents=MAG_P, expand_factor=MAG_S)
        cfg["trainer"].update(epochs=epochs, save_dir=str(run / "saved"),
                              full_validation_every=1, tensorboardX=False,
                              step_timing=True)
        (run / "config.json").write_text(json.dumps(cfg))
        config = train_cli.parse_args(["-c", str(run / "config.json")])

        # ---- the main path, with the launch counters around it
        for wrapper in gk.WRAPPERS.values():
            wrapper.launches = 0
        t0 = time.time()
        log = train_cli.main(config)
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = {name: w.launches for name, w in gk.WRAPPERS.items()}

        # ---- checks
        for name in ("gat_layer_fwd_train", "gat_layer_pooled_fwd_train",
                     "gat_layer_bwd", "gat_layer_pooled_bwd"):
            if launches[name] <= 0:
                raise AssertionError(f"training never launched {name}")
        if not np.isfinite(log["loss"]):
            raise AssertionError(f"non-finite training loss {log['loss']}")
        best = config.save_dir / "model_best.ckpt"
        last = config.save_dir / f"checkpoint-epoch{epochs}.ckpt"
        if not (best.exists() and last.exists()):
            raise AssertionError(f"checkpoints missing in {config.save_dir}")
        state = load_jax_checkpoint(last)
        trained = restore_params(state, model)
        init = model.init(torch.Generator().manual_seed(cfg.get("seed", 0)))
        changed = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(trained), tree_leaves(init)))
        if not changed > 0:
            raise AssertionError("training left the params unchanged")
        t1 = time.time()
        metrics = test_fast_cli.main(test_fast_cli.parse_args(["-r",
                                                               str(best)]))
        serve_s = time.time() - t1
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite metrics of the trained "
                                 f"checkpoint {bad}")
    step_ms = log.get("step_ms", [])
    egonets_per_step = (cfg["train_data_loader"]["args"]["batch_size"]
                        * (1 + cfg["train_data_loader"]["args"]
                           ["negative_size"]))
    median_ms = float(np.median(step_ms)) if step_ms else float("nan")
    res = {"card": nvidia_smi_line(), "nodes": taxonomy.num_nodes,
           "dim": in_dim, "epochs": epochs,
           "steps_last_epoch": len(step_ms),
           "egonets_per_step": egonets_per_step,
           "step_ms_last_epoch": step_ms, "median_step_ms": median_ms,
           "egonets_per_s_median_step": egonets_per_step / median_ms * 1e3,
           "egonets_per_s_epoch": log["egonets_per_sec"],
           "loss_last_epoch": log["loss"],
           "val_metrics_last_epoch": {k[4:]: v for k, v in log.items()
                                      if k.startswith("val_")},
           "train_s": train_s, "max_param_change": changed,
           "launches": launches, "served_metrics": metrics,
           "serve_s": serve_s,
           "step_vs_cpu": compare_train_step(device, cfg, taxonomy, trained)}
    emit("training", **res)
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
    phase_masks(device)
    cfg, _ = mag_model()
    drop = cfg["arch"]["args"]["feat_drop"]
    records = phase_kernels(BATCH, device, drop)
    serving = phase_serving(device, NODES, N_NOVEL, SEED)
    training = phase_training(device, TRAIN_NODES, TRAIN_EPOCHS, SEED)
    kernels = []
    for rec in records:
        # eval forms: the serving path's launches; train forms and the
        # backwards: the training path's
        phase = serving if rec["name"] in serving["launches"] else training
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": phase["launches"][rec["name"]],
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
