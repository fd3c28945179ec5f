#!/usr/bin/env python3
"""Peak device memory and device time of one full-width train step, for a
checkout of the PyTorch port given on the command line.

    python3 scripts/step_memory.py [--path PGAT-bf16 ...] CHECKOUT [...]

For each checkout (a directory holding `taxoexpan_torch/`) and each path,
in a process of its own, so that each imports and builds its own package:
the path's configuration (`configs/config.mag.json` with the path's keys:
compute_dtype bfloat16 for the "-bf16" paths, pos_mode "concat" for the
"-concat" ones, propagation_method PGCN for the PGCN paths) at full
width, random weights from seed 0, a synthetic 800-node
taxonomy (dim 250), and one batch of the configuration's 128 groups x 32
candidates = 4096 egonets. After two warm-up steps it resets the
allocator's peak, runs three steps, and prints one JSON line:
`torch.cuda.max_memory_allocated` above the memory held before the steps
(the step's own workspaces, activations and grads), the mean step time
(CUDA events), and the card's nvidia-smi line; then three more steps
under torch.profiler, read back by the checkout's own
`chip_smoke.trace_split`: their device-busy ms a step (the union of the
kernels' intervals), the device's idle share and the kernel launches a
step (the profiler slows the host, so these steps are not the timed
ones). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

STEP = r"""
import json, subprocess, sys, tempfile
sys.path.insert(0, sys.argv[1])
import torch
from taxoexpan_torch import builders
from taxoexpan_torch.data.synthetic import synthetic_taxonomy
from taxoexpan_torch.training.trainer import Trainer, batch_to
from taxoexpan_torch.weights import params_to
cfg = json.load(open(sys.argv[1] + "/configs/config.mag.json"))
cfg["arch"]["args"]["propagation_method"] = sys.argv[2].split("-")[0]
if sys.argv[2].endswith("-bf16"):
    cfg["arch"]["args"]["compute_dtype"] = "bfloat16"
if "-concat" in sys.argv[2]:
    cfg["arch"]["args"]["pos_mode"] = "concat"
dev = torch.device("cuda", 0)
taxonomy = synthetic_taxonomy(num_nodes=800, dim=cfg["arch"]["args"]["in_dim"],
                              seed=0)
loader_cfg = dict(cfg["train_data_loader"]["args"], num_workers=0)
sampler = builders.build_sampler(taxonomy, loader_cfg, "train")
model = builders.build_model(cfg["arch"], max_parents=sampler.max_parents,
                             expand_factor=sampler.expand_factor)
params = params_to(model.init(torch.Generator().manual_seed(0)), dev)
batch = next(iter(builders.build_loader(sampler, loader_cfg)))
opt = builders.build_optimizer_from_config(cfg["optimizer"], cfg["trainer"])
with tempfile.TemporaryDirectory() as tmp:
    tr = Trainer(model, params, opt, opt.init(params), loss_name=cfg["loss"],
                 metric_names=cfg["metrics"],
                 feature_table=sampler.node_features, train_loader=None,
                 save_dir=tmp, device=dev)
    b = batch_to(batch, dev)
    for i in range(2):
        tr.train_step(b, i)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(3):
        tr.train_step(b, 2 + i)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated(dev) - base
    # three more steps traced, for the device's busy time and idle share
    from pathlib import Path
    from chip_smoke import trace_split
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(3):
            tr.train_step(b, 5 + i)
        torch.cuda.synchronize()
    prof.export_chrome_trace(tmp + "/trace.json")
    split = trace_split(Path(tmp) / "trace.json")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip().splitlines()[0]
print(json.dumps({"checkout": sys.argv[1], "path": sys.argv[2],
                  "egonets": int(batch.labels.size),
                  "step_peak_bytes": peak, "held_before_bytes": base,
                  "step_ms": step_ms,
                  "traced_device_busy_ms_per_step":
                  split["device_busy_ms"] / 3,
                  "traced_wall_ms_per_step": split["wall_ms"] / 3,
                  "traced_device_idle_share": split["device_idle_share"],
                  "traced_kernel_launches_per_step":
                  split["kernel_launches"] / 3,
                  "card": card}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--path", nargs="+", default=["PGAT-bf16"],
                    choices=("PGAT", "PGAT-bf16", "PGAT-concat",
                             "PGAT-concat-bf16", "PGCN", "PGCN-concat"))
    args = ap.parse_args()
    rc = 0
    for tree, path in ((t, p) for t in args.checkouts for p in args.path):
        proc = subprocess.run([sys.executable, "-c", STEP,
                               str(Path(tree).resolve()), path],
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if proc.returncode == 0 and lines else json.dumps(
            {"checkout": tree, "rc": proc.returncode,
             "stderr": proc.stderr[-2000:]}), flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
