"""Reference-scale training run of the port, the torch counterpart of
`scripts/reference_scale_run.py` (which produced artifacts/MAG_SCALE_RUN.md):

    python -m taxoexpan_torch.reference_scale_run
    python -m taxoexpan_torch.reference_scale_run --out /tmp/RUN.md
    # MAG-Full scale: 355000 nodes, evaluated in 30000-anchor chunks
    python -m taxoexpan_torch.reference_scale_run --nodes 355000 \
        --epochs 4 --eval_batch_size 30000 \
        --out artifacts/MAG_FULL_SCALE_H100.md

1. data: `data/synthetic.py:synthetic_taxonomy_v2` with 30000 nodes (or
   `--nodes`), dim 250, max_children 40, noise 1.0, seed 42 (the v2
   benchmark: cosine-to-parent fails by construction), pickled into the
   work directory;
2. config: artifacts/config.mag_scale.json as it is (PGAT, CR readout, BIM,
   bf16, 128 groups x 32 candidates, full-catalog validation every epoch,
   40 epochs), with only its data and save paths pointed at the work
   directory (in memory; the file is not edited);
3. training: `python -m taxoexpan_torch.train` on it;
4. evaluation: `python -m taxoexpan_torch.test_fast -r model_best.ckpt`
   (with `-b` from `--eval_batch_size`: anchors encoded a chunk), and the
   simple_parent baseline on the same data;
5. a Markdown report (default artifacts/MAG_SCALE_RUN_H100.md): the card's
   name and power limit, each stage's wall clock (generation, pickling,
   the trainer's data load and samplers, every epoch with its split:
   wait_s, step_s, sync_s, valid_s, checkpoint_s, egonets/s; evaluation by
   its stages; simple_parent), the peak device memory of training and of
   evaluation, the host's peak resident memory of each process, the
   checkpoint's size, and the test metrics beside the committed TPU run's,
   the 30000-node run's on the card (artifacts/MAG_SCALE_RUN_H100.md, when
   the report is another file) and the bars below.

Runs on the card unless `-d cpu`. The widths, batch and epochs can be
cut (`--dim`, `--hidden`, `--pos`, `--batch_size`, `--epochs`) and the
tensorboard writer turned off (`--no_tensorboard`) for a small rehearsal;
the report lists every cut (a node count other than the two operating
points of SIZES is one). Generated data,
checkpoints and logs stay in the work directory (default `_scale_run/` at
the repository root, listed in .gitignore).
"""
from __future__ import annotations

import argparse
import json
import re
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "artifacts" / "config.mag_scale.json"
TPU_RUN = REPO / "artifacts" / "MAG_SCALE_RUN.md"
H100_RUN = REPO / "artifacts" / "MAG_SCALE_RUN_H100.md"
DATA = dict(num_nodes=30000, dim=250, max_children=40, noise=1.0, seed=42)
# the node counts the report names as operating points, not cuts: the
# MAG-scale run's and the reference's largest, MAG-Full (about 355k nodes,
# evaluated in 30000-anchor chunks; VERDICT.md:34)
SIZES = {30000: "MAG-scale", 355000: "MAG-Full, the reference's size"}
QUALITY = ("macro_mr", "hit_at_1", "hit_at_3", "mrr_scaled_10")
# the bars of the run: the JAX runs at this scale span macro_mr
# 1.004-1.089 (artifacts/MAG_SCALE_RUN.md and its CR/WMR A/B)
BARS = {"macro_mr": ("<=", 1.15), "hit_at_1": (">=", 0.96),
        "hit_at_3": (">=", 0.985), "mrr_scaled_10": (">=", 0.995)}
LOADERS = ("train_data_loader", "validation_data_loader", "test_data_loader")
SPLIT = ("wait_s", "step_s", "sync_s", "valid_s")


def run(cmd: list[str], log: Path, timeout: float) -> tuple[str, float]:
    """Run cmd from the repository root; its output (stdout and stderr)
    into `log`; returns (output, wall seconds). Raises if it fails."""
    print("+", " ".join(cmd), flush=True)
    t0 = time.time()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=timeout)
    dt = time.time() - t0
    out = r.stdout + r.stderr
    log.write_text(out)
    if r.returncode != 0:
        print(out[-4000:], file=sys.stderr)
        raise SystemExit(f"{cmd[2]} failed ({r.returncode}); log: {log}")
    return out, dt


def metrics_of(text: str) -> dict:
    """The last logged metrics dict of test_fast ({'macro_mr': ...})."""
    found = re.findall(r"\{[^{}]*'macro_mr'[^{}]*\}", text)
    if not found:
        return {}
    return {k: float(v) for k, v in re.findall(
        r"'(\w+)': (?:np\.float64\()?([-\d.eE+]+|nan|inf)", found[-1])}


def table_metrics(text: str) -> dict:
    """The first value column of a report's test-metrics table
    (`| macro_mr | 1.0086... | ...`)."""
    return {m: float(v) for m, v in re.findall(
        r"^\| (\w+) \| ([-\d.eE+]+) \|", text, re.M) if m in QUALITY}


def memory_of(log: str) -> dict:
    """The last `memory_peaks` line of a CLI's log (device.memory_peaks):
    {"device_bytes": ..., "host_rss_kib": ...}."""
    found = re.findall(r"peak device memory (\d+) bytes, host max RSS "
                       r"(\d+) KiB", log)
    if not found:
        return {}
    dev, rss = found[-1]
    return {"device_bytes": int(dev), "host_rss_kib": int(rss)}


def stage_times(log: str, pattern: str, names: tuple) -> dict:
    """Seconds of the named stages from a CLI's stage-timing log line."""
    found = re.findall(pattern, log)
    return dict(zip(names, map(float, found[-1]))) if found else {}


def epoch_split(log: str) -> list[dict]:
    """Per epoch: the trainer's logged epoch_seconds, timing split,
    egonets/s, loss, val_macro_mr and checkpoint_s, in epoch order."""
    keys = {"epoch": r"epoch\s+: (\d+)",
            "epoch_seconds": r"epoch_seconds\s*: ([\d.e+-]+)",
            "egonets_per_sec": r"egonets_per_sec\s*: ([\d.e+-]+)",
            "loss": r"\bloss\s+: ([-\d.e+]+|nan)",
            "val_macro_mr": r"val_macro_mr\s*: ([\d.e+-]+|nan|inf)",
            "checkpoint_s": r"checkpoint_s\s*: ([\d.e+-]+)"}
    cols = {k: [float(v) for v in re.findall(p, log)]
            for k, p in keys.items()}
    timings = [json.loads(t.replace("'", '"')) for t in
               re.findall(r"timing\s*: (\{[^}]*\})", log)]
    rows = []
    for i, epoch in enumerate(cols["epoch"]):
        row = {"epoch": int(epoch)}
        for k in keys:
            if k != "epoch" and i < len(cols[k]):
                row[k] = cols[k][i]
        if i < len(timings):
            row.update(timings[i])
        rows.append(row)
    return rows


def card_line(device: str) -> str:
    if not device.startswith("cuda"):
        return f"{device} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def meets(metric: str, value) -> bool:
    op, bar = BARS[metric]
    return value is not None and (value <= bar if op == "<=" else value >= bar)


def report(args, cuts: list[str], card: str, t_data: float, t_train: float,
           t_eval: float, rows: list[dict], model: dict, tpu: dict,
           parent: dict, train_log: str, info: dict) -> str:
    n_ep = len(rows)
    lines = [
        "# Reference-scale training run of the port on the card",
        "",
        "Generated by `python -m taxoexpan_torch.reference_scale_run` "
        f"(device `{args.device}`), the torch counterpart of "
        "`scripts/reference_scale_run.py` (artifacts/MAG_SCALE_RUN.md, a "
        "TPU run).",
        "",
        f"- card: {card}",
        f"- dataset: synthetic_taxonomy_v2, {args.nodes} nodes"
        + (f" ({SIZES[args.nodes]})" if args.nodes in SIZES else "")
        + f", dim "
        f"{args.dim}, max_children {DATA['max_children']}, noise "
        f"{DATA['noise']}, seed {DATA['seed']} (made and pickled in "
        f"{t_data:.1f} s)",
        f"- config: artifacts/config.mag_scale.json with its data and save "
        f"paths pointed at the work directory"
        + (f"; cut: {', '.join(cuts)}" if cuts else "; nothing else changed")
        + f" ({n_ep} epochs run)",
        f"- training wall clock: {t_train:.1f} s (`python -m "
        f"taxoexpan_torch.train`, data loading and every epoch's "
        f"full-catalog validation and checkpoint included); evaluation "
        f"(`python -m taxoexpan_torch.test_fast -r model_best.ckpt"
        + (f" -b {args.eval_batch_size}" if args.eval_batch_size else "")
        + f"`): {t_eval:.1f} s",
    ]
    eps = [r["egonets_per_sec"] for r in rows if "egonets_per_sec" in r]
    if eps:
        rest = eps[1:] or eps
        lines.append(f"- egonets/s per epoch: median {np.median(rest):.1f} "
                     f"over epochs 2-{n_ep}, epoch 1 {eps[0]:.1f} (kernel "
                     f"builds included)")
    if rows:
        tot = {k: sum(r.get(k, 0.0) for r in rows)
               for k in SPLIT + ("checkpoint_s", "epoch_seconds")}
        lines.append("- summed over the epochs: " + ", ".join(
            f"{k} {tot[k]:.2f}" for k in tot) + " s")
    lines += stage_lines(info)
    h100 = info["h100_30k"]
    lines += ["", "## Test metrics (best checkpoint, full catalog)", "",
              "| metric | this run | TPU run (artifacts/MAG_SCALE_RUN.md) "
              + ("| H100, 30000 nodes (artifacts/MAG_SCALE_RUN_H100.md) "
                 if h100 else "")
              + "| simple_parent, same data | bar | met |",
              "|---|---|---|" + ("---|" if h100 else "") + "---|---|---|"]
    for m in QUALITY:
        v = model.get(m)
        lines.append(f"| {m} | {v if v is not None else 'missing'} | "
                     f"{tpu.get(m, 'n/a')} | "
                     + (f"{h100.get(m, 'n/a')} | " if h100 else "")
                     + f"{parent[m]} | {BARS[m][0]} {BARS[m][1]} | "
                     f"{'yes' if meets(m, v) else 'NO'} |")
    met = all(meets(m, model.get(m)) for m in QUALITY)
    lines += ["", "Bars " + ("met on every metric." if met else
                             "MISSED (see the table)."), "",
              "simple_parent (cosine retrieval) on the same data: "
              + ", ".join(f"{m} {parent[m]:.4f}" for m in QUALITY) + ".", "",
              "## Per-epoch split (the trainer's log)", "",
              "`wait_s`: the loop blocked on the host loader and the feed "
              "thread; `step_s`: the steps' host time (launches; the device "
              "runs behind); `sync_s`: the epoch's one loss readback (the "
              "device's drain); `valid_s`: full-catalog validation; "
              "`checkpoint_s`: the checkpoint's foreground cost (clones and "
              "the writer thread's start).", "",
              "| epoch | epoch_s | wait_s | step_s | sync_s | valid_s | "
              "checkpoint_s | egonets/s | loss | val_macro_mr |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append("| " + " | ".join(str(r.get(k, "")) for k in (
            "epoch", "epoch_seconds", *SPLIT, "checkpoint_s",
            "egonets_per_sec", "loss", "val_macro_mr")) + " |")
    tail = [ln for ln in train_log.strip().splitlines()][-12:]
    lines += ["", "## Training log tail", "", "```", *tail, "```", ""]
    return "\n".join(lines)


def stage_lines(info: dict) -> list[str]:
    """The report's stage wall clocks and memory peaks."""
    ev = info.get("eval_stages", {})
    setup = info.get("train_setup", {})
    rows = [("generation (synthetic_taxonomy_v2)", info.get("gen_s")),
            ("pickling", info.get("pickle_s")),
            ("training: data load (in the trainer)", setup.get("data")),
            ("training: samplers (train, validation, full validation) and "
             "loaders", setup.get("samplers")),
            ("training: the epochs (the table below)", info.get("epochs_s")),
            ("training process in all", info.get("train_s")),
            ("evaluation: data and test sampler", ev.get("data")),
            ("evaluation: checkpoint", ev.get("checkpoint")),
            ("evaluation: encode every candidate", ev.get("encode")),
            ("evaluation: rank every query", ev.get("rank")),
            ("evaluation process in all", info.get("eval_s")),
            ("simple_parent", info.get("parent_s"))]
    out = ["", "## Stages and memory", "", "| stage | wall s |", "|---|---|"]
    out += [f"| {name} | {v if v is not None else 'not logged'} |"
            for name, v in rows]
    tm, em = info.get("train_memory", {}), info.get("eval_memory", {})
    out += ["", "| process | peak device memory, bytes "
            "(`torch.cuda.max_memory_allocated`) | host max RSS, KiB |",
            "|---|---|---|",
            f"| training | {tm.get('device_bytes', 'not logged')} | "
            f"{tm.get('host_rss_kib', 'not logged')} |",
            f"| evaluation | {em.get('device_bytes', 'not logged')} | "
            f"{em.get('host_rss_kib', 'not logged')} |",
            f"| this tool (generation, pickling, simple_parent) | - | "
            f"{info.get('tool_rss_kib')} |", "",
            f"model_best.ckpt: {info.get('ckpt_bytes')} bytes."]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-d", "--device", default="cuda",
                    help="torch device (cuda | cuda:N | cpu)")
    ap.add_argument("--work", default=str(REPO / "_scale_run"),
                    help="data, run directories and logs")
    ap.add_argument("--out", default=str(REPO / "artifacts" /
                                         "MAG_SCALE_RUN_H100.md"))
    ap.add_argument("--nodes", type=int, default=DATA["num_nodes"])
    ap.add_argument("--dim", type=int, default=DATA["dim"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--hidden", type=int, default=None,
                    help="hidden_dim and out_dim")
    ap.add_argument("--pos", type=int, default=None, help="pos_dim")
    ap.add_argument("--batch_size", type=int, default=None,
                    help="groups a batch, train and validation")
    ap.add_argument("--no_tensorboard", action="store_true")
    ap.add_argument("--eval_batch_size", type=int, default=None,
                    help="anchors a chunk in the evaluation (test_fast -b); "
                         "the default is test_fast's")
    args = ap.parse_args(argv)
    from .data.synthetic import synthetic_taxonomy_v2
    from .baselines import simple_parent

    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    data = work / "synth_mag_cs_v2.pickle.bin"
    t0 = time.time()
    taxonomy = synthetic_taxonomy_v2(
        num_nodes=args.nodes, dim=args.dim,
        max_children=DATA["max_children"], noise=DATA["noise"],
        seed=DATA["seed"])
    t1 = time.time()
    taxonomy.save(str(data))
    t2 = time.time()
    t_data = t2 - t0
    info = {"gen_s": round(t1 - t0, 2), "pickle_s": round(t2 - t1, 2)}

    cfg = json.loads(CONFIG.read_text())
    for loader in LOADERS:
        cfg[loader]["args"]["data_path"] = str(data)
    cfg["trainer"]["save_dir"] = str(work / "saved")
    cuts = [] if args.nodes in SIZES else [f"{args.nodes} nodes"]
    a = cfg["arch"]["args"]
    for key, value in (("in_dim", args.dim if args.dim != a["in_dim"]
                        else None),
                       ("hidden_dim", args.hidden), ("out_dim", args.hidden),
                       ("pos_dim", args.pos)):
        if value is not None:
            a[key] = value
            cuts.append(f"{key} {value}")
    if args.batch_size is not None:
        for loader in LOADERS[:2]:
            cfg[loader]["args"]["batch_size"] = args.batch_size
        cuts.append(f"batch_size {args.batch_size}")
    if args.epochs is not None:
        cfg["trainer"]["epochs"] = args.epochs
        cuts.append(f"{args.epochs} epochs")
    if args.no_tensorboard:
        cfg["trainer"]["tensorboardX"] = False
        cuts.append("no tensorboard writer")
    (work / "config.json").write_text(json.dumps(cfg, indent=2))

    py = sys.executable
    train_log, t_train = run(
        [py, "-m", "taxoexpan_torch.train", "-c", str(work / "config.json"),
         "-d", args.device], work / "train.log", timeout=4 * 3600)
    runs = sorted((work / "saved" / "models" / cfg["name"]).iterdir())
    best = runs[-1] / "model_best.ckpt"
    eval_log, t_eval = run(
        [py, "-m", "taxoexpan_torch.test_fast", "-r", str(best), "-d",
         args.device]
        + (["-b", str(args.eval_batch_size)] if args.eval_batch_size
           else []), work / "test_fast.log", timeout=3600)
    model = metrics_of(eval_log)
    t_parent = time.time()
    parent = simple_parent.evaluate(taxonomy)
    info["parent_s"] = round(time.time() - t_parent, 2)
    tpu = metrics_of(TPU_RUN.read_text()) if TPU_RUN.exists() else {}
    rows = epoch_split(train_log)
    out = Path(args.out)
    info.update(
        train_s=round(t_train, 2), eval_s=round(t_eval, 2),
        epochs_s=round(sum(r.get("epoch_seconds", 0.0) for r in rows), 2),
        train_setup=stage_times(
            train_log, r"setup timing: data ([\d.]+)s, samplers ([\d.]+)s",
            ("data", "samplers")),
        eval_stages=stage_times(
            eval_log, r"stage timing: data\+sampler ([\d.]+)s, checkpoint "
            r"([\d.]+)s, encode ([\d.]+)s, rank ([\d.]+)s",
            ("data", "checkpoint", "encode", "rank")),
        train_memory=memory_of(train_log), eval_memory=memory_of(eval_log),
        tool_rss_kib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
        ckpt_bytes=best.stat().st_size,
        h100_30k=(table_metrics(H100_RUN.read_text())
                  if H100_RUN.exists() and out.resolve() != H100_RUN
                  else {}))
    text = report(args, cuts, card_line(args.device), t_data, t_train,
                  t_eval, rows, model, tpu, parent, train_log, info)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(f"report written to {out}")
    return {"metrics": model, "epochs": rows, "train_s": t_train,
            "bars_met": all(meets(m, model.get(m)) for m in QUALITY),
            "simple_parent": parent, "stages": info}


if __name__ == "__main__":
    main()
