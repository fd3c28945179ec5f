"""Noise-difficulty curve of the port: the trained PGAT, its structure-prior
blend and the non-learned baselines on the v2 synthetic benchmark, the
torch counterpart of `scripts/difficulty_curve.py` (which produced
artifacts/DIFFICULTY_CURVE.md).

    python -m taxoexpan_torch.tools.difficulty_curve
    python -m taxoexpan_torch.tools.difficulty_curve --noises 1.5 2.0 \
        --out /tmp/CURVE.md

For each noise point:
1. data: `python -m taxoexpan_torch.tools.make_synthetic_dataset --v2`
   (30000 nodes, dim 250, max_children 40, seed 42 by default), in the work
   directory;
2. training: configs/config.mag.json (read, not edited) with its data and
   save paths pointed at the work directory, the given readout (CR by
   default), the raw-feature channel, compute_dtype "bfloat16" on a card,
   full-catalog validation every epoch, the epochs, early stop and plateau
   patience given (by default the weak-signal schedule of the artifact: 150
   epochs, early stop 25, patience 8), through `python -m
   taxoexpan_torch.train`;
3. evaluation of the best checkpoint through `python -m
   taxoexpan_torch.test_fast`, and with the raw channel a second time with
   `--prior-select` (the blend weight chosen on the validation split);
4. the baselines on the same data: the best value per metric over the
   12-configuration `baselines.simple_structure` sweep (agg x beta) and
   `baselines.simple_parent`.

The Markdown report (default artifacts/DIFFICULTY_CURVE_H100.md) holds the
card's name and power limit, the rows of each point beside the TPU rows of
artifacts/DIFFICULTY_CURVE.md at the same noise, and the raw rows as JSON.
Runs on the card unless `-d cpu`; `--nodes`, `--dim` and `--hidden` cut a
rehearsal, and the report lists every cut. Data, checkpoints and logs stay
in the work directory (default `_scale_run/difficulty_curve/`, listed in
.gitignore).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

from ..reference_scale_run import card_line, epoch_split, metrics_of, run

REPO = Path(__file__).resolve().parents[2]
CONFIG = REPO / "configs" / "config.mag.json"
TPU_CURVE = REPO / "artifacts" / "DIFFICULTY_CURVE.md"
METRICS = ("macro_mr", "hit_at_1", "hit_at_3", "mrr_scaled_10")
PRIOR_GRID = "0,0.25,0.5,1,2,4,8,16,32,64,256"
STRUCT_SWEEP = [(agg, beta) for agg in ("sum", "mean", "min", "max")
                for beta in (0.0, 0.25, 1.0)]
LOADERS = ("train_data_loader", "validation_data_loader", "test_data_loader")
ROWS = (("trained", "model"), ("blended", "model_prior"),
        ("structure* (sweep best)", "structure"),
        ("simple_parent", "parent"))


def better(metric: str, a: float, b: float) -> bool:
    return a < b if metric == "macro_mr" else a > b


def structure_best(taxonomy) -> tuple[dict, dict]:
    """The best value of each metric over the simple_structure sweep, and
    the configuration that gave it."""
    from ..baselines import simple_structure
    best, cfg = {}, {}
    for agg, beta in STRUCT_SWEEP:
        res = simple_structure.evaluate(taxonomy, agg=agg, beta=beta)
        for m in METRICS:
            if m not in best or better(m, float(res[m]), best[m]):
                best[m], cfg[m] = float(res[m]), f"{agg}/b{beta}"
    return best, cfg


def prior_lambda(text: str) -> float | None:
    """The blend weight test_fast's --prior-select chose ("-> lam=X"), or
    None when its log has none."""
    found = re.findall(r"lam=([-\d.eE+]+|inf|nan)", text)
    return float(found[-1]) if found else None


def tpu_rows() -> dict:
    """The TPU run's raw rows (the JSON lines of artifacts/
    DIFFICULTY_CURVE.md), by noise."""
    if not TPU_CURVE.exists():
        return {}
    rows = {}
    for line in TPU_CURVE.read_text().splitlines():
        if line.startswith('{"noise"'):
            row = json.loads(line)
            rows[float(row["noise"])] = row
    return rows


def train_config(args, data: Path, work: Path, noise: float) -> dict:
    cfg = json.loads(CONFIG.read_text())
    for loader in LOADERS:
        cfg[loader]["args"].update(data_path=str(data), num_workers=2)
    a = cfg["arch"]["args"]
    a["in_dim"] = args.dim
    if args.hidden:
        a.update(hidden_dim=args.hidden, out_dim=args.hidden,
                 pos_dim=max(args.hidden // 8, 8))
    a["readout_method"] = args.readout
    if args.raw_channel:
        a["raw_channel"] = True
    if args.device != "cpu":
        a["compute_dtype"] = "bfloat16"
    cfg["name"] = f"curve-n{noise}"
    cfg["trainer"].update(epochs=args.epochs, save_dir=str(work / "saved"),
                          full_validation_every=1, tensorboardX=False,
                          early_stop=args.early_stop)
    if args.patience:
        cfg["lr_scheduler"]["args"]["patience"] = args.patience
    return cfg


def run_point(args, noise: float, work: Path) -> dict:
    """Data, training, evaluation and baselines of one noise point."""
    from ..data.taxonomy import Taxonomy
    from ..baselines import simple_parent
    py = sys.executable
    tag = str(noise).replace(".", "p")
    point = work / f"n{tag}"
    point.mkdir(parents=True, exist_ok=True)
    data = point / "curve.pickle.bin"
    t0 = time.time()
    run([py, "-m", "taxoexpan_torch.tools.make_synthetic_dataset", "--out",
         str(data), "--nodes", str(args.nodes), "--dim", str(args.dim),
         "--max_children", str(args.max_children), "--seed", str(args.seed),
         "--noise", str(noise), "--v2"], point / "data.log", timeout=3600)
    t_data = time.time() - t0
    cfg = train_config(args, data, point, noise)
    (point / "config.json").write_text(json.dumps(cfg, indent=1))
    dev = ["-d", args.device]
    train_log, t_train = run(
        [py, "-m", "taxoexpan_torch.train", "-c", str(point / "config.json"),
         *dev], point / "train.log", timeout=6 * 3600)
    runs = sorted((point / "saved" / "models" / cfg["name"]).iterdir())
    best = str(runs[-1] / "model_best.ckpt")
    eval_log, t_eval = run(
        [py, "-m", "taxoexpan_torch.test_fast", "-r", best, *dev],
        point / "test_fast.log", timeout=3600)
    row = {"noise": noise, "model": metrics_of(eval_log)}
    if args.raw_channel:
        blend_log, _ = run(
            [py, "-m", "taxoexpan_torch.test_fast", "-r", best,
             "--prior-select", PRIOR_GRID, *dev],
            point / "test_fast_prior.log", timeout=3600)
        row["model_prior"] = dict(metrics_of(blend_log),
                                  prior_lambda=prior_lambda(blend_log))
    taxonomy = Taxonomy.load(str(data))
    row["structure"], row["structure_cfg"] = structure_best(taxonomy)
    row["parent"] = {m: float(v) for m, v in
                     simple_parent.evaluate(taxonomy).items() if m in METRICS}
    epochs = epoch_split(train_log)
    row.update(train_s=round(t_train, 1), eval_s=round(t_eval, 1),
               data_s=round(t_data, 1), epochs_run=len(epochs),
               best_val_macro_mr=min((e["val_macro_mr"] for e in epochs
                                      if "val_macro_mr" in e), default=None),
               schedule={"epochs": args.epochs, "early_stop": args.early_stop,
                         "patience": args.patience or "config"},
               arch=("raw_channel, " if args.raw_channel else "")
               + f"readout {args.readout}, "
               + ("bf16" if args.device != "cpu" else "float32"))
    return row


def fmt(metric: str, value) -> str:
    if value is None:
        return "missing"
    return f"{value:.2f}" if metric == "macro_mr" else f"{value:.3f}"


def report(args, card: str, cuts: list[str], rows: list[dict],
           tpu: dict) -> str:
    lines = [
        "# Noise-difficulty curve of the port on the card (v2 synthetic "
        "benchmark)", "",
        "Generated by `"
        + " ".join(["python -m taxoexpan_torch.tools.difficulty_curve",
                    *args.argv]) + "`.", "",
        f"- card: {card}",
        f"- data: synthetic_taxonomy_v2, {args.nodes} nodes, dim "
        f"{args.dim}, max_children {args.max_children}, seed {args.seed} "
        "(`python -m taxoexpan_torch.tools.make_synthetic_dataset --v2`)",
        "- model: configs/config.mag.json"
        + (f" with hidden {args.hidden}" if args.hidden else "")
        + f", readout {args.readout}"
        + (", raw channel" if args.raw_channel else "")
        + (", compute_dtype bfloat16" if args.device != "cpu" else "")
        + f"; full-catalog validation every epoch, {args.epochs} epochs, "
        f"early stop {args.early_stop}, plateau patience "
        f"{args.patience or 'of the config'}"
        + ("; blended: the same checkpoint through `test_fast "
           f"--prior-select {PRIOR_GRID}` (the weight chosen on the "
           "validation split)" if args.raw_channel else ""),
        "- cuts: " + (", ".join(cuts) if cuts else "none (no widths or "
                      "nodes cut)"),
        "- `structure*`: the best value of each metric over the 12 "
        "simple_structure configurations (agg x beta); simple_parent: "
        "cosine retrieval",
        "- TPU rows: the raw rows of artifacts/DIFFICULTY_CURVE.md at the "
        "same noise (the JAX package on a TPU); their training time is not "
        "the port's", "",
        "| noise | row | run | " + " | ".join(METRICS) + " |",
        "|---|---|---|" + "---|" * len(METRICS)]
    for row in rows:
        ref = tpu.get(float(row["noise"]), {})
        for label, key in ROWS:
            for run_name, src in (("this run", row), ("TPU", ref)):
                if key not in src:
                    continue
                vals = src[key]
                label_k = label
                if key == "model_prior":
                    lam = vals.get("prior_lambda")
                    label_k = (f"blended (lam={lam:g} on validation)"
                               if lam is not None
                               else "blended (lam not logged)")
                lines.append(f"| {row['noise']} | {label_k} | {run_name} | "
                             + " | ".join(fmt(m, vals.get(m))
                                          for m in METRICS) + " |")
    lines += [""]
    for row in rows:
        ref = tpu.get(float(row["noise"]), {}).get("model_prior")
        mine = row.get("model_prior")
        if ref and mine:
            short = [m for m in METRICS
                     if mine.get(m) is None or better(m, ref[m], mine[m])]
            lines.append(
                f"At noise {row['noise']} the blended row "
                + ("matches or beats the TPU's blended row on every metric."
                   if not short else
                   "falls short of the TPU's blended row on "
                   + ", ".join(short) + "."))
        lines.append(
            f"Training at noise {row['noise']}: {row['train_s']} s wall "
            f"(`python -m taxoexpan_torch.train`, data loading and every "
            f"epoch's full-catalog validation included), "
            f"{row['epochs_run']} epochs run, best validation macro_mr "
            f"{row['best_val_macro_mr']}.")
    lines += ["", "Raw rows (JSON):", "", "```",
              *[json.dumps(r) for r in rows], "```", ""]
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noises", type=float, nargs="+", default=[1.5])
    ap.add_argument("--nodes", type=int, default=30000)
    ap.add_argument("--dim", type=int, default=250)
    ap.add_argument("--max_children", type=int, default=40)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--early_stop", type=int, default=25)
    ap.add_argument("--patience", type=int, default=8,
                    help="plateau patience (0: the config's)")
    ap.add_argument("--hidden", type=int, default=0,
                    help="hidden and out dim (0: the config's)")
    ap.add_argument("--readout", default="CR")
    ap.add_argument("--no_raw_channel", dest="raw_channel",
                    action="store_false")
    ap.add_argument("-d", "--device", default="cuda",
                    help="torch device (cuda | cuda:N | cpu)")
    ap.add_argument("--work", default=str(REPO / "_scale_run" /
                                          "difficulty_curve"))
    ap.add_argument("--out", default=str(REPO / "artifacts" /
                                         "DIFFICULTY_CURVE_H100.md"))
    args = ap.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    cuts = [f"{k} {getattr(args, k)}" for k, full in
            (("nodes", 30000), ("dim", 250)) if getattr(args, k) != full]
    if args.hidden:
        cuts.append(f"hidden {args.hidden}")
    work = Path(args.work).resolve()
    rows = []
    for noise in args.noises:
        rows.append(run_point(args, noise, work))
        print(json.dumps(rows[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report(args, card_line(args.device), cuts, rows,
                          tpu_rows()))
    print(f"report written to {out}")
    return rows


if __name__ == "__main__":
    main()
