#!/usr/bin/env python3
"""The JAX package's trainer and the PyTorch port's run side by side on the
CPU, epoch by epoch, from the same data, the same initial parameters and
the same recipe; a Markdown report of where their epoch loops agree and
where they part.

    python3 scripts/torch_jax_epochs.py
    python3 scripts/torch_jax_epochs.py --nodes 600 --dim 16 --hidden 16 \
        --epochs 3 --out /tmp/LOCKSTEP.md          # a quick rehearsal

The setup is a cut of the weak-signal point of the difficulty curve
(`taxoexpan_torch/tools/difficulty_curve.py`, `scripts/difficulty_curve.py`):
a v2 synthetic taxonomy made by each package's own generator (noise 1.5,
seed 42, max_children 40; `--nodes`, `--dim` cut it), configs/
config.mag.json with the CR readout, the raw-feature channel, hidden and
out width `--hidden`, float32, every dropout at 0, the Python loader
backend on both sides, full-catalog validation every epoch and a short
schedule (`--epochs`, `--early-stop`, `--patience`) in which the plateau
scheduler and early stop both act. Both runs resume from one checkpoint of
the JAX model's initial parameters and optimizer state (epoch 0), which
the port reads through `taxoexpan_torch/weights.py`.

Each package trains through its own `train.main` (`train.py`,
`taxoexpan_torch/train.py`). The script wraps the two trainers'
`_train_epoch` and `_save_checkpoint` to record, per epoch: the mean
train loss, the lr after the scheduler step, val_macro_mr, the loop's
not_improved_count (read from the loop's frame when it checkpoints),
whether model_best was written, and a copy of the parameters, which are
then compared leaf by leaf (largest |port - jax| / largest |jax| over a
leaf, the largest over the leaves). At the end each package's own
`test_fast.main` evaluates its model_best on the test split, plainly and
with `--prior-select` on the validation grid.

With `--bf16-products`, the port runs a second time with the operands of
the matcher's and the raw channel's products rounded to bf16 (a patch of
`taxoexpan_torch.models` inside this process only): the precision at
which a TPU computes float32 dots by default. Its rows are reported beside
the float32 runs.

Runs on the CPU only (JAX_PLATFORMS=cpu, torch on the CPU); the data,
checkpoints and logs go to `--work` (default `_scale_run/lockstep/`,
listed in .gitignore).
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

METRICS = ("macro_mr", "hit_at_1", "hit_at_3", "mrr_scaled_10")
PRIOR_GRID = "0,0.25,0.5,1,2,4,8,16,32,64,256"
LOADERS = ("train_data_loader", "validation_data_loader", "test_data_loader")
EPOCH1_RTOL = 1e-4     # losses and metrics at epoch 1: float32 noise
LR0 = 1e-3             # config.mag.json's AMSGrad lr


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=3000)
    ap.add_argument("--dim", type=int, default=250)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--noise", type=float, default=1.5)
    ap.add_argument("--max_children", type=int, default=40)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--readout", default="CR")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--early-stop", dest="early_stop", type=int, default=5)
    ap.add_argument("--patience", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4,
                    help="torch intra-op threads (JAX: XLA's CPU default)")
    ap.add_argument("--bf16-products", dest="bf16_products",
                    action="store_true",
                    help="also run the port with the matcher's and the raw "
                         "channel's product operands rounded to bf16")
    ap.add_argument("--work", default=str(REPO / "_scale_run" / "lockstep"))
    ap.add_argument("--out", default=str(REPO / "artifacts" /
                                         "EPOCH_LOCKSTEP_CPU.md"))
    args = ap.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


# ----------------------------------------------------------------- set-up

def make_data(args, work: Path) -> tuple[Path, Path, dict]:
    """Each package's v2 taxonomy from the same arguments, saved apart;
    returns the two paths and how far their arrays agree."""
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy_v2 as tgen
    from taxoexpan_tpu.data.synthetic import synthetic_taxonomy_v2 as jgen
    kw = dict(num_nodes=args.nodes, dim=args.dim,
              max_children=args.max_children, noise=args.noise,
              seed=args.seed)
    paths = (work / "jax.pickle.bin", work / "torch.pickle.bin")
    taxos = (jgen(**kw), tgen(**kw))
    for taxo, path in zip(taxos, paths):
        taxo.save(str(path))
    jt, tt = taxos
    same = {
        "features": bool(np.array_equal(jt.features, tt.features)),
        "edges": bool(np.array_equal(jt.edges, tt.edges)),
        "splits": all(list(getattr(jt, k)) == list(getattr(tt, k))
                      for k in ("train_node_ids", "validation_node_ids",
                                "test_node_ids")),
    }
    return paths[0], paths[1], same


def make_config(args, data: Path, save_dir: Path, name: str) -> dict:
    cfg = json.loads((REPO / "configs" / "config.mag.json").read_text())
    for loader in LOADERS:
        cfg[loader]["args"].update(data_path=str(data), num_workers=2,
                                   backend="python")
    a = cfg["arch"]["args"]
    a.update(in_dim=args.dim, hidden_dim=args.hidden, out_dim=args.hidden,
             pos_dim=max(args.hidden // 8, 8), readout_method=args.readout,
             raw_channel=True, feat_drop=0.0, attn_drop=0.0,
             hidden_drop=0.0, out_drop=0.0)
    cfg["name"] = name
    cfg["trainer"].update(epochs=args.epochs, save_dir=str(save_dir),
                          full_validation_every=1, tensorboardX=False,
                          early_stop=args.early_stop)
    cfg["lr_scheduler"]["args"]["patience"] = args.patience
    return cfg


@contextlib.contextmanager
def argv_as(argv: list[str]):
    """sys.argv for the JAX package's ConfigParser, which parses it."""
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        yield
    finally:
        sys.argv = saved


def jax_parser(train: bool) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None, type=str)
    ap.add_argument("-r", "--resume", default=None, type=str)
    ap.add_argument("-d", "--device", default=None, type=str)
    ap.add_argument("-s", "--suffix", default="", type=str)
    if not train:
        for flag, default, typ in (("--test_data", "", str),
                                   ("--topk", -1, int),
                                   ("--batch_size", -1, int),
                                   ("--case", "", str),
                                   ("--prior-select", "", str),
                                   ("--prior-metric", "combined_metrics",
                                    str)):
            ap.add_argument(flag, default=default, type=typ)
        ap.add_argument("--prior-lambda", dest="prior_lambda", default=None,
                        type=float)
        ap.add_argument("-m", "--mesh", action="store_true")
    for flag in ("--coordinator", "--num_processes", "--process_id"):
        ap.add_argument(flag, default=None,
                        type=str if flag == "--coordinator" else int)
    return ap


def start_checkpoint(cfg: dict, path: Path) -> None:
    """Epoch 0 of the JAX model: its initial parameters (train.py's
    PRNGKey(seed) init) and optimizer state."""
    import jax
    from taxoexpan_tpu import builders as jb
    from taxoexpan_tpu.train import checkpoint as jckpt
    taxo = jb.build_taxonomy(cfg["train_data_loader"]["args"]["data_path"])
    sampler = jb.build_sampler(taxo, cfg["train_data_loader"]["args"],
                               "train")
    model = jb.build_model(cfg["arch"], max_parents=sampler.max_parents,
                           expand_factor=sampler.expand_factor)
    params = model.init(jax.random.PRNGKey(cfg.get("seed", 0)))
    opt = jb.build_optimizer_from_config(cfg["optimizer"], cfg["trainer"])
    jckpt.save_checkpoint(path, params=params, opt_state=opt.init(params),
                          epoch=0, monitor_best=float("inf"), config=cfg)


# --------------------------------------------------------------- recording

class Record:
    """What one run's epoch loop did, epoch by epoch."""

    def __init__(self):
        self.epochs: dict[int, dict] = {}

    def row(self, epoch: int) -> dict:
        return self.epochs.setdefault(epoch, {"epoch": epoch})


@contextlib.contextmanager
def recording(cls, rec: Record, snapshot):
    """Wrap cls._train_epoch and cls._save_checkpoint for the run."""
    orig_epoch, orig_save = cls._train_epoch, cls._save_checkpoint

    def _train_epoch(self, epoch):
        log = orig_epoch(self, epoch)
        vals = log.get("val_metrics")
        rec.row(epoch).update(
            loss=float(log["loss"]), lr=float(log["lr"]),
            val_macro_mr=None if vals is None else float(vals[0]),
            params=snapshot(self.params))
        return log

    def _save_checkpoint(self, epoch, save_best=False):
        loop = sys._getframe(1).f_locals
        rec.row(epoch).update(best=bool(save_best),
                              not_improved=loop.get("not_improved_count"))
        return orig_save(self, epoch, save_best=save_best)

    cls._train_epoch, cls._save_checkpoint = _train_epoch, _save_checkpoint
    try:
        yield
    finally:
        cls._train_epoch, cls._save_checkpoint = orig_epoch, orig_save


@contextlib.contextmanager
def prior_choice(ranker_cls, out: dict):
    """Record the blend weight select_prior_lambda chose."""
    orig = ranker_cls.select_prior_lambda

    def select(self, *a, **kw):
        lam, curve = orig(self, *a, **kw)
        out["lam"] = float(lam)
        return lam, curve

    ranker_cls.select_prior_lambda = select
    try:
        yield
    finally:
        ranker_cls.select_prior_lambda = orig


def run_dir(save_dir: Path, name: str) -> Path:
    return sorted((save_dir / "models" / name).iterdir())[-1]


def train_jax(cfg_path: Path, ckpt: Path, save_dir: Path, name: str,
              rec: Record) -> tuple[Path, float]:
    import jax
    import train as jtrain
    from taxoexpan_tpu.config import ConfigParser
    from taxoexpan_tpu.train import Trainer
    jtrain.enable_compile_cache = lambda *a, **k: None  # no cache on disk
    with argv_as(["-c", str(cfg_path), "-r", str(ckpt), "-d", "cpu"]):
        config = ConfigParser(jax_parser(True))
    snap = lambda p: jax.device_get(p)  # noqa: E731
    t0 = time.time()
    with recording(Trainer, rec, snap):
        jtrain.main(config)
    return run_dir(save_dir, name), time.time() - t0


def train_torch(cfg_path: Path, ckpt: Path, save_dir: Path, name: str,
                rec: Record) -> tuple[Path, float]:
    from taxoexpan_torch import train as ttrain
    from taxoexpan_torch.training.trainer import Trainer
    from taxoexpan_torch.weights import to_numpy
    config = ttrain.parse_args(["-c", str(cfg_path), "-r", str(ckpt),
                                "-d", "cpu"])
    t0 = time.time()
    with recording(Trainer, rec, to_numpy):
        ttrain.main(config)
    return run_dir(save_dir, name), time.time() - t0


def test_jax(best: Path, prior: bool) -> dict:
    import test_fast as jtf
    from taxoexpan_tpu.config import ConfigParser
    from taxoexpan_tpu.evaluation.ranker import TaxonomyRanker
    jtf.enable_compile_cache = lambda *a, **k: None
    argv = ["-r", str(best), "-d", "cpu"] + (
        ["--prior-select", PRIOR_GRID] if prior else [])
    parser = jax_parser(False)
    with argv_as(argv):
        outer = parser.parse_args()
        config = ConfigParser(parser)
    chosen: dict = {}
    with prior_choice(TaxonomyRanker, chosen):
        res = jtf.main(config, outer)
    return dict({m: float(res[m]) for m in METRICS}, **chosen)


def test_torch(best: Path, prior: bool) -> dict:
    from taxoexpan_torch import test_fast as ttf
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    argv = ["-r", str(best), "-d", "cpu"] + (
        ["--prior-select", PRIOR_GRID] if prior else [])
    chosen: dict = {}
    with prior_choice(TaxonomyRanker, chosen):
        res = ttf.main(ttf.parse_args(argv))
    return dict({m: float(res[m]) for m in METRICS}, **chosen)


# --------------------------------------------------------- bf16 products

@contextlib.contextmanager
def bf16_products():
    """The port's matcher, readout and raw-channel products on operands
    rounded to bf16 (float32 accumulation), as a TPU's default dot precision
    computes float32 dots. Patches torch.matmul / einsum inside those model
    modules only, for this process (the ranker's score product keeps its
    float32 operands, as the JAX ranker asks for HIGHEST there)."""
    import torch
    from taxoexpan_torch.models import matching, readout, taxoexpan

    def r(t):
        return t.to(torch.bfloat16).to(t.dtype) \
            if t.dtype == torch.float32 else t

    class Rounded:
        """The torch namespace with matmul and einsum on rounded operands."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def matmul(a, b, **kw):
            return torch.matmul(r(a), r(b), **kw)

        @staticmethod
        def einsum(eq, *ops, **kw):
            return torch.einsum(eq, *map(r, ops), **kw)

    mods = (matching, readout, taxoexpan)
    saved = [m.torch for m in mods]
    for m in mods:
        m.torch = Rounded()
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.torch = t


# ------------------------------------------------------------------ report

def rel(a, b) -> float:
    if a is None or b is None:
        return float("nan")
    return abs(a - b) / max(abs(a), 1e-30)


def param_rel(pj, pt) -> float:
    from taxoexpan_torch.tree import tree_leaves_with_path
    tl = dict(tree_leaves_with_path(pt))
    worst = 0.0
    for path, a in tree_leaves_with_path(pj):
        a = np.asarray(a, np.float64)
        b = np.asarray(tl[path], np.float64)
        worst = max(worst, float(np.abs(a - b).max())
                    / max(float(np.abs(a).max()), 1e-30))
    return worst


def decisions(rec: Record, lr0: float) -> dict:
    """The loop's decisions: the epochs after whose scheduler step the lr
    is lower than before (lr0 before epoch 1), the epochs that wrote
    model_best, the last epoch run and whether early stop ended it."""
    rows = [rec.epochs[e] for e in sorted(rec.epochs)]
    before = [lr0] + [r["lr"] for r in rows[:-1]]
    cuts = [r["epoch"] for lr, r in zip(before, rows) if r["lr"] < lr]
    best = [r["epoch"] for r in rows if r.get("best")]
    return {"lr_cuts": cuts, "best_epochs": best,
            "best_epoch": best[-1] if best else None,
            "stop_epoch": rows[-1]["epoch"] if rows else None,
            "stopped_early": bool(rows) and "best" not in rows[-1]}


def fmt(v, digits=6) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def report(args, same, jrec, trec, tests, secs, extra) -> tuple[str, dict]:
    epochs = sorted(set(jrec.epochs) | set(trec.epochs))
    lines = [
        "# Epoch loops side by side: the JAX package's trainer and the "
        "port's, on the CPU", "",
        "Generated by `python3 scripts/torch_jax_epochs.py"
        + "".join(" " + a for a in args.argv) + "` (CPU only: "
        "JAX_PLATFORMS=cpu, torch on the CPU).", "",
        f"- data: v2 synthetic taxonomy, {args.nodes} nodes, dim {args.dim},"
        f" max_children {args.max_children}, noise {args.noise}, seed "
        f"{args.seed}, made by each package's own generator; arrays equal: "
        + ", ".join(f"{k} {fmt(v)}" for k, v in same.items()),
        f"- model: configs/config.mag.json, readout {args.readout}, raw "
        f"channel, hidden and out {args.hidden}, pos "
        f"{max(args.hidden // 8, 8)}, float32, every dropout 0",
        f"- schedule: {args.epochs} epochs, early stop {args.early_stop}, "
        f"plateau patience {args.patience} (factor 0.5), full-catalog "
        "validation every epoch, AMSGrad lr 1e-3, the Python loader "
        "backend on both sides",
        "- start: one checkpoint (epoch 0) of the JAX model's initial "
        "parameters and optimizer state; the port reads it through "
        "taxoexpan_torch/weights.py",
        f"- wall seconds: JAX {secs['jax']:.1f}, port {secs['torch']:.1f}",
        "", "## Tolerances", "",
        f"- loss and val_macro_mr at epoch 1: relative {EPOCH1_RTOL:g} "
        "(float32 noise); from epoch 2 on the drift is reported, not held",
        "- decisions exactly: the epochs at which the lr is cut, the epochs "
        "that write model_best (so the best epoch), not_improved_count, and "
        "the epoch at which training stops",
        "- params: largest |port - jax| / largest |jax| over a leaf, the "
        "largest over the leaves (reported, not held: AMSGrad divides each "
        "step by the root of its running squared grads, so float32 "
        "rounding of an element's near-zero grad can flip a step of up to "
        "the lr; losses, metrics and decisions are what is held)",
        "", "## Per epoch", "",
        "| epoch | loss JAX | loss port | rel | lr JAX | lr port | "
        "val_macro_mr JAX | val_macro_mr port | rel | not_improved J / P "
        "| model_best J / P | params rel |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for e in epochs:
        j, t = jrec.epochs.get(e, {}), trec.epochs.get(e, {})
        prel = param_rel(j["params"], t["params"]) \
            if "params" in j and "params" in t else None
        lines.append(
            f"| {e} | {fmt(j.get('loss'), 8)} | {fmt(t.get('loss'), 8)} | "
            f"{rel(j.get('loss'), t.get('loss')):.2e} | {fmt(j.get('lr'))} | "
            f"{fmt(t.get('lr'))} | {fmt(j.get('val_macro_mr'), 8)} | "
            f"{fmt(t.get('val_macro_mr'), 8)} | "
            f"{rel(j.get('val_macro_mr'), t.get('val_macro_mr')):.2e} | "
            f"{fmt(j.get('not_improved'))} / {fmt(t.get('not_improved'))} | "
            f"{fmt(j.get('best'))} / {fmt(t.get('best'))} | "
            f"{'—' if prel is None else f'{prel:.2e}'} |")
    lr0 = LR0
    dj, dt = decisions(jrec, lr0), decisions(trec, lr0)
    lines += ["", "A dash in the not_improved / model_best cells: no checkpoint "
              "was written that epoch (the loop broke for early stop "
              "before it).", "", "## Decisions", "",
              "| | JAX | port |", "|---|---|---|"]
    for k in dj:
        lines.append(f"| {k} | {fmt(dj[k])} | {fmt(dt[k])} |")
    e1j, e1t = jrec.epochs.get(1, {}), trec.epochs.get(1, {})
    checks = {
        "epoch 1 loss within 1e-4": rel(e1j.get("loss"), e1t.get("loss"))
        <= EPOCH1_RTOL,
        "epoch 1 val_macro_mr within 1e-4":
            rel(e1j.get("val_macro_mr"), e1t.get("val_macro_mr"))
            <= EPOCH1_RTOL,
        "decisions equal": dj == dt,
        "not_improved_count equal every epoch": all(
            jrec.epochs.get(e, {}).get("not_improved")
            == trec.epochs.get(e, {}).get("not_improved") for e in epochs),
    }
    parted = None
    for e in epochs:
        j, t = jrec.epochs.get(e), trec.epochs.get(e)
        if j is None or t is None or any(
                j.get(k) != t.get(k) for k in ("lr", "best",
                                                "not_improved")):
            parted = e
            break
    agree = all(checks.values())
    lines += ["", "## Checks", ""]
    lines += [f"- {k}: {'pass' if v else 'FAIL'}" for k, v in checks.items()]
    lines += ["", "**Verdict:** " + (
        "the two epoch loops agree within the tolerances above."
        if agree else "the two epoch loops part"
        + (f" at epoch {parted} (the first whose lr, model_best or "
           "not_improved_count differ)." if parted else
           " on a tolerance above (see Checks)."))]
    lines += ["", "## Test metrics of each model_best (each package's own "
              "test_fast)", "",
              "| run | macro_mr | hit_at_1 | hit_at_3 | mrr_scaled_10 | "
              "prior λ |", "|---|---|---|---|---|---|"]
    for label, row in tests.items():
        lines.append(f"| {label} | " + " | ".join(
            fmt(row.get(m), 6) for m in METRICS)
            + f" | {fmt(row.get('lam'))} |")
    if extra:
        lines += ["", "## The port with bf16 products (matcher and raw "
                  "channel operands rounded to bf16)", "",
                  "| epoch | loss | lr | val_macro_mr | model_best |",
                  "|---|---|---|---|---|"]
        for e in sorted(extra.epochs):
            r = extra.epochs[e]
            lines.append(f"| {e} | {fmt(r.get('loss'), 8)} | "
                         f"{fmt(r.get('lr'))} | "
                         f"{fmt(r.get('val_macro_mr'), 8)} | "
                         f"{fmt(r.get('best'))} |")
        lines.append("")
        lines.append("Decisions: " + json.dumps(decisions(extra, lr0)))
    raw = {"checks": checks, "agree": agree, "parted": parted,
           "decisions": {"jax": dj, "torch": dt}, "tests": tests}
    lines += ["", "## Raw", "", "```", json.dumps(raw, default=str), "```",
              ""]
    return "\n".join(lines), raw


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch
    torch.set_num_threads(args.threads)
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    jdata, tdata, same = make_data(args, work)
    cfg_paths, cfgs = {}, {}
    for pkg, data in (("jax", jdata), ("torch", tdata)):
        cfgs[pkg] = make_config(args, data, work / pkg, f"lockstep-{pkg}")
        cfg_paths[pkg] = work / f"config-{pkg}.json"
        cfg_paths[pkg].write_text(json.dumps(cfgs[pkg], indent=1))
    ckpt = work / "epoch0.ckpt"
    start_checkpoint(cfgs["jax"], ckpt)

    # the JAX loaders on their Python backend (its build_loader takes no
    # backend key)
    import functools
    from taxoexpan_tpu import builders as jb
    from taxoexpan_tpu.data.loader import GroupBatchLoader
    jb.GroupBatchLoader = functools.partial(GroupBatchLoader,
                                            backend="python")

    jrec, trec = Record(), Record()
    jrun, jsec = train_jax(cfg_paths["jax"], ckpt, work / "jax",
                           "lockstep-jax", jrec)
    trun, tsec = train_torch(cfg_paths["torch"], ckpt, work / "torch",
                             "lockstep-torch", trec)
    tests = {
        "JAX, trained": test_jax(jrun / "model_best.ckpt", False),
        "port, trained": test_torch(trun / "model_best.ckpt", False),
        "JAX, blended (--prior-select)": test_jax(jrun / "model_best.ckpt",
                                                  True),
        "port, blended (--prior-select)":
            test_torch(trun / "model_best.ckpt", True),
    }
    extra = None
    if args.bf16_products:
        extra = Record()
        cfg = make_config(args, tdata, work / "torch-bf16",
                          "lockstep-torch-bf16")
        path = work / "config-torch-bf16.json"
        path.write_text(json.dumps(cfg, indent=1))
        with bf16_products():
            brun, _ = train_torch(path, ckpt, work / "torch-bf16",
                                  "lockstep-torch-bf16", extra)
            tests["port, bf16 products, trained"] = test_torch(
                brun / "model_best.ckpt", False)
            tests["port, bf16 products, blended"] = test_torch(
                brun / "model_best.ckpt", True)
    text, raw = report(args, same, jrec, trec, tests,
                       {"jax": jsec, "torch": tsec}, extra)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(text)
    return raw


if __name__ == "__main__":
    main()
