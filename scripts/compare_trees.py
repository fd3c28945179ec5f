#!/usr/bin/env python3
"""Run `chip_smoke.py` of several checkouts in turn on one card, and
summarise their numbers side by side.

    python3 scripts/compare_trees.py --out chiprun_out/compare \\
        _checkout/parent . . _checkout/parent

Each argument is a checkout (a directory holding chip_smoke.py and its
package); give them in the order to run, e.g. parent, change, change,
parent, so that drift of the card over the call shows in both. Each run's
standard output and error go to <out>/run<i>.out / .err. The summary
(<out>/summary.json, also printed) gives per run: the kernel entries'
device ms, passes_ms and launches (from the `{"kernels": [...]}` line and
the `"phase": "kernel"` lines), each training path's median step ms and,
where the checkout's chip_smoke.py reports it, the training run's peak
device memory (`max_memory_allocated_bytes`), each
serving path's encode seconds, and, for each group of kernel names given
by --sum, the sum over the group of launches x ms. Exits non-zero when a
run fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def parse(stdout: str) -> dict:
    """The numbers of one chip_smoke run from its JSON lines."""
    res = {"kernels": {}, "step_ms": {}, "peak_bytes": {}, "encode_s": {},
           "card": None}
    for line in stdout.splitlines():
        if not line.startswith("{"):
            if "," in line and res["card"] is None and "W" in line:
                res["card"] = line.strip()
            continue
        rec = json.loads(line)
        phase = rec.get("phase")
        if phase == "kernel":
            res["kernels"].setdefault(rec["name"], {}).update(
                ms=rec["ms"], plain_ms=rec["plain_ms"],
                # an older chip_smoke.py gave the float32 FMA rate's bound
                # as `bound_ms` and 3xTF32's as `bound_3xtf32_ms`
                bound_ms=rec.get("bound_3xtf32_ms", rec["bound_ms"]),
                bound_fma_ms=rec.get("bound_fma_ms",
                                     rec["bound_ms"] if "bound_3xtf32_ms"
                                     in rec else None),
                passes_ms=rec.get("passes_ms"))
        elif phase == "training" and "median_step_ms" in rec:
            res["step_ms"][rec["path"]] = rec["median_step_ms"]
            if "max_memory_allocated_bytes" in rec:
                res["peak_bytes"][rec["path"]] = \
                    rec["max_memory_allocated_bytes"]
        elif phase == "serving" and "encode_s" in rec:
            res["encode_s"][rec["path"]] = rec["encode_s"]
        elif "kernels" in rec:
            for k in rec["kernels"]:
                res["kernels"].setdefault(k["name"], {})["launches"] = \
                    k["launches"]
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts, in run order")
    ap.add_argument("--out", default="chiprun_out/compare")
    ap.add_argument("--sum", action="append", default=[],
                    help="NAME=prefix1,prefix2: sum launches x ms over the "
                         "kernel entries whose name starts with a prefix")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(args.trees):
        t0 = time.time()
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=tree, capture_output=True, text=True)
        (out / f"run{i}.out").write_text(proc.stdout)
        (out / f"run{i}.err").write_text(proc.stderr)
        run = {"tree": tree, "rc": proc.returncode,
               "wall_s": time.time() - t0, **parse(proc.stdout)}
        for group in args.sum:
            name, prefixes = group.split("=", 1)
            run.setdefault("sums", {})[name] = sum(
                k.get("launches", 0) * k.get("ms", 0.0)
                for kname, k in run["kernels"].items()
                if kname.startswith(tuple(prefixes.split(","))))
        runs.append(run)
        print(json.dumps({"run": i, "tree": tree, "rc": proc.returncode,
                          "wall_s": run["wall_s"]}), flush=True)
    (out / "summary.json").write_text(json.dumps(runs, indent=1))
    print(json.dumps(runs))
    return max(r["rc"] != 0 for r in runs)


if __name__ == "__main__":
    sys.exit(main())
