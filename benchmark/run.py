"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It sets up (data generated from the seed, the program built, its kernels
loaded, every shape of the cell warmed), measures for `--seconds`, checks
what the timed path produced against the plain reference
(`benchmark/reference/`), and prints the result as the last line of its
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones, read from a
profiled section of the window), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit (also the last
lines of standard error).

It exits with another code than 0 and prints no result when no CUDA device
is there, or fewer than the cell asks for, or when `jax`, `jaxlib`, `flax`
or `taxoexpan_tpu` is loaded in this process once the window has closed
(compared by whole top-level module names: the port's name starts with the
JAX package's).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(CHECKOUT / ".bench_cache" / _sub)

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "taxoexpan_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules (the part of
    each module's name before the first dot, compared whole)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START) -> dict:
    """Set-up, window and check of one cell on `device`: the result
    object (without printing it)."""
    import torch

    from . import check, spec, tracing

    spans = tracing.Spans()
    seen = {}

    def on_window_end(rec):
        seen["peak"] = (torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else 0)
        seen["forbidden"] = forbidden_modules()

    drv = spec.driver(cell.traffic["driver"])
    rec, numbers = drv.run(cell, seed, seconds, trace, device, spans,
                           on_window_end)
    rec["setup_s"] = rec["t0"] - t_start
    rec["spans"] = {k: [b - a for a, b in v]
                    for k, v in spans.intervals.items()}
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ok, checks = check.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(seen["peak"])}
    result = {"correct": bool(ok and rec["failed"] == 0),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": dev}
    if trace and "idle_summary" in rec:
        # the device's busy time from the device-only section, the
        # breakdown from the host and device one
        s = rec["idle_summary"]
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        result["breakdown"] = rec["breakdown"]
    note = getattr(drv, "window_note", None)
    if note is not None:
        result["window_note"] = note(rec)
    result["forbidden_modules"] = seen["forbidden"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import check, spec
    cell = spec.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from taxoexpan_torch.device import resolve_device
    from taxoexpan_torch.ops import cuda_build
    device = resolve_device("cuda")
    cuda_build.build_all()      # every library at once on a first run
    if args.trace:
        from .tracing import warm_profiler
        warm_profiler(device)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = sorted(set(result.pop("forbidden_modules")) |
                 set(forbidden_modules()))
    note = result.pop("window_note", None)
    if bad:
        print(f"benchmark: forbidden modules loaded after the window: "
              f"{bad}", file=sys.stderr)
        return 3
    if note:
        print(note, file=sys.stderr)
    check.print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
