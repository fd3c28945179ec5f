"""The numbers that decide `correct`, and their limits.

Each number compares what the timed path produced with the plain
reference (`benchmark/reference/`); its limit lives in
`benchmark/limits/<config>.<driver>.json` beside the two readings it was
set from (the largest that sound runs of the program gave, the smallest
that the control or a planted fault gave). A number at or under its limit
passes; a missing or non-finite one fails.
"""
from __future__ import annotations

import math
import sys

import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap between two lists of losses."""
    if len(prog) != len(ref):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def norm_gaps(prog: dict, ref: dict) -> dict:
    """By leaf, the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    norms = {k: _norm(v) for k, v in ref.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {k: abs(_norm(prog[k]) - norms[k]) / max(norms[k], median, 1e-30)
            for k in ref}


def median_norm_gap(prog: dict, ref: dict) -> float:
    """`norm_gaps` of the median leaf."""
    if set(prog) != set(ref) or not ref:
        return math.inf
    gaps = sorted(norm_gaps(prog, ref).values())
    return gaps[len(gaps) // 2]


def moving_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's; the rest (a gradient that is nought to rounding) move
    under Adam by round-off alone and are left out of the change."""
    norms = {k: _norm(v) for k, v in ref_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """By the worst row, the norm of the difference over the reference
    row's norm or the median row's, whichever is larger."""
    if prog.shape != ref.shape:
        return math.inf
    rn = torch.linalg.vector_norm(ref.double(), dim=1)
    dn = torch.linalg.vector_norm((prog.double() - ref.double()), dim=1)
    floor = float(rn.median())
    return float((dn / rn.clamp(min=max(floor, 1e-30))).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limit of the file."""
    out, ok = {}, True
    for name, spec in limits["numbers"].items():
        v = numbers.get(name)
        lim = spec["limit"]
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        out[name] = {"value": v if v is None or math.isfinite(v) else
                     str(v), "limit": lim}
    return ok, out


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=stream)
