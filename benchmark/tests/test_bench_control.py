"""The control on the card: the plain reference computed in the nearest
precision below the configuration's (TF32 for float32 with TF32 off), put
in the program's place, must fail one of the cell's numbers, while the
program passes them all. At the configuration's widths on a smaller
taxonomy than the cells' (a size a test run holds); the cells' own
readings are `python3 -m benchmark.calibrate readings` (PERF.md)."""
from __future__ import annotations

import copy

import pytest

from benchmark import calibrate, spec


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v["limit"] for k, v in limits["numbers"].items()
               if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name,nodes", [("pgat_mag.train", 3000),
                                        ("pgat_mag.serve_refresh", 20000),
                                        ("pgcn_mag.serve_refresh", 20000)])
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_fails_and_program_passes(card, name, nodes, seed):
    cell = spec.resolve(name)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["data"]["num_nodes"] = nodes
    fn = calibrate.train_readings if cell.traffic["driver"] == "train" \
        else calibrate.serve_readings
    out = fn(cell, seed, card, True)
    assert not _fails(out["program"], cell.limits), out
    assert _fails(out["control_tf32"], cell.limits), out
