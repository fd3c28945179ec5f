"""Fixtures of the benchmark's own tests (run them from the checkout's
root: `python -m pytest benchmark/tests -q`; the card tests with
`-m cuda` on the machine with the GPU)."""
from __future__ import annotations

import copy

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from taxoexpan_torch.device import resolve_device
    return resolve_device("cuda")


def shrink(cell, nodes: int = 400, widths: bool = True):
    """A copy of `cell` at a size a test holds: a small taxonomy, short
    rounds and sections, and (with `widths`) tiny layer widths."""
    cfg = copy.deepcopy(cell.config)
    if widths:
        cfg["arch"]["args"].update(in_dim=16, hidden_dim=8, out_dim=8,
                                   pos_dim=4)
        for k in ("train_data_loader", "test_data_loader"):
            cfg[k]["args"].update(batch_size=8, negative_size=3,
                                  expand_factor=12)
    tr = copy.deepcopy(cell.traffic)
    tr["data"] = {"num_nodes": nodes, "max_children": 6, "noise": 1.0}
    if tr["driver"] == "train":
        tr.update(section_start=2, section_steps=2, warmup_steps=1)
    else:
        tr.update(encode_chunk=64, reference_block=50, section_start=1,
                  section_requests=1,
                  sizes={"low": 4, "high": 32, "round": 4})
        if tr.get("rate_per_s"):
            tr["rate_per_s"] = 100.0
    out = copy.copy(cell)
    out.config, out.traffic = cfg, tr
    return out


@pytest.fixture
def tiny():
    from benchmark import spec

    def make(name: str, **kw):
        return shrink(spec.resolve(name), **kw)
    return make
