"""The port stands alone: no module of `taxoexpan_torch` and not
`chip_smoke.py` imports JAX, jaxlib, optax or the JAX package, and every
entry point refuses to run on CUDA where there is none instead of falling
back to the CPU."""
import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "optax", "taxoexpan_tpu"}


def _port_files():
    return sorted((REPO / "taxoexpan_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


# the host data path, the dataset entry points and the baselines: the
# ctypes binding keeps its own copy of the C++ sampler and imports nothing
# of taxoexpan_tpu.native, although that module imports no JAX
HOST_MODULES = ("native/__init__.py", "data/split_loader.py",
                "generate_dataset_binary.py",
                "tools/make_synthetic_dataset.py", "tools/preprocess_mag.py",
                "tools/preprocess_semeval.py", "tools/sampler_bench.py",
                "baselines/simple_structure.py", "baselines/simple_mlp.py",
                "baselines/xgb_features.py")


def test_no_jax_imports():
    offenders = []
    files = _port_files()
    assert len(files) > 20
    for name in HOST_MODULES:
        assert REPO / "taxoexpan_torch" / name in files, name
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in FORBIDDEN]
    assert not offenders, offenders


def test_cuda_default_raises_without_cuda(monkeypatch):
    from taxoexpan_torch.device import resolve_device
    from taxoexpan_torch.test_fast import parse_args
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert parse_args(["-r", "x.ckpt"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
