"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each source under `ops/csrc/` becomes one library, built at first use into
`ops/_build/` (listed in .gitignore) and named by a hash of its source, the
shared headers (`csrc/*.cuh`) and the compiler flags, so an edited source or
header rebuilds and an unchanged one loads the existing file. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("gat_fwd", "gat_bwd", "gcn", "halo")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise FileNotFoundError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built on the machine with the GPU")


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for `name` unless its library is already built;
    returns (process or None, output path)."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every library not yet built, one nvcc per source, all started
    together. Returns {name: compiler output} ('' when already built);
    raises on a failed build with nvcc's output."""
    started = {name: _start(name) for name in names}
    logs = {}
    for name, (job, out) in started.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp = job
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)
        logs[name] = text
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed.
    `signatures` maps each C function to (argtypes, restype)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
