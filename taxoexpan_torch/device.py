"""Device resolution: CUDA by default, the CPU only when asked for.

There is no fallback: asking for CUDA on a machine without a usable CUDA
device raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import resource

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        # full float32 matmuls on the card: the ranker's prefilter and the
        # plain-path references are compared at f32 tolerances
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def memory_peaks(device: torch.device) -> str:
    """The process's peak memory so far, as the CLIs log it: the device's
    peak allocation (`torch.cuda.max_memory_allocated`; 0 on the CPU) and
    the host's maximum resident set size (getrusage, KiB on Linux)."""
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return f"peak device memory {peak} bytes, host max RSS {rss} KiB"
