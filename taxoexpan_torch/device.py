"""Device resolution: CUDA by default, the CPU only when asked for.

There is no fallback: asking for CUDA on a machine without a usable CUDA
device raises instead of quietly running on the CPU.
"""
from __future__ import annotations

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
