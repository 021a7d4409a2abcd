"""Device selection shared by the port's entry points.

Every entry point (`ServingEngine`, `ContinuousBatcher`,
`paged_generate`, `init_params`) runs on the card unless the caller asks
for the CPU, where the kernels' plain PyTorch versions run. Asking for
the card on a machine without one raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run its plain PyTorch "
            "versions on the CPU")
    return dev
