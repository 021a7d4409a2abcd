"""RMSNorm — plain PyTorch.

Port of paddle_tpu/kernels/rms_norm.py::rms_norm_ref, the form the
serving path uses (the Pallas RMSNorm kernels there serve nn.functional
and training, later slices).
"""
from __future__ import annotations

import torch


def rms_norm_ref(x, weight=None, epsilon: float = 1e-6):
    """Accumulates in f32 for bf16 inputs and casts back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(dt)
