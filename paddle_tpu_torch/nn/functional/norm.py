"""Normalization functionals — port of paddle_tpu/nn/functional/norm.py
(:28, :49): the plain layer_norm and rms_norm. The fused-backward
LayerNorm kernels run through incubate.nn.functional.fused_layer_norm,
as in the JAX package."""
from __future__ import annotations

import torch

from ...ops._registry import eager


def _layer_norm_raw(x, weight, bias, epsilon, begin_norm_axis):
    axes = tuple(range(begin_norm_axis, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = -len(tuple(normalized_shape))
    args = [x]
    if weight is not None:
        args.append(weight)
    if bias is not None:
        args.append(bias)

    def raw(*a):
        w = a[1] if weight is not None else None
        b = a[-1] if bias is not None else None
        return _layer_norm_raw(a[0], w, b, epsilon, a[0].ndim + begin)

    return eager(raw, tuple(args), {}, name="layer_norm")


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """Plain RMSNorm (`kernels.rms_norm.rms_norm_ref`), as the JAX
    package's nn.functional runs it."""
    from ...kernels.rms_norm import rms_norm_ref

    args = [x] if weight is None else [x, weight]

    def raw(*a):
        return rms_norm_ref(a[0], a[1] if len(a) > 1 else None, epsilon)

    return eager(raw, tuple(args), {}, name="rms_norm")
