"""paddle.incubate.nn.functional — the fused ops of the eager path.

Port of paddle_tpu/incubate/nn/functional/__init__.py: `fused_layer_norm`
(:52-65, the fused-backward LayerNorm kernels of kernels/layer_norm.py),
`fused_dropout_add` (:255-273), `fused_matmul_bias` (:169) and
`fused_linear` (:187). `fused_rms_norm`, `fused_rotary_position_embedding`,
`swiglu` and `fused_multi_transformer` arrive with the eager Llama slice.
"""
from __future__ import annotations

import torch

from ....ops._registry import eager
from ....core import random as prandom

__all__ = ["fused_layer_norm", "fused_dropout_add", "fused_matmul_bias",
           "fused_linear"]


def _check_last_axis(x, begin_norm_axis, op):
    ndim = len(x.shape)
    if begin_norm_axis not in (-1, ndim - 1):
        raise NotImplementedError(
            f"{op}: begin_norm_axis={begin_norm_axis} (multi-axis "
            "normalization) not supported — flatten trailing dims first")


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, **kwargs):
    """Last-axis LayerNorm through `kernels.layer_norm.layer_norm_train`:
    the forward kernel saves (mu, rstd), the backward kernel gives dx and
    the summed d_weight/d_bias; the plain versions on the CPU."""
    _check_last_axis(x, begin_norm_axis, "fused_layer_norm")
    from ....kernels.layer_norm import layer_norm_train

    def raw(xa, wa, ba):
        return layer_norm_train(xa, wa, ba, epsilon)

    return eager(raw, (x, norm_weight, norm_bias), {},
                 name="fused_layer_norm")


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y + bias in one op (cuBLAS takes the product; the bias add is
    a plain torch op, as XLA fused it in the JAX package)."""
    def raw(xa, ya, ba=None):
        if transpose_x:
            xa = xa.transpose(-1, -2)
        if transpose_y:
            ya = ya.transpose(-1, -2)
        out = xa @ ya
        return out if ba is None else out + ba

    args = (x, y) if bias is None else (x, y, bias)
    return eager(raw, args, {}, name="fused_matmul_bias")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight + bias: fused_matmul_bias with the linear-layer
    argument order."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y (phi fused_dropout_add); the keep mask is drawn
    from the seeded generator of x's device."""
    if not training or p == 0.0:
        return eager(lambda a, b: a + b, (x, y), {},
                     name="fused_dropout_add")

    def raw(a, b):
        keep = torch.rand(a.shape, device=a.device,
                          generator=prandom.default_generator(a.device)) \
            < 1.0 - p
        if mode == "upscale_in_train":
            a = torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
        else:
            a = torch.where(keep, a, 0.0).to(a.dtype)
        return a + b

    return eager(raw, (x, y), {}, name="fused_dropout_add")
