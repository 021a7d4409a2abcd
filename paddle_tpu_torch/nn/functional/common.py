"""Common functionals: linear, dropout, embedding — port of
paddle_tpu/nn/functional/common.py (:24, :40, :96)."""
from __future__ import annotations

import torch

from ...ops._registry import as_array, eager
from ...ops.math import _promote
from ...core.tensor import Tensor
from ...core import random as prandom


def _linear_raw(x, weight, bias=None, name=None):
    # paddle weight layout is [in_features, out_features]: x @ w, in the
    # operands' promoted dtype, as jnp.matmul computes it
    out = torch.matmul(*_promote(x, weight))
    if bias is not None:
        out = out + bias
    return out


def linear(x, weight, bias=None, name=None):
    if bias is None:
        return eager(_linear_raw, (x, weight), {}, name="linear")
    return eager(_linear_raw, (x, weight, bias), {}, name="linear")


def _keep_mask(shape, keep, device):
    """Bernoulli(keep) mask drawn from the device's seeded generator."""
    u = torch.rand(shape, device=device,
                   generator=prandom.default_generator(device))
    return u < keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else Tensor(x)
    keep = 1.0 - p
    if keep == 0.0 and axis is None:
        # every element dropped: zeros, as `_dropout_raw` gives
        # (paddle_tpu/nn/functional/common.py:30-37); with `axis` the JAX
        # package divides by keep and raises, and so does this
        return eager(lambda a: a * 0, (x,), {}, name="dropout")
    scale = 1.0 / keep if mode == "upscale_in_train" else 1.0
    axes = None if axis is None else \
        ([axis] if isinstance(axis, int) else list(axis))

    def raw(a):
        # with `axis`, the mask is broadcast along the other axes
        shape = a.shape if axes is None else \
            [a.shape[i] if i in axes else 1 for i in range(a.ndim)]
        mask = _keep_mask(tuple(shape), keep, a.device)
        return torch.where(mask, a * scale, 0.0).to(a.dtype)

    return eager(raw, (x,), {}, name="dropout")


def _embedding_raw(x, weight, padding_idx=None):
    out = weight[x.to(weight.device)]
    if padding_idx is not None:
        mask = (x != padding_idx)[..., None].to(weight.device)
        out = out * mask.to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    idx = as_array(x)
    return eager(lambda w: _embedding_raw(idx, w, padding_idx), (weight,),
                 {}, name="embedding")
