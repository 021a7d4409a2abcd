"""Reductions — port of paddle_tpu/ops/reduction.py (sum and mean, the
ones the eager path uses)."""
from __future__ import annotations

import numpy as np
import torch

from ._registry import defop
from ..core import dtype as dtypes


def _axis(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    from ..core.tensor import Tensor
    if isinstance(axis, Tensor):
        axis = axis.numpy()
    return tuple(int(a) for a in np.atleast_1d(axis))


def _sum_raw(x, axis=None, dtype=None, keepdim=False, name=None):
    """Sums in x's dtype (integers and bool in int64) and casts the sum
    to `dtype`, as the JAX package does: a bf16 sum is rounded to bf16
    before an f32 `dtype` sees it. A uint8 sum is int64 here and uint64
    in the JAX package (torch has no uint64 sum): a recorded
    divergence."""
    out = torch.sum(x, dim=_axis(axis, x.ndim), keepdim=keepdim)
    if dtype is not None:
        out = out.to(dtypes.convert_dtype(dtype))
    return out


def _mean_raw(x, axis=None, keepdim=False, name=None):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(dtypes.get_default_dtype())
    return torch.mean(x, dim=_axis(axis, x.ndim), keepdim=keepdim)


sum = defop("sum", _sum_raw)
mean = defop("mean", _mean_raw)
