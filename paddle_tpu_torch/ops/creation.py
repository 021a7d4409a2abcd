"""Tensor creation ops — port of paddle_tpu/ops/creation.py (the ones the
eager path uses: to_tensor, zeros, ones, full, arange, assign,
one_hot). Tensors
go to the current place (core/device.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, to_tensor  # noqa: F401  (re-exported)
from ..core import dtype as dtypes
from ..core.device import _device
from ._registry import as_array, eager


def _dt(dtype, default=None):
    if dtype is None:
        return default if default is not None else dtypes.get_default_dtype()
    return dtypes.convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def zeros(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                              device=_device()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                             device=_device()))


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        # paddle's full defaults to the float dtype, bool stays bool
        dtype = "bool" if isinstance(fill_value, bool) else \
            dtypes.get_default_dtype()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                             device=_device()))


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange with Tensor bounds: pass python scalars")
    if end is None:
        start, end = 0, start
    if dtype is None:
        if all(isinstance(v, (int, np.integer)) for v in (start, end, step)):
            dtype = "int64"
        else:
            dtype = dtypes.get_default_dtype()
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=_device()))


def assign(x, output=None) -> Tensor:
    """A copy of x (paddle_tpu/ops/creation.py:130): recorded for
    autograd when x is, as the JAX package's `a + 0`; with `output`, the
    copy is written into it."""
    out = eager(lambda a: a.clone(),
                (x if isinstance(x, Tensor) else to_tensor(x),), {},
                name="assign")
    if output is not None:
        output.set_value(out)
        return output
    return out


def clone(x) -> Tensor:
    return assign(x)


def one_hot(x, num_classes, name=None) -> Tensor:
    """[..., num_classes] in the default float dtype, as jax.nn.one_hot
    (paddle_tpu/ops/creation.py:144): an index outside [0, num_classes)
    gives a row of zeros. Never recorded for autograd."""
    a = as_array(x)
    classes = torch.arange(int(num_classes), device=a.device)
    return Tensor((a[..., None] == classes).to(dtypes.get_default_dtype()))
