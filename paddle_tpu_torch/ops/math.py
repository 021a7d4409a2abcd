"""Elementwise math and matmul — port of paddle_tpu/ops/math.py (the ops
the eager path uses)."""
from __future__ import annotations

import numpy as np
import torch

from ._registry import defop


def _other(y, like):
    """The second operand: a tensor as it is, a python scalar as it is,
    an array-like on x's device. A python scalar keeps a float x's dtype,
    as jax's weak types do; with an integer x, a python float gives
    torch's default float dtype, float32, where the JAX package (under
    `jax_enable_x64`) gives float64: a recorded divergence."""
    if isinstance(y, (torch.Tensor, bool, int, float, complex)):
        return y
    return torch.as_tensor(np.asarray(y), device=like.device)


add = defop("add", lambda x, y, name=None: torch.add(x, _other(y, x)))
subtract = defop("subtract",
                 lambda x, y, name=None: torch.sub(x, _other(y, x)))
multiply = defop("multiply",
                 lambda x, y, name=None: torch.mul(x, _other(y, x)))
divide = defop("divide",
               lambda x, y, name=None: torch.true_divide(x, _other(y, x)))
exp = defop("exp", lambda x, name=None: torch.exp(x))
tanh = defop("tanh", lambda x, name=None: torch.tanh(x))


def _matmul_raw(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


matmul = defop("matmul", _matmul_raw)
