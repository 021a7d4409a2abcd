"""Elementwise math and matmul — port of paddle_tpu/ops/math.py (the ops
the eager path and the Tensor protocol use)."""
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


def _sub_raw(x, y, name=None):
    """x - y. torch refuses a bool operand of `sub`; jnp promotes it:
    `1.0 - mask` is f32, `1 - mask` int64, `x - mask` x's dtype. The
    bool side is cast to the promoted dtype first (a Python bool becomes
    an int). Bool minus bool promotes to bool and still raises, as in
    the JAX package."""
    y = _other(y, x)
    if x.dtype == torch.bool or isinstance(y, bool) or (
            isinstance(y, torch.Tensor) and y.dtype == torch.bool):
        dt = torch.result_type(x, y)
        if dt != torch.bool:
            x = x.to(dt)
            if isinstance(y, torch.Tensor):
                y = y.to(dt)
            elif isinstance(y, bool):
                y = int(y)
    return torch.sub(x, y)


subtract = defop("subtract", _sub_raw)
multiply = defop("multiply",
                 lambda x, y, name=None: torch.mul(x, _other(y, x)))
divide = defop("divide",
               lambda x, y, name=None: torch.true_divide(x, _other(y, x)))
def _bools_as_int32(x, y):
    """jnp's floor_divide, mod and power of a bool array by a bool (a
    tensor or a Python bool) compute in int32; torch has none of them
    for bool."""
    if x.dtype == torch.bool and (isinstance(y, bool) or (
            isinstance(y, torch.Tensor) and y.dtype == torch.bool)):
        return x.int(), (y.int() if isinstance(y, torch.Tensor) else int(y))
    return x, y


def _pow_raw(x, y, name=None):
    """jnp.power: a bool array to a Python int (or bool) is int32 too,
    where torch gives int64 (or bool)."""
    y = _other(y, x)
    if x.dtype == torch.bool and isinstance(y, int):
        return torch.pow(x.int(), int(y))
    return torch.pow(*_bools_as_int32(x, y))


floor_divide = defop("floor_divide", lambda x, y, name=None:
                     torch.floor_divide(*_bools_as_int32(x, _other(y, x))))
# jnp.mod: the remainder takes the divisor's sign, as torch.remainder's
mod = defop("mod", lambda x, y, name=None:
            torch.remainder(*_bools_as_int32(x, _other(y, x))))
remainder = mod
floor_mod = mod
pow = defop("pow", _pow_raw)
exp = defop("exp", lambda x, name=None: torch.exp(x))
tanh = defop("tanh", lambda x, name=None: torch.tanh(x))
# jnp.abs of a bool array is the array
abs = defop("abs", lambda x, name=None:
            x if x.dtype == torch.bool else torch.abs(x))
neg = defop("neg", lambda x, name=None: torch.neg(x))

bitwise_and = defop("bitwise_and", lambda x, y, name=None:
                    torch.bitwise_and(x, _other(y, x)))
bitwise_or = defop("bitwise_or", lambda x, y, name=None:
                   torch.bitwise_or(x, _other(y, x)))
bitwise_xor = defop("bitwise_xor", lambda x, y, name=None:
                    torch.bitwise_xor(x, _other(y, x)))
bitwise_not = defop("bitwise_not", lambda x, name=None: torch.bitwise_not(x))


def _promote(x, y):
    """x and y in the dtype jnp.matmul computes in: their promoted type
    (torch.promote_types agrees with JAX's lattice for the float and
    integer pairs of the eager API). Operands of that dtype pass as they
    are, so an auto_cast route that already cast them launches no cast."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _matmul_raw(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    if x.dtype == y.dtype == torch.bool:
        # jnp.matmul of two bool arrays is bool (any of the products);
        # torch has no bool matmul: count the products in f32, exact
        # below 2^24 terms
        return torch.matmul(x.float(), y.float()) != 0
    return torch.matmul(*_promote(x, y))


matmul = defop("matmul", _matmul_raw)
