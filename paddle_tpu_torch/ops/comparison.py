"""Comparison and logic ops — port of paddle_tpu/ops/comparison.py
(:9-22): `equal`, `not_equal`, the orderings and the `logical_*` ops,
behind `Tensor.__eq__`, `__ne__`, `__lt__`, `__le__`, `__gt__`,
`__ge__` and, for bool tensors, `__and__`, `__or__`, `__xor__` and
`__invert__`.

They broadcast as the JAX ops do and return bool Tensors, which record
no gradient (the eager dispatch wraps a non-float output as a
stop_gradient leaf)."""
from __future__ import annotations

import torch

from ._registry import defop
from .math import _other

equal = defop("equal", lambda x, y, name=None: torch.eq(x, _other(y, x)))
not_equal = defop("not_equal",
                  lambda x, y, name=None: torch.ne(x, _other(y, x)))
greater_than = defop("greater_than",
                     lambda x, y, name=None: torch.gt(x, _other(y, x)))
greater_equal = defop("greater_equal",
                      lambda x, y, name=None: torch.ge(x, _other(y, x)))
less_than = defop("less_than",
                  lambda x, y, name=None: torch.lt(x, _other(y, x)))
less_equal = defop("less_equal",
                   lambda x, y, name=None: torch.le(x, _other(y, x)))


def _logical(fn):
    return lambda x, y, out=None, name=None: fn(x, torch.as_tensor(
        _other(y, x), device=x.device))


logical_and = defop("logical_and", _logical(torch.logical_and))
logical_or = defop("logical_or", _logical(torch.logical_or))
logical_xor = defop("logical_xor", _logical(torch.logical_xor))
logical_not = defop("logical_not",
                    lambda x, out=None, name=None: torch.logical_not(x))
