"""Comparison ops — port of paddle_tpu/ops/comparison.py (:9-10):
`equal` and `not_equal`, the two that `Tensor.__eq__` and `__ne__` are.

Both broadcast as the JAX ops do and return bool Tensors, which record
no gradient (the eager dispatch wraps a non-float output as a
stop_gradient leaf)."""
from __future__ import annotations

import torch

from ._registry import defop
from .math import _other

equal = defop("equal", lambda x, y, name=None: torch.eq(x, _other(y, x)))
not_equal = defop("not_equal",
                  lambda x, y, name=None: torch.ne(x, _other(y, x)))
