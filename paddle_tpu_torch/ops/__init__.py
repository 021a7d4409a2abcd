"""paddle_tpu_torch.ops — the functional op surface of the eager API.

Port of paddle_tpu/ops/__init__.py (:28-175), holding the ops the eager
path uses. As in the JAX package, every op is exported here and attached
as a Tensor method, with Paddle's method aliases and the Tensor protocol:
the arithmetic operators (`+ - * / // % ** @`, unary `-`, `abs`), the
comparisons and `~ & | ^` (logical on a bool tensor, bitwise otherwise:
the left operand's dtype decides, as in the JAX package). In-place
variants (`add_`, ...) arrive with the rest of the eager API (ROADMAP.md
Queue 1).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

from ._registry import defop, eager, as_array  # noqa: F401
from .creation import to_tensor, zeros, ones, full, arange  # noqa: F401
from .creation import assign, clone  # noqa: F401
from .math import (add, subtract, multiply, divide, exp, tanh,  # noqa: F401
                   matmul, floor_divide, mod, remainder, floor_mod, pow,
                   abs, neg, bitwise_and, bitwise_or, bitwise_xor,
                   bitwise_not)
from .manipulation import (reshape, transpose, flatten,  # noqa: F401
                           squeeze, unsqueeze, cast, concat, stack, split,
                           getitem, setitem_)
from .reduction import sum, mean  # noqa: F401
from .comparison import (equal, not_equal, greater_than,  # noqa: F401
                         greater_equal, less_than, less_equal, logical_and,
                         logical_or, logical_xor, logical_not)

from . import (comparison, creation, math, manipulation,  # noqa: F401
               reduction)

# paddle method aliases
_ALIASES = {"sub": "subtract", "mul": "multiply", "div": "divide"}


def _attach():
    for fn in (add, subtract, multiply, divide, exp, tanh, matmul, reshape,
               transpose, flatten, squeeze, unsqueeze, equal, not_equal,
               floor_divide, mod, remainder, floor_mod, pow, abs, neg,
               bitwise_and, bitwise_or, bitwise_xor, bitwise_not,
               greater_than, greater_equal, less_than, less_equal,
               logical_and, logical_or, logical_xor, logical_not):
        if not hasattr(Tensor, fn.__name__):
            setattr(Tensor, fn.__name__, fn)
    for alias, target in _ALIASES.items():
        setattr(Tensor, alias, getattr(Tensor, target))

    def _swap(f):
        def r(self, other):
            return f(to_tensor(other, place=self.place), self)
        return r

    Tensor.__add__ = lambda s, o: add(s, o)
    Tensor.__radd__ = lambda s, o: add(s, o)
    Tensor.__sub__ = lambda s, o: subtract(s, o)
    Tensor.__rsub__ = _swap(subtract)
    Tensor.__mul__ = lambda s, o: multiply(s, o)
    Tensor.__rmul__ = lambda s, o: multiply(s, o)
    Tensor.__truediv__ = lambda s, o: divide(s, o)
    Tensor.__rtruediv__ = _swap(divide)
    Tensor.__floordiv__ = lambda s, o: floor_divide(s, o)
    Tensor.__rfloordiv__ = _swap(floor_divide)
    Tensor.__mod__ = lambda s, o: mod(s, o)
    Tensor.__rmod__ = _swap(mod)
    Tensor.__pow__ = lambda s, o: pow(s, o)
    Tensor.__rpow__ = _swap(pow)
    Tensor.__matmul__ = lambda s, o: matmul(s, o)
    Tensor.__rmatmul__ = _swap(matmul)
    Tensor.__neg__ = lambda s: neg(s)
    Tensor.__abs__ = lambda s: abs(s)

    def _bool_or_bits(logical, bits):
        # paddle_tpu/ops/__init__.py:165-168: the left operand decides
        return lambda s, *o: (logical if s.dtype == torch.bool
                              else bits)(s, *o)

    Tensor.__invert__ = _bool_or_bits(logical_not, bitwise_not)
    Tensor.__and__ = _bool_or_bits(logical_and, bitwise_and)
    Tensor.__or__ = _bool_or_bits(logical_or, bitwise_or)
    Tensor.__xor__ = _bool_or_bits(logical_xor, bitwise_xor)
    Tensor.__lt__ = lambda s, o: less_than(s, o)
    Tensor.__le__ = lambda s, o: less_equal(s, o)
    Tensor.__gt__ = lambda s, o: greater_than(s, o)
    Tensor.__ge__ = lambda s, o: greater_equal(s, o)
    # elementwise, as paddle_tpu/ops/__init__.py:169-170; __hash__ stays
    # id (core/tensor.py), so dicts and sets of Tensors key on identity
    Tensor.__eq__ = lambda s, o: equal(s, o)
    Tensor.__ne__ = lambda s, o: not_equal(s, o)

    Tensor.sum = lambda s, axis=None, dtype=None, keepdim=False, name=None: \
        sum(s, axis, dtype, keepdim)
    Tensor.mean = lambda s, axis=None, keepdim=False, name=None: \
        mean(s, axis, keepdim)
    Tensor.split = lambda s, num_or_sections, axis=0, name=None: \
        split(s, num_or_sections, axis)


_attach()
