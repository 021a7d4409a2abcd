"""paddle_tpu_torch.ops — the functional op surface of the eager API.

Port of paddle_tpu/ops/__init__.py (:28-175), holding the ops the eager
path uses. As in the JAX package, every op is exported here and attached
as a Tensor method, with Paddle's method aliases and the Tensor protocol:
the arithmetic operators (`+ - * / // % ** @`, unary `-`, `abs`), the
comparisons and `~ & | ^` (logical on a bool tensor, bitwise otherwise:
the left operand's dtype decides, as in the JAX package). Each op
named in the JAX package's in-place lists (`INPLACE`) has its in-place
variant `name_` here and as a Tensor method, and `where_` writes into x
(`_registry.adopt_inplace`); the in-place variants of the JAX package's
other ops come with them (ROADMAP.md Queue 1, item 7).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

from ._registry import defop, eager, as_array, adopt_inplace  # noqa: F401
from .creation import to_tensor, zeros, ones, full, arange  # noqa: F401
from .creation import assign, clone  # noqa: F401
from .math import (add, subtract, multiply, divide, exp, tanh,  # noqa: F401
                   matmul, floor_divide, mod, remainder, floor_mod, pow,
                   abs, neg, bitwise_and, bitwise_or, bitwise_xor,
                   bitwise_not)
from .manipulation import (reshape, transpose, flatten,  # noqa: F401
                           squeeze, unsqueeze, cast, concat, stack, split,
                           getitem, setitem_, where)
from .reduction import sum, mean  # noqa: F401
from .comparison import (equal, not_equal, greater_than,  # noqa: F401
                         greater_equal, less_than, less_equal, logical_and,
                         logical_or, logical_xor, logical_not)

from . import (comparison, creation, math, manipulation,  # noqa: F401
               reduction)

# paddle method aliases
_ALIASES = {"sub": "subtract", "mul": "multiply", "div": "divide"}

# the ops with an in-place twin `name_` in the JAX package: its _INPLACE
# (paddle_tpu/ops/__init__.py:54-76) and _MORE_INPLACE
# (paddle_tpu/ops/method_ext.py:54) lists, in their order
INPLACE = list(dict.fromkeys([
    "add", "subtract", "multiply", "divide", "clip", "scale", "exp", "sqrt",
    "rsqrt", "floor", "ceil", "round", "reciprocal", "abs", "sin", "cos",
    "tanh", "sigmoid", "relu", "flatten", "reshape", "squeeze", "unsqueeze",
    "pow", "mod", "floor_divide", "neg", "log", "lerp", "erfinv",
    "masked_fill", "index_put", "index_add", "put_along_axis",
    "cast", "transpose",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh",
    "atanh", "expm1", "log2", "log10", "log1p", "square",
    "trunc", "frac", "nan_to_num", "logit", "renorm", "copysign", "hypot",
    "i0", "ldexp", "digamma", "lgamma", "polygamma", "gamma", "erf",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
    "tril", "triu", "scatter", "masked_scatter", "cumsum",
    "cumprod", "fmax", "fmin", "maximum", "minimum", "remainder",
    "gcd", "lcm", "heaviside", "atan2", "nextafter",
    # _MORE_INPLACE
    "deg2rad", "rad2deg", "sign", "relu6", "elu", "celu", "selu", "silu",
    "gelu", "leaky_relu", "hardtanh", "hardsigmoid", "hardswish",
    "softplus", "softsign", "tanhshrink", "stanh", "flip",
    "scatter_nd_add", "maximum", "minimum", "fmax", "fmin", "atan2",
    "hypot", "copysign", "ldexp", "heaviside", "nextafter", "logit",
    "lgamma", "digamma", "erf", "i0", "gcd", "lcm", "frac",
    "nan_to_num", "logical_and", "logical_or", "logical_xor",
    "logical_not", "roll", "rot90", "take_along_axis", "index_select",
    "gather", "tile", "repeat_interleave", "broadcast_to", "expand",
    "diff", "kron", "cross", "dot", "outer", "inner",
    "thresholded_relu", "hardshrink", "softshrink", "mish",
    "log_sigmoid", "swish",
]))


def _inplace(fn, name):
    def inplace(x, *args, **kwargs):
        return adopt_inplace(x, fn(x, *args, **kwargs))

    inplace.__name__ = name
    inplace.__doc__ = (f"In-place `{fn.__name__}`: x takes the result "
                       "(`adopt_inplace`) and is returned.")
    return inplace


def attach_inplace(namespace: dict) -> list:
    """`name_` for each op of `namespace` named in INPLACE, added to the
    namespace and, where the Tensor has no such method yet, as a Tensor
    method. Returns the new names."""
    made = []
    for name in INPLACE:
        fn = namespace.get(name)
        if callable(fn):
            ip = _inplace(fn, name + "_")
            namespace[ip.__name__] = ip
            if not hasattr(Tensor, ip.__name__):
                setattr(Tensor, ip.__name__, ip)
            made.append(ip.__name__)
    return made


def where_(condition, x, y, name=None):
    """paddle.where_: writes where(condition, x, y) into x, not into the
    condition (paddle_tpu/ops/__init__.py:129-133)."""
    return adopt_inplace(x, where(condition, x, y))


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
    # the condition is the receiver, x is written (as in the JAX package)
    Tensor.where_ = lambda s, x, y, name=None: where_(s, x, y)


_attach()
# the in-place twins of the ops above: add_, exp_, reshape_, ...
INPLACE_OPS = attach_inplace(globals()) + ["where_"]
