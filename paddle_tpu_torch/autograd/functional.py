"""paddle.autograd's functional transforms: jacobian, hessian, vjp, jvp
and the Jacobian / Hessian views.

Port of paddle_tpu/autograd/functional.py (:44-157) over `torch.func`
(`jacrev`, `hessian`, `vjp`, `jvp`, `vmap`): the wrapper moves Tensors
across the boundary and returns the JAX package's structure (a Tensor
for a single input, a tuple per input otherwise; the Hessian of several
inputs as a tuple of tuples). `batch_axis=0` maps the transform over
the leading axis (per-sample Jacobians and Hessians).

`torch.func` cannot pass through a `torch.autograd.Function` that has no
`setup_context` and no vmap rule, which the port's kernel ops are (the
fused norms, flash attention: on the CPU too, where their plain versions
run inside the same Functions). A transform that reaches one raises
RuntimeError saying so. The JAX package's jacobian, hessian and vjp pass
through its kernels' `custom_vjp`, and its jvp refuses them: a recorded
divergence (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from ..core.tensor import Tensor

__all__ = ["jacobian", "hessian", "vjp", "jvp", "Jacobian", "Hessian"]


def _unwrap(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return torch.as_tensor(x)


def _wrap(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return Tensor._wrap(x.detach(), True)


def _inputs(xs):
    """(single, the inputs' torch tensors, detached)."""
    single = not isinstance(xs, (list, tuple))
    return single, [_unwrap(x).detach() for x in ([xs] if single else xs)]


def _fnify(func):
    """func over Tensors as a function over torch tensors: the inputs
    enter as differentiable Tensors, so the eager ops record under the
    transform."""
    def fn(*arrs):
        return _unwrap(func(*[Tensor._wrap(a, False) for a in arrs]))
    return fn


def _call(transform, *args):
    try:
        return transform(*args)
    except RuntimeError as e:
        if "setup_context" not in str(e):
            raise
        raise RuntimeError(
            "paddle.autograd functional transforms run on torch.func, "
            "which cannot pass through this op: its autograd.Function (a "
            "kernel op of the port: a fused norm, flash attention) has no "
            "torch.func rule. Use paddle.grad, or the op's plain "
            "version") from e


def jacobian(func: Callable, xs, batch_axis=None) -> Union[Tensor, tuple]:
    """∂func/∂xs: a Tensor for one input (the output's shape then the
    input's), a tuple per input otherwise. batch_axis=0: per-sample
    Jacobians over the leading axis."""
    single, arrs = _inputs(xs)
    jac = torch.func.jacrev(_fnify(func), argnums=tuple(range(len(arrs))))
    if batch_axis is not None:
        if batch_axis != 0:
            raise ValueError("batch_axis must be None or 0")
        jac = torch.func.vmap(jac)
    out = _wrap(tuple(_call(jac, *arrs)))
    return out[0] if single else out


def hessian(func: Callable, xs, batch_axis=None) -> Union[Tensor, tuple]:
    """∂²func/∂xs² of a scalar-output func: a Tensor for one input, a
    tuple of tuples (row per input) otherwise."""
    single, arrs = _inputs(xs)
    fn = _fnify(func)

    def scalar_fn(*a):
        out = fn(*a)
        if out.numel() != 1:
            raise ValueError(
                "hessian requires a scalar-output func, got output shape "
                f"{tuple(out.shape)}")
        return out.squeeze()

    hes = torch.func.hessian(scalar_fn, argnums=tuple(range(len(arrs))))
    if batch_axis is not None:
        if batch_axis != 0:
            raise ValueError("batch_axis must be None or 0")
        hes = torch.func.vmap(hes)
    hes = _call(hes, *arrs)
    if single:
        return _wrap(hes[0][0])
    return tuple(tuple(_wrap(h) for h in row) for row in hes)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def vjp(func: Callable, xs, v=None):
    """(func(xs), vᵀ·∂func/∂xs), v defaulting to ones; a list of
    cotangents for a tuple-returning func."""
    single, arrs = _inputs(xs)
    out, pullback = _call(torch.func.vjp, _fnify(func), *arrs)
    if v is None:
        cot = type(out)(torch.ones_like(o) for o in out) \
            if isinstance(out, (list, tuple)) else torch.ones_like(out)
    else:
        leaves = iter(_unwrap(leaf) for leaf in _leaves(v))
        cot = type(out)(next(leaves) for _ in out) \
            if isinstance(out, (list, tuple)) else next(leaves)
    grads = _call(pullback, cot)
    return _wrap(out), (_wrap(grads[0]) if single else _wrap(tuple(grads)))


def jvp(func: Callable, xs, v=None):
    """(func(xs), ∂func/∂xs · v), v defaulting to ones."""
    _, arrs = _inputs(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in arrs)
    else:
        tv = _unwrap(v)
        tangents = tuple(tv) if isinstance(tv, (list, tuple)) else (tv,)
    out, tangent_out = _call(torch.func.jvp, _fnify(func), tuple(arrs),
                             tangents)
    return _wrap(out), _wrap(tangent_out)


class _MatrixView:
    """Indexable view over a Tensor result or a (nested) tuple of them:
    multi-input Jacobians index per input first, J[i][r, c]."""

    def __init__(self, value):
        self._v = value

    def __getitem__(self, idx):
        if isinstance(self._v, tuple):
            if not isinstance(idx, int):
                raise TypeError(
                    "multi-input Jacobian/Hessian: index the input block "
                    "first (J[i][r, c])")
            return _MatrixView(self._v[idx]) if \
                isinstance(self._v[idx], tuple) else self._v[idx]
        return self._v[idx]

    @property
    def shape(self):
        if isinstance(self._v, tuple):
            return [v.shape for v in self._v]
        return self._v.shape


class Jacobian(_MatrixView):
    """paddle.autograd.Jacobian: the Jacobian, computed in one pass when
    the view is made."""

    def __init__(self, func, xs, is_batched=False):
        super().__init__(jacobian(func, xs,
                                  batch_axis=0 if is_batched else None))


class Hessian(_MatrixView):
    def __init__(self, func, xs, is_batched=False):
        super().__init__(hessian(func, xs,
                                 batch_axis=0 if is_batched else None))
