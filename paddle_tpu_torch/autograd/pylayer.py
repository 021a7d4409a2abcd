"""PyLayer: user-defined autograd functions.

Port of paddle_tpu/autograd/pylayer.py (:25-99). A subclass gives static
`forward(ctx, *args)` and `backward(ctx, *grads)` over Tensors;
`apply` runs forward with recording off and joins its outputs to the
differentiable Tensor inputs through one `torch.autograd.Function`
node, whose backward calls the subclass's backward with the output
gradients as Tensors. Arguments mix Tensors and other values; backward
returns one gradient (or None) per positional Tensor argument.

As in the JAX package: under `no_grad`, or when no Tensor argument is
differentiable, `apply` returns forward's outputs with no node; a
non-float output's gradient arrives as None, a float output that the
loss does not reach gives zeros; the node's backward cannot itself be
differentiated (`paddle.grad(create_graph=True)` through it raises).
`ctx.mark_non_differentiable(t)` makes output t stop_gradient, with a
zero gradient in backward, as Paddle documents; the JAX package records
the call and keeps t differentiable (a recorded divergence).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, _is_float
from ..ops._registry import _input


class PyLayerContext:
    """The `ctx` of forward and backward: saved tensors, marks, and any
    attribute the user sets."""

    def __init__(self):
        self._saved = ()
        self._non_diff = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    saved_tensors = property(lambda self: self._saved)

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        self._non_diff = args


class _Node(torch.autograd.Function):
    """The graph node of one `PyLayer.apply`: forward returns the torch
    tensors of the user's outputs (`run` calls the user's forward);
    backward calls the user's backward."""

    @staticmethod
    def forward(fctx, layer, ctx, run, diff_pos, *datas):
        outs = run()
        fctx.layer, fctx.ctx, fctx.diff_pos = layer, ctx, diff_pos
        fctx.meta = [(o._data.shape, o._data.dtype, o._data.device,
                      _is_float(o._data)
                      and not any(o is m for m in ctx._non_diff))
                     for o in outs]
        fctx.mark_non_differentiable(*[o._data for o, m in
                                       zip(outs, fctx.meta) if not m[3]])
        fctx.set_materialize_grads(False)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(fctx, *grads):
        layer = fctx.layer
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"create_graph=True through '{layer.__name__}' is not "
                "supported: the node has an opaque Python backward (custom "
                "PyLayer); write its backward with differentiable ops")
        gts = []
        for g, (shape, dtype, device, diff) in zip(grads, fctx.meta):
            if not dtype.is_floating_point and not dtype.is_complex:
                gts.append(None)
            elif g is None or not diff:
                gts.append(Tensor._wrap(torch.zeros(shape, dtype=dtype,
                                                    device=device), True))
            else:
                gts.append(Tensor._wrap(g, True))
        gin = layer.backward(fctx.ctx, *gts)
        if not isinstance(gin, (tuple, list)):
            gin = (gin,)
        out = []
        for i in fctx.diff_pos:
            g = gin[i] if i < len(gin) else None
            if g is not None and not isinstance(g, torch.Tensor):
                g = g._data if isinstance(g, Tensor) else torch.as_tensor(g)
            out.append(g)
        return (None, None, None, None) + tuple(out)


class PyLayer:
    """Subclass with static `forward(ctx, ...)` and `backward(ctx, ...)`;
    call `apply(...)`."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        tins = [a for a in args if isinstance(a, Tensor)]
        diff_pos = [i for i, t in enumerate(tins)
                    if not t.stop_gradient and _is_float(t._data)]
        if not (torch.is_grad_enabled() and diff_pos):
            return cls.forward(ctx, *args, **kwargs)
        box = {}

        def run():
            outs = cls.forward(ctx, *args, **kwargs)
            multi = isinstance(outs, (tuple, list))
            box["outs"], box["multi"] = outs, multi
            return list(outs) if multi else [outs]

        datas = [_input(tins[i], None, True) for i in diff_pos]
        res = _Node.apply(cls, ctx, run, diff_pos, *datas)
        outs, multi = box["outs"], box["multi"]
        lst = list(outs) if multi else [outs]
        new = []
        for o, d in zip(lst, res):
            if any(o is t for t in tins):       # an input returned as is
                o = Tensor._wrap(d, True)
            o._set_data(d)
            o._sg = o._leaf = not d.requires_grad
            new.append(o)
        if not multi:
            return new[0]
        return type(outs)(new)


class LegacyPyLayer(PyLayer):
    """Paddle's older name for PyLayer; the same class."""
