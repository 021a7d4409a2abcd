"""Grad mode, backward and paddle.grad over torch autograd.

Port of paddle_tpu/autograd/tape.py (:36-136, :393-428). The JAX package
records a GradNode per eager op (a `jax.vjp` closure) and walks them in
reverse order, re-recording each vjp as eager ops for create_graph; here
torch autograd is the tape, so `GradNode` and the replay machinery have
no counterpart. The grad mode is torch's own; `backward` hands the
seeded roots to `torch.autograd.backward`, which accumulates into each
leaf's `.grad` (the f32 grad of an f32 parameter used by a bf16 AMP op
comes back in f32, as the JAX tape casts it); `grad` is
`torch.autograd.grad`, which writes no `.grad`. Tensor hooks
(`Tensor.register_hook`) run in both.
"""
from __future__ import annotations

import contextlib

import torch


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


is_grad_enabled = grad_enabled


@contextlib.contextmanager
def no_grad():
    with torch.no_grad():
        yield


@contextlib.contextmanager
def enable_grad():
    with torch.enable_grad():
        yield


class set_grad_enabled:
    """Applies immediately on construction (paddle/torch semantics: the
    plain call `set_grad_enabled(False)` flips the mode); also usable as
    a context manager that restores the previous mode on exit."""

    def __init__(self, mode):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(bool(mode))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False


def _seeds(tensors, grad_tensors, hint):
    """The roots that require grad and their seeds in the roots' dtypes;
    a None seed is ones for a one-element root."""
    from ..core.tensor import Tensor

    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    roots, grads = [], []
    for t, g in zip(tensors, grad_tensors):
        if g is None:
            if t._data.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs; "
                    f"pass {hint}")
            g = torch.ones_like(t._data)
        elif isinstance(g, Tensor):
            g = g._data
        else:
            g = torch.as_tensor(g, device=t._data.device)
        if t._data.requires_grad:
            roots.append(t._data)
            grads.append(g.to(t._data.dtype))
    return roots, grads


def backward(tensors, grad_tensors=None, retain_graph=False) -> None:
    """paddle.autograd.backward: leaves with stop_gradient=False receive
    (accumulate into) `.grad`. A root that no differentiable leaf reaches
    contributes nothing, as on the JAX tape."""
    roots, grads = _seeds(tensors, grad_tensors,
                          "grad_tensors for non-scalar backward()")
    if roots:
        torch.autograd.backward(roots, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    a list of Tensors in the inputs' dtypes. No tensor's `.grad` or
    `retain_grads` state changes; hooks on the way run, the inputs' own
    included. create_graph=True records the gradient computation, so the
    results are differentiable (a gradient penalty's backward runs
    through them); retain_graph defaults to create_graph. An input no
    output reaches (or one that is stop_gradient) raises, as in the JAX
    package, unless allow_unused gives None for it."""
    from ..core.tensor import Tensor

    inputs = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    roots, seeds = _seeds(outputs, grad_outputs,
                          "grad_outputs for non-scalar grad()")
    want = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    got = [None] * len(inputs)
    if roots and want:
        res = torch.autograd.grad(
            roots, [inputs[i]._data for i in want], seeds,
            retain_graph=create_graph if retain_graph is None
            else bool(retain_graph),
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(want, res):
            got[i] = g
    out = []
    for t, g in zip(inputs, got):
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    f"one of the input tensors was not used in the graph "
                    f"(shape={t.shape}); pass allow_unused=True to get None")
            out.append(None)
            continue
        out.append(Tensor._wrap(g, not g.requires_grad))
    return out
