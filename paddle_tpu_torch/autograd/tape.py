"""Grad mode and backward over torch autograd.

Port of paddle_tpu/autograd/tape.py (:36-136). The JAX package records a
GradNode per eager op (a `jax.vjp` closure) and walks them in reverse
order; here torch autograd is the tape, so `GradNode` and the replay
machinery have no counterpart. The grad mode is torch's own, and
`backward` hands the seeded roots to `torch.autograd.backward`, which
accumulates into each leaf's `.grad` (the f32 grad of an f32 parameter
used by a bf16 AMP op comes back in f32, as the JAX tape casts it).
"""
from __future__ import annotations

import contextlib

import torch


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


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


def backward(tensors, grad_tensors=None, retain_graph=False) -> None:
    """paddle.autograd.backward: leaves with stop_gradient=False receive
    (accumulate into) `.grad`. A root that no differentiable leaf reaches
    contributes nothing, as on the JAX tape."""
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
                    "pass grad_tensors for non-scalar backward()")
            g = torch.ones_like(t._data)
        elif isinstance(g, Tensor):
            g = g._data
        else:
            g = torch.as_tensor(g, device=t._data.device)
        if t._data.requires_grad:
            roots.append(t._data)
            grads.append(g.to(t._data.dtype))
    if roots:
        torch.autograd.backward(roots, grads, retain_graph=retain_graph)
