"""Op registration & eager dispatch.

Port of paddle_tpu/ops/_registry.py (:71-224). An op is a raw function
over torch tensors; `eager()` is the whole dispatch path, in the JAX
package's order:

1. unwrap: the Tensors among the positional and keyword arguments give
   their torch tensors;
2. AMP: under `amp.auto_cast`, the float inputs (f32, f16, bf16) are
   cast to the dtype `amp.amp_dtype_for_op(name)` names — an explicit
   cast per op, not `torch.autocast`, so every output dtype is JAX's;
3. run `raw` with grad recording exactly when the JAX tape records: grad
   mode on and at least one floating input that is not stop_gradient.
   Inputs that are stop_gradient enter detached;
4. wrap: a recorded float output is a non-leaf with stop_gradient=False;
   integer and bool outputs, and every output of an unrecorded op, are
   stop_gradient leaves.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..core.tensor import Tensor, _is_float
from ..core import dtype as dtypes
from ..core.device import _device
from ..core.flags import flag

_amp_fn = None

# dtypes AMP may cast (never complex/f64 — the reference casts fp32 only)
_AMP_CASTABLE = (dtypes.float32, dtypes.float16, dtypes.bfloat16)


def _amp_dtype(name):
    global _amp_fn
    if _amp_fn is None:
        from ..amp import amp_dtype_for_op
        _amp_fn = amp_dtype_for_op
    return _amp_fn(name)


def _maybe_check_finite(name, arrays):
    if not flag("FLAGS_check_nan_inf"):
        return
    for a in arrays:
        if _is_float(a) and not bool(torch.isfinite(a.float()).all()):
            raise FloatingPointError(
                f"nan/inf detected in output of op '{name}'")


def _input(t: Tensor, amp_dt, record: bool) -> torch.Tensor:
    d = t._data
    if record and not t.stop_gradient and _is_float(d):
        if t._leaf and not d.requires_grad:
            d.requires_grad_(True)
    elif d.requires_grad:
        d = d.detach()
    if amp_dt is not None and d.dtype in _AMP_CASTABLE and d.dtype != amp_dt:
        d = d.to(amp_dt)
    return d


def eager(raw: Callable, args, kwargs, name: str = "op"):
    """Run one op eagerly, recording it on torch autograd when the JAX
    tape would. `raw` takes torch tensors in the positions where Tensors
    were passed (positional or keyword); all other arguments pass through
    unchanged. Returns a Tensor or a tuple of Tensors."""
    tins = [a for a in args if isinstance(a, Tensor)] + \
        [v for v in kwargs.values() if isinstance(v, Tensor)]
    record = torch.is_grad_enabled() and any(
        not t.stop_gradient and _is_float(t._data) for t in tins)
    amp_dt = _amp_dtype(name)
    arrs = [_input(a, amp_dt, record) if isinstance(a, Tensor) else a
            for a in args]
    kw_arrs = {k: (_input(v, amp_dt, record) if isinstance(v, Tensor)
                   else v) for k, v in kwargs.items()}
    with torch.set_grad_enabled(record):
        out = raw(*arrs, **kw_arrs)
    multi = isinstance(out, (tuple, list))
    outs = tuple(out) if multi else (out,)
    _maybe_check_finite(name, outs)
    wrapped = tuple(Tensor._wrap(o, not (record and _is_float(o)))
                    for o in outs)
    return wrapped if multi else wrapped[0]


def defop(name: str, raw: Callable) -> Callable:
    """A raw torch-level function as a public eager op named `name`."""

    @functools.wraps(raw)
    def op(*args, **kwargs):
        return eager(raw, args, kwargs, name=name)

    op.__name__ = name
    op.raw = raw
    return op


def adopt_inplace(x: Tensor, out: Tensor) -> Tensor:
    """An in-place op's result `out` written into x (the JAX package's
    `adopt_inplace`, paddle_tpu/ops/_registry.py:178). Recorded (grad
    mode on and a differentiable input): x takes out's tensor and its
    place in the graph, a non-leaf that is not stop_gradient; the graph
    keeps x's old tensor as the op's input, so backward runs through the
    write. Not recorded: a leaf's storage takes the value when the shape
    and dtype stay (a parameter keeps its tensor), else x takes out's
    tensor (requiring grad as before); a non-leaf that is not
    stop_gradient refuses, as in the JAX package, since the write would
    corrupt the graph it belongs to. x's version goes up by one."""
    recorded = not out._leaf
    if not recorded and not x._leaf and not x.stop_gradient:
        raise RuntimeError(
            "in-place modification of a non-leaf tensor while gradient "
            "recording is off would corrupt the autograd graph; detach() "
            "first or perform the update out-of-place")
    d, new = x._data, out._data
    if recorded or not x._leaf:
        x._set_data(new)
        x._sg, x._leaf = out._sg, out._leaf
    elif new.shape == d.shape and new.dtype == d.dtype:
        with torch.no_grad():
            d.copy_(new)
    else:
        x._set_data(new.detach().requires_grad_(
            d.requires_grad and _is_float(new)))
    x._version += 1
    return x


def as_array(x):
    """A Tensor's torch tensor, or a numpy array or python value as a torch
    tensor on the current place: for raw functions that take an argument
    that is not differentiated (indices, labels, masks)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=_device())
