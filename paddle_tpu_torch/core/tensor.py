"""Tensor: a Paddle-shaped eager tensor over torch.Tensor.

Port of paddle_tpu/core/tensor.py. `Tensor` holds a torch tensor in
`_data`, as the JAX class holds a jax array; it does not subclass
torch.Tensor. Torch autograd is the tape: a leaf whose `stop_gradient`
is False holds a `_data` that requires grad, an op recorded by the eager
dispatch (ops/_registry.py) leaves its graph in the output's `_data`, and
`backward()` runs `torch.autograd.backward` on `_data`.

Paddle semantics kept: `stop_gradient` defaults to True (False for a
Parameter); `.grad` is a Tensor that accumulates over backward calls
until `clear_grad()`; `shape` is a list. Arithmetic operators and op
methods are attached by paddle_tpu_torch.ops, as in the JAX package.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

import numpy as np
import torch

from . import dtype as dtypes
from .device import Place, _device


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a torch tensor on
    `device`, of the array's own shape (0-d stays 0-d). Always a copy:
    the caller's array and the tensor never share memory (an in-place
    op on the tensor leaves the array as it was, as in the JAX
    package)."""
    a = np.asarray(a, order="C")
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


_ids = itertools.count()


def _new_name() -> str:
    return f"generated_tensor_{next(_ids)}"


class _HookHandle:
    """What `Tensor.register_hook` returns; `remove()` takes the hook off.
    The hook sits on the tensor's current torch tensor while that
    requires grad, and moves with it when an in-place op gives the
    Tensor a new one."""

    def __init__(self, tensor: "Tensor", hook):
        self._tensor, self._hook, self._torch = tensor, hook, None

    def _attach(self) -> None:
        d = self._tensor._data
        if self._torch is None and d.requires_grad:
            self._torch = d.register_hook(self._run)

    def _detach(self) -> None:
        if self._torch is not None:
            self._torch.remove()
            self._torch = None

    def _run(self, g: torch.Tensor):
        # under create_graph the gradient is itself differentiable, and
        # the hook's ops on it are recorded
        out = self._hook(Tensor._wrap(g, not g.requires_grad))
        if out is None:
            return None
        if isinstance(out, Tensor):
            return out._data
        return torch.as_tensor(out, dtype=g.dtype, device=g.device)

    def remove(self) -> None:
        self._detach()
        t = self._tensor
        t._hooks = tuple(h for h in t._hooks if h is not self)


class Tensor:
    __slots__ = ("_data", "_sg", "_leaf", "name", "__weakref__", "__dict__")
    _version = 0      # bumped by each in-place write (`__setitem__`, `*_`)
    _hooks = ()       # the handles of register_hook, in order
    _retain = False   # retain_grads() was called

    def __init__(self, data, stop_gradient: bool = True,
                 name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _from_numpy(np.asarray(data), _device())
        self._data = data
        self._leaf = True
        self.stop_gradient = stop_gradient
        self.name = _new_name() if name is None else name

    @classmethod
    def _wrap(cls, data: torch.Tensor, stop_gradient: bool) -> "Tensor":
        """An op's output: not a leaf when it was recorded (a float output
        of an op with a differentiable input under grad mode). Bypasses
        the stop_gradient setter: `data` may be an input's own tensor (a
        cast to its own dtype), whose requires_grad stays as it is."""
        t = cls.__new__(cls)
        t._data = data
        t._sg = t._leaf = stop_gradient
        t.name = _new_name()
        return t

    # ---- autograd state ---------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self._sg = bool(value)
        d = self._data
        # a leaf's torch tensor requires grad exactly when it is trainable
        if self._leaf and d.grad_fn is None and _is_float(d) \
                and d.requires_grad == self._sg:
            d.requires_grad_(not self._sg)
            for h in self._hooks:
                h._attach()

    @property
    def grad(self) -> Optional["Tensor"]:
        d = self._data
        g = d.grad if d.is_leaf or self._retain else None
        return None if g is None else Tensor._wrap(g, True)

    @grad.setter
    def grad(self, value) -> None:
        self._data.grad = None if value is None else \
            (value._data if isinstance(value, Tensor) else value)

    @property
    def is_leaf(self) -> bool:
        return self._leaf

    @property
    def trainable(self) -> bool:
        """Paddle's `trainable`, tied to stop_gradient: setting it False
        stops the gradient, as on a Paddle parameter."""
        return not self._sg

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.stop_gradient = not value

    # ---- basic properties -------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def place(self) -> Place:
        return Place(self._data.device)

    @property
    def T(self) -> "Tensor":
        from .. import ops
        return ops.transpose(self, list(range(self.ndim))[::-1])

    # ---- conversion -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy, which later in-place writes to the tensor leave
        as it is; bfloat16 comes back as float32 (numpy has no bfloat16
        of its own)."""
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        elif d.device.type == "cpu":
            d = d.clone()
        return d.cpu().numpy()

    def item(self, *args) -> Any:
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def astype(self, dt) -> "Tensor":
        from .. import ops
        return ops.cast(self, dt)

    cast = astype

    def clone(self) -> "Tensor":
        from .. import ops
        return ops.assign(self)

    def detach(self) -> "Tensor":
        return Tensor(self._data.detach(), stop_gradient=True, name=self.name)

    def numel(self) -> int:
        return self.size

    # ---- autograd surface -------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False) -> None:
        from ..autograd import tape
        tape.backward(self, grad_tensor, retain_graph=retain_graph)

    def register_hook(self, hook) -> _HookHandle:
        """hook(grad) runs on the gradient flowing into this tensor
        during `backward()` and `paddle.grad` (a leaf's before it is
        accumulated into `.grad`); a Tensor it returns replaces the
        gradient. torch's engine calls it once on the tensor's summed
        gradient, where the JAX tape calls it on each use's part (a
        recorded divergence, as in Paddle). Returns a handle whose
        `remove()` takes it off."""
        handle = _HookHandle(self, hook)
        self._hooks = self._hooks + (handle,)
        handle._attach()
        return handle

    def retain_grads(self) -> None:
        """Keep `.grad` on a non-leaf (its gradient accumulates there in
        backward, as a leaf's does)."""
        self._retain = True
        if not self._data.is_leaf:
            self._data.retain_grad()

    def _set_data(self, data: torch.Tensor) -> None:
        """`data` becomes this Tensor's torch tensor (an in-place op's
        result): hooks and retain_grads move along."""
        for h in self._hooks:
            h._detach()
        self._data = data
        for h in self._hooks:
            h._attach()
        if self._retain and not data.is_leaf:
            data.retain_grad()

    @property
    def inplace_version(self) -> int:
        """The number of in-place writes to this tensor."""
        return self._version

    def clear_grad(self) -> None:
        self._data.grad = None

    clear_gradient = clear_grad

    # ---- python protocol --------------------------------------------------
    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __bool__(self) -> bool:
        return bool(self._data.item())

    def __int__(self) -> int:
        return int(self._data.item())

    def __float__(self) -> float:
        return float(self._data.item())

    def __repr__(self) -> str:
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        name = str(self.dtype).replace("torch.", "")
        return (f"Tensor(shape={self.shape}, dtype={name}, "
                f"place={self.place}{grad_info},\n       {self.numpy()})")

    def __hash__(self):
        return id(self)

    def __getitem__(self, idx) -> "Tensor":
        from .. import ops
        return ops.getitem(self, idx)

    def __setitem__(self, idx, value) -> None:
        from .. import ops
        ops.setitem_(self, idx, value)

    # ---- in-place helpers -------------------------------------------------
    def set_value(self, value) -> "Tensor":
        """Write `value` (a Tensor, numpy array or array-like of this
        shape) into this tensor's storage, cast to its dtype."""
        if isinstance(value, Tensor):
            v = value._data
        elif isinstance(value, torch.Tensor):
            v = value
        else:
            v = _from_numpy(np.asarray(value), self._data.device)
        if tuple(v.shape) != tuple(self._data.shape):
            raise ValueError(
                f"set_value shape mismatch: {tuple(v.shape)} vs "
                f"{tuple(self._data.shape)}")
        with torch.no_grad():
            self._data.copy_(v.to(self._data.device, self._data.dtype))
        return self


class Parameter(Tensor):
    """Trainable tensor — paddle.base.framework.EagerParamBase parity."""

    __slots__ = ("optimize_attr", "need_clip")

    def __init__(self, data, name: Optional[str] = None,
                 trainable: bool = True):
        super().__init__(data, stop_gradient=not trainable, name=name)
        self.optimize_attr = {"learning_rate": 1.0}
        self.need_clip = True

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """paddle.to_tensor parity: python floats → the default float dtype,
    python ints → int64; on the current place unless `place` is given."""
    dev = None
    if place is not None:
        dev = place.torch_device if isinstance(place, Place) else \
            _place_device(place)
    if isinstance(data, Tensor):
        data = data._data
    if isinstance(data, torch.Tensor):
        arr = data.detach().clone()
        if dtype is not None:
            arr = arr.to(dtypes.convert_dtype(dtype))
        return Tensor(arr if dev is None else arr.to(dev),
                      stop_gradient=stop_gradient)
    dev = _device() if dev is None else dev
    npv = np.asarray(data)
    if dtype is not None:
        arr = _from_numpy(npv, dev).to(dtypes.convert_dtype(dtype))
    elif npv.dtype == np.float64 and not isinstance(data, np.ndarray):
        # python floats / float lists default to the paddle default dtype
        arr = _from_numpy(npv, dev).to(dtypes.get_default_dtype())
    else:
        arr = _from_numpy(npv, dev)
    return Tensor(arr, stop_gradient=stop_gradient)


def _place_device(place) -> torch.device:
    name, _, idx = str(place).partition(":")
    if name.lower() == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(idx) if idx else 0)
