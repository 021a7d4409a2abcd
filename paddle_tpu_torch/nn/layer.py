"""nn.Layer — the module base class.

Port of paddle_tpu/nn/layer.py: parameters are eager Parameters (torch
tensors that require grad); `named_parameters` walks the same
composition in the same order as the JAX package, so the same layers give
the same structured names, and `set_state_dict` takes the dict of numpy
arrays a JAX model's `state_dict()` gives (or Tensors). Buffers (JAX
`nn/layer.py:155-215`: BatchNorm's `_mean` and `_variance`) sit in
`state_dict` after the parameters under the JAX package's names.
`Layer.to` casts (and moves) the parameters and buffers of a built model
by rebinding each tensor's storage, so the Parameter objects, and with
them an optimizer's list and state, stay the same; `float`, `half`,
`bfloat16` and `astype` are its dtype forms, as in the JAX package
(`paddle_tpu/nn/layer.py:197-300`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.tensor import Tensor, Parameter
from ..core import dtype as dtypes
from . import initializer as I


class ParamAttr:
    """paddle.ParamAttr parity: bundles name/initializer/lr/trainable."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        return ParamAttr()


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        # object.__setattr__: our __setattr__ consults these dicts
        object.__setattr__(self, "_parameters", OrderedDict())
        object.__setattr__(self, "_sub_layers", OrderedDict())
        object.__setattr__(self, "_buffers", OrderedDict())
        object.__setattr__(self, "_non_persistable_buffer_names", set())
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._hook_id = 0

    # ---- attribute routing -------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        bufs = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning parameters")
            params[name] = value
            subs.pop(name, None)
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if subs is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning sublayers")
            subs[name] = value
            params.pop(name, None)
            self.__dict__.pop(name, None)
        elif bufs is not None and name in bufs:
            bufs[name] = value
        elif params is not None and name in params:
            if value is None:
                del params[name]
                self.__dict__[name] = None
            elif isinstance(value, Tensor):
                params[name].set_value(value)
            else:
                raise TypeError(
                    f"cannot assign {type(value)} to parameter {name}")
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{self.__class__.__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # ---- construction helpers ---------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[Parameter]:
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtypes.convert_dtype(dtype or self._dtype)
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        data = init(tuple(int(s) for s in shape), dtype)
        p = Parameter(data, name=attr.name, trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        if parameter is None:
            self._parameters.pop(name, None)
            self.__dict__[name] = None
        else:
            self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor],
                        persistable: bool = True):
        """A tensor the layer keeps and no optimizer updates (BatchNorm's
        running statistics); persistable buffers go into `state_dict`."""
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ---- iteration ---------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True
                         ) -> Iterator[Tuple[str, Parameter]]:
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{name}.{pname}" if name else pname), p
            if not include_sublayers:
                break

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None
                        ) -> Iterator[Tuple[str, "Layer"]]:
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from sub.named_sublayers(prefix=sub_prefix,
                                           include_self=True,
                                           layers_set=layers_set)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def children(self):
        return [l for l in self._sub_layers.values() if l is not None]

    def named_children(self):
        return [(n, l) for n, l in self._sub_layers.items() if l is not None]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{name}.{bname}" if name else bname), b
            if not include_sublayers:
                break

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    # ---- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        out = destination if destination is not None else OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(prefix=prefix):
            out[name] = p
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistable_buffer_names:
                    continue
                out[f"{name}.{bname}" if name else bname] = b
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load Tensors or numpy arrays by structured name (a JAX model's
        `{k: v.numpy() for k, v in state_dict().items()}` moves across
        unchanged); returns (missing, unexpected) names."""
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt = own[k]
            shape = tuple(v.shape) if isinstance(v, Tensor) else \
                np.shape(v)
            if tuple(shape) != tuple(tgt._data.shape):
                raise ValueError(
                    f"shape mismatch for {k}: loaded {tuple(shape)} vs "
                    f"{tuple(tgt._data.shape)}")
            tgt.set_value(v)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ---- mode / dtype / device ---------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    def apply(self, fn: Callable):
        """fn(layer) for this layer and then every sublayer, in the JAX
        package's order (pre-order)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Cast the floating parameters and buffers to `dtype` and/or
        move every parameter and buffer to `device` (a place or its
        name); each Tensor keeps its identity and its leaf state."""
        dev = None
        if device is not None:
            from ..core.device import Place
            from ..core.tensor import _place_device
            dev = device.torch_device if isinstance(device, Place) else \
                _place_device(device)
        d = None if dtype is None else dtypes.convert_dtype(dtype)
        tensors = list(self.parameters()) + list(self.buffers())
        for t in tensors:
            cast = d is not None and t._data.is_floating_point() \
                and t._data.dtype != d
            if cast or (dev is not None and t._data.device != dev):
                _rebind_leaf(t, t._data.to(device=dev, dtype=d if cast
                                           else None))
        if d is not None:
            for layer in self.sublayers(include_self=True):
                layer._dtype = d
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def half(self):
        return self.to(dtype="float16")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # ---- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        hid = self._hook_id
        self._hook_id += 1
        self._forward_pre_hooks[hid] = hook
        return _HookRemover(self._forward_pre_hooks, hid)

    def register_forward_post_hook(self, hook):
        hid = self._hook_id
        self._hook_id += 1
        self._forward_post_hooks[hid] = hook
        return _HookRemover(self._forward_post_hooks, hid)

    # ---- call ---------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError(
            f"{self.__class__.__name__} must implement forward()")

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        out = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, out)
            if result is not None:
                out = result
        return out

    # ---- repr ---------------------------------------------------------------
    def extra_repr(self) -> str:
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split("\n")
            sub_repr = [sub_repr[0]] + ["  " + l for l in sub_repr[1:]]
            lines.append(f"  ({name}): " + "\n".join(sub_repr))
        main = f"{self.__class__.__name__}({extra}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"


def _rebind_leaf(t: Tensor, value: torch.Tensor) -> None:
    """`value` becomes the leaf `t`'s tensor, requiring grad as the old
    one did (the JAX package's `p._data = ...` rebinding); an accumulated
    gradient is dropped."""
    t._data = value.detach().requires_grad_(t._data.requires_grad)


class _HookRemover:
    def __init__(self, store, hid):
        self._store, self._hid = store, hid

    def remove(self):
        self._store.pop(self._hid, None)
