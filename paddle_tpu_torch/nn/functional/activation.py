"""Activation functionals — port of paddle_tpu/nn/functional/activation.py,
the whole file.

Each is the JAX package's expression in torch, op for op, so values and
gradients agree to f32 rounding. An integer or bool input computes in
the default float dtype (`_inexact`) wherever the JAX expression leaves
the integers (F7's family: the JAX package gives float64 for some of
them under `jax_enable_x64`); `relu`, `relu6` and `maxout` keep integers
as the JAX package does. `sigmoid`, `silu`, `swish` and `glu` refuse an
integer input, as `jax.nn.sigmoid` does. `rrelu` and `gumbel_softmax`
draw from the port's per-device generators (`core.random`), so their
draws differ from the JAX package's (the "sampling draws from torch
generators" family); in eval mode `rrelu` is exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dtype import convert_dtype, get_default_dtype
from ...core import random as prandom
from ...ops._registry import defop, eager


def _inexact(x):
    """An integer or bool input in the default float dtype: jax.nn's
    gelu and log_softmax compute integers in a float dtype (float64 for
    int64 under x64 in the JAX package, F7's divergence), torch has no
    integer kernel for them."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(get_default_dtype())


def _float_only(x, name):
    """jax.nn.sigmoid refuses integer and bool arrays (TypeError); so do
    the functions built on it."""
    if not (x.is_floating_point() or x.is_complex()):
        raise TypeError(f"{name} takes a floating-point tensor, "
                        f"not {x.dtype}")
    return x


relu = defop("relu", lambda x, name=None: torch.relu(x))


def _relu6_raw(x, name=None):
    # jnp.clip(bool, 0, 6) promotes to int64 in the JAX package
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    return torch.clamp(x, 0, 6)


relu6 = defop("relu6", _relu6_raw)


def _gelu_raw(x, approximate=False, name=None):
    # jax.nn.gelu: approximate=True is the tanh form, False the exact erf
    return TF.gelu(_inexact(x), approximate="tanh" if approximate else "none")


gelu = defop("gelu", _gelu_raw)
silu = defop("silu", lambda x, name=None: TF.silu(_float_only(x, "silu")))
swish = defop("swish", lambda x, name=None: TF.silu(_float_only(x, "swish")))


def _elu_raw(x, alpha=1.0, name=None):
    # jax.nn.elu: the negative branch's argument clamped, so a large x
    # gives no inf in the branch it does not take
    x = _inexact(x)
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(x > 0, 0.0,
                                                                 x)))


elu = defop("elu", _elu_raw)


def _selu_raw(x, scale=1.0507009873554804934193349852946,
              alpha=1.6732632423543772848170429916717, name=None):
    x = _inexact(x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


selu = defop("selu", _selu_raw)


def _celu_raw(x, alpha=1.0, name=None):
    x = _inexact(x)
    return torch.clamp(x, min=0) + alpha * torch.expm1(
        torch.clamp(x, max=0) / alpha)


celu = defop("celu", _celu_raw)


def _leaky_relu_raw(x, negative_slope=0.01, name=None):
    x = _inexact(x)
    return torch.where(x >= 0, x, negative_slope * x)


leaky_relu = defop("leaky_relu", _leaky_relu_raw)


def _prelu_raw(x, weight, data_format="NCHW", name=None):
    """The slope is one value, or one a channel (axis 1 for NC...,
    the last axis for N...C); the weight is differentiable."""
    x = _inexact(x)
    if weight.numel() == 1:
        slope = weight.reshape(())
    else:
        shape = [1] * x.ndim
        axis = 1 if data_format[1] == "C" else x.ndim - 1
        shape[axis] = weight.numel()
        slope = weight.reshape(shape)
    return torch.where(x >= 0, x, slope * x)


prelu = defop("prelu", _prelu_raw)


def rrelu(x, lower=1. / 8., upper=1. / 3., training=True, name=None):
    """In training a slope a element ~ U(lower, upper), drawn in f32 from
    the device's generator and cast to x's dtype; in eval the mean slope
    (lower + upper) / 2."""

    def raw(a):
        a = _inexact(a)
        if training:
            u = torch.rand(a.shape, device=a.device, dtype=torch.float32,
                           generator=prandom.default_generator(a.device))
            slope = (lower + (upper - lower) * u).to(a.dtype)
        else:
            slope = (lower + upper) / 2
        return torch.where(a >= 0, a, a * slope)

    return eager(raw, (x,), {}, name="rrelu")


def _hardshrink_raw(x, threshold=0.5, name=None):
    x = _inexact(x)
    return torch.where(torch.abs(x) > threshold, x, 0.0)


hardshrink = defop("hardshrink", _hardshrink_raw)


def _softshrink_raw(x, threshold=0.5, name=None):
    x = _inexact(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


softshrink = defop("softshrink", _softshrink_raw)
tanhshrink = defop("tanhshrink", lambda x, name=None:
                   _inexact(x) - torch.tanh(_inexact(x)))
hardtanh = defop("hardtanh", lambda x, min=-1.0, max=1.0, name=None:
                 torch.clamp(_inexact(x), min, max))


def _hardsigmoid_raw(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(_inexact(x) * slope + offset, 0.0, 1.0)


hardsigmoid = defop("hardsigmoid", _hardsigmoid_raw)


def _hardswish_raw(x, name=None):
    x = _inexact(x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


hardswish = defop("hardswish", _hardswish_raw)


def _softplus0(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


mish = defop("mish", lambda x, name=None:
             _inexact(x) * torch.tanh(_softplus0(_inexact(x))))


def _softplus_raw(x, beta=1.0, threshold=20.0, name=None):
    x = _inexact(x)
    return torch.where(x * beta > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


softplus = defop("softplus", _softplus_raw)
softsign = defop("softsign", lambda x, name=None:
                 _inexact(x) / (1 + torch.abs(_inexact(x))))


def _log_sigmoid_raw(x, name=None):
    if x.dtype == torch.bool:
        # jax.nn.log_sigmoid negates its input, which refuses a bool
        raise TypeError("log_sigmoid does not accept a bool tensor")
    x = _inexact(x)
    return -_softplus0(-x)


log_sigmoid = defop("log_sigmoid", _log_sigmoid_raw)
tanh = defop("f_tanh", lambda x, name=None: torch.tanh(x))
sigmoid = defop("f_sigmoid", lambda x, name=None:
                torch.sigmoid(_float_only(x, "sigmoid")))


def _softmax_raw(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    if x.dtype == torch.bool:
        raise TypeError("softmax does not accept a bool tensor")
    return torch.softmax(_inexact(x), dim=axis)


softmax = defop("softmax", _softmax_raw)


def _log_softmax_raw(x, axis=-1, dtype=None, name=None):
    if x.dtype == torch.bool:
        # as jax.nn.log_softmax, whose x - max(x) refuses bool
        raise TypeError("log_softmax does not accept a bool tensor")
    return torch.log_softmax(_inexact(x), dim=axis)


log_softmax = defop("log_softmax", _log_softmax_raw)


def _gumbel_softmax_raw(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g ~ Gumbel(0, 1) from the
    device's generator; `hard` gives the one-hot of the argmax with the
    soft sample's gradient (straight-through)."""
    x = _float_only(x, "gumbel_softmax")
    u = torch.rand(x.shape, device=x.device, dtype=x.dtype,
                   generator=prandom.default_generator(x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        one_hot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (one_hot - y).detach() + y
    return y


gumbel_softmax = defop("gumbel_softmax", _gumbel_softmax_raw)


def _glu_raw(x, axis=-1, name=None):
    a, b = torch.chunk(_float_only(x, "glu"), 2, dim=axis)
    return a * torch.sigmoid(b)


glu = defop("glu", _glu_raw)


def _maxout_raw(x, groups, axis=1, name=None):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


maxout = defop("maxout", _maxout_raw)
thresholded_relu = defop("thresholded_relu", lambda x, threshold=1.0,
                         name=None: torch.where(_inexact(x) > threshold,
                                                _inexact(x), 0.0))
