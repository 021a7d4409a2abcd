"""Parameter initializers — port of paddle_tpu/nn/initializer.py
(Constant, Normal, Uniform, the Xavier pair the layers default to and
the Kaiming pair the convolutions use).
Each draws from the seeded generator of the current place's device
(core/random.py) and returns a torch tensor there."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import random as prandom
from ..core.device import _device


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *k] (paddle OIHW)
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.convert_dtype(dtype), device=_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        dev = _device()
        r = torch.randn(tuple(shape), dtype=torch.float32, device=dev,
                        generator=prandom.default_generator(dev))
        return (r * self.std + self.mean).to(dtypes.convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        dev = _device()
        r = torch.rand(tuple(shape), dtype=torch.float32, device=dev,
                       generator=prandom.default_generator(dev))
        return (r * (self.high - self.low) + self.low).to(
            dtypes.convert_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype)


def _kaiming_gain(nonlinearity, slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.slope) / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.slope) * \
            math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)
