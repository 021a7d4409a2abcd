"""Activation functionals — port of paddle_tpu/nn/functional/activation.py
(relu, gelu, silu, swish, tanh, log_softmax)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dtype import get_default_dtype
from ...ops._registry import defop


def _inexact(x):
    """An integer or bool input in the default float dtype: jax.nn's
    gelu and log_softmax compute integers in a float dtype (float64 for
    int64 under x64 in the JAX package, F7's divergence), torch has no
    integer kernel for them."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(get_default_dtype())


relu = defop("relu", lambda x, name=None: torch.relu(x))


def _gelu_raw(x, approximate=False, name=None):
    # jax.nn.gelu: approximate=True is the tanh form, False the exact erf
    return TF.gelu(_inexact(x), approximate="tanh" if approximate else "none")


gelu = defop("gelu", _gelu_raw)
silu = defop("silu", lambda x, name=None: TF.silu(x))
swish = defop("swish", lambda x, name=None: TF.silu(x))
tanh = defop("f_tanh", lambda x, name=None: torch.tanh(x))


def _log_softmax_raw(x, axis=-1, dtype=None, name=None):
    if x.dtype == torch.bool:
        # as jax.nn.log_softmax, whose x - max(x) refuses bool
        raise TypeError("log_softmax does not accept a bool tensor")
    return torch.log_softmax(_inexact(x), dim=axis)


log_softmax = defop("log_softmax", _log_softmax_raw)
