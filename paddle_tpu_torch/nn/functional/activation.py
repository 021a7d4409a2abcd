"""Activation functionals — port of paddle_tpu/nn/functional/activation.py
(relu, gelu, silu, swish, tanh, log_softmax)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops._registry import defop

relu = defop("relu", lambda x, name=None: torch.relu(x))


def _gelu_raw(x, approximate=False, name=None):
    # jax.nn.gelu: approximate=True is the tanh form, False the exact erf
    return TF.gelu(x, approximate="tanh" if approximate else "none")


gelu = defop("gelu", _gelu_raw)
silu = defop("silu", lambda x, name=None: TF.silu(x))
swish = defop("swish", lambda x, name=None: TF.silu(x))
tanh = defop("f_tanh", lambda x, name=None: torch.tanh(x))


log_softmax = defop("log_softmax", lambda x, axis=-1, dtype=None, name=None:
                    torch.log_softmax(x, dim=axis))
