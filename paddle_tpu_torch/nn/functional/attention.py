"""Attention functionals — port of paddle_tpu/nn/functional/attention.py
(:15-32, scaled_dot_product_attention). With no mask and dropout_p == 0
it runs the port's differentiable flash attention
(`kernels.flash_attention.flash_attention`: the CUDA forward and backward
kernels on the card, their plain versions on the CPU); otherwise the
exact reference `mha_ref`, as the JAX package does (which, like it,
applies no attention dropout)."""
from __future__ import annotations

import torch

from ...ops._registry import as_array, eager
from ...kernels.flash_attention import flash_attention, mha_ref


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """q/k/v: [B, S, H, D] (paddle layout)."""
    if attn_mask is None and dropout_p == 0.0:
        return eager(lambda q, k, v: flash_attention(q, k, v,
                                                     causal=is_causal),
                     (query, key, value), {}, name="sdpa")
    mask = None if attn_mask is None else as_array(attn_mask)
    if mask is not None and mask.dtype != torch.bool:
        raise NotImplementedError(
            "scaled_dot_product_attention: an additive (float) mask arrives "
            "with the ERNIE slice (nlp/ernie.py); pass a bool mask")

    def raw(q, k, v):
        return mha_ref(q, k, v, causal=is_causal,
                       mask=None if mask is None else mask.to(q.device))

    return eager(raw, (query, key, value), {}, name="sdpa")
