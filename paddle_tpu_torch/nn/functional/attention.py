"""Attention functionals — port of paddle_tpu/nn/functional/attention.py:
`scaled_dot_product_attention` (:15-32), Paddle's functional
`flash_attention` (:35-40) and `flash_attn_unpadded`'s refusal (:43-47). With no mask and dropout_p == 0 the SDPA
runs the port's differentiable flash attention
(`kernels.flash_attention.flash_attention`: the CUDA forward and backward
kernels on the card, their plain versions on the CPU); otherwise the
exact reference `mha_ref`, as the JAX package does: a bool mask hides
scores, a float mask is added to them. Like the JAX package, neither
applies attention dropout."""
from __future__ import annotations

import torch

from ...ops._registry import as_array, eager
from ...kernels.flash_attention import flash_attention as _flash, mha_ref


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """q/k/v: [B, S, H, D] (paddle layout)."""
    if attn_mask is None and dropout_p == 0.0:
        return eager(lambda q, k, v: _flash(q, k, v, causal=is_causal),
                     (query, key, value), {}, name="sdpa")
    mask = None if attn_mask is None else as_array(attn_mask)

    def raw(q, k, v):
        bias = m = None
        if mask is not None:
            if mask.dtype == torch.bool:
                m = mask.to(q.device)
            else:
                bias = mask.to(q.device)
        return mha_ref(q, k, v, causal=is_causal, bias=bias, mask=m)

    return eager(raw, (query, key, value), {}, name="sdpa")


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """q [B, S, H, D], k/v [B, S, KV, D] (GQA unexpanded) → (out, None):
    the softmax is never materialized."""
    out = eager(lambda q, k, v: _flash(q, k, v, causal=causal),
                (query, key, value), {}, name="flash_attention")
    return out, None


def flash_attn_unpadded(*args, **kwargs):
    """Refused, as in the JAX package (paddle_tpu/nn/functional/
    attention.py:43-47): ragged batches are padded and masked instead."""
    raise NotImplementedError(
        "flash_attn_unpadded (varlen) is not supported: pad ragged "
        "batches and pass an attention mask instead")
