"""paddle.incubate.nn.functional — the fused ops of the eager path.

Port of paddle_tpu/incubate/nn/functional/__init__.py: `fused_rms_norm`
(:37-49, the row-6 RMSNorm kernel of kernels/rms_norm.py),
`fused_layer_norm` (:52-65, the fused-backward LayerNorm kernels of
kernels/layer_norm.py), `fused_rotary_position_embedding` (:68-102, plain
torch as XLA in the reference), `swiglu` (:156-166), `fused_dropout_add`
(:255-273), `fused_matmul_bias` (:169) and `fused_linear` (:187).
`fused_multi_transformer` and the other fused ops arrive with the rest of
the eager API.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ....ops._registry import as_array, eager
from ....core import random as prandom
from ....kernels import rope as _rope

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "swiglu", "fused_dropout_add",
           "fused_matmul_bias", "fused_linear"]


def _check_last_axis(x, begin_norm_axis, op):
    ndim = len(x.shape)
    if begin_norm_axis not in (-1, ndim - 1):
        raise NotImplementedError(
            f"{op}: begin_norm_axis={begin_norm_axis} (multi-axis "
            "normalization) not supported — flatten trailing dims first")


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kwargs):
    """Last-axis RMSNorm through `kernels.rms_norm.rms_norm_fused_train`:
    the row-6 kernel forward on the card, the plain version on the CPU;
    the backward is the plain version's vjp. Under O1 it follows its
    input's dtype (it is on neither AMP list)."""
    _check_last_axis(x, begin_norm_axis, "fused_rms_norm")
    from ....kernels.rms_norm import rms_norm_fused_train

    def raw(xa, w, b):
        out = rms_norm_fused_train(xa, w, epsilon)
        if b is not None:
            out = out + b.to(out.dtype)
        return out

    return eager(raw, (x, norm_weight, norm_bias), {},
                 name="fused_rms_norm")


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, **kwargs):
    """Last-axis LayerNorm through `kernels.layer_norm.layer_norm_train`:
    the forward kernel saves (mu, rstd), the backward kernel gives dx and
    the summed d_weight/d_bias; the plain versions on the CPU."""
    _check_last_axis(x, begin_norm_axis, "fused_layer_norm")
    from ....kernels.layer_norm import layer_norm_train

    def raw(xa, wa, ba):
        return layer_norm_train(xa, wa, ba, epsilon)

    return eager(raw, (x, norm_weight, norm_bias), {},
                 name="fused_layer_norm")


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y + bias in one op (cuBLAS takes the product; the bias add is
    a plain torch op, as XLA fused it in the JAX package)."""
    def raw(xa, ya, ba=None):
        if transpose_x:
            xa = xa.transpose(-1, -2)
        if transpose_y:
            ya = ya.transpose(-1, -2)
        out = xa @ ya
        return out if ba is None else out + ba

    args = (x, y) if bias is None else (x, y, bias)
    return eager(raw, args, {}, name="fused_matmul_bias")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight + bias: fused_matmul_bias with the linear-layer
    argument order."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y (phi fused_dropout_add); the keep mask is drawn
    from the seeded generator of x's device."""
    if not training or p == 0.0:
        return eager(lambda a, b: a + b, (x, y), {},
                     name="fused_dropout_add")

    def raw(a, b):
        keep = torch.rand(a.shape, device=a.device,
                          generator=prandom.default_generator(a.device)) \
            < 1.0 - p
        if mode == "upscale_in_train":
            a = torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
        else:
            a = torch.where(keep, a, 0.0).to(a.dtype)
        return a + b

    return eager(raw, (x, y), {}, name="fused_dropout_add")


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, **kwargs):
    """RoPE on q (and k) → (q, k, v) like the reference. sin/cos:
    [max_pos, head_dim(/2)] tables (rows are position-indexed; only the
    first seq rows — or the position_ids rows — are read); built by
    `rope_freqs` (base 10000) when omitted. use_neox_rotary_style picks
    rotate-half against interleaved pairs; position_ids [B, S] serves
    KV-cache decode."""
    pos = None if position_ids is None else as_array(position_ids)

    def raw(qa, ka, s, c):
        seq, hd = qa.shape[1], qa.shape[-1]
        p = None if pos is None else pos.to(qa.device)
        if s is None or c is None:
            max_pos = seq if p is None else int(seq + 1024)
            c2, s2 = _rope.rope_freqs(hd, max_pos, device=qa.device)
        else:
            # keep the table's position axis; rows are picked by seq or
            # position_ids inside apply_rope*
            c2, s2 = c.reshape(c.shape[0], -1), s.reshape(s.shape[0], -1)
        apply = _rope.apply_rope_half if use_neox_rotary_style \
            else _rope.apply_rope
        if ka is None:
            return apply(qa, qa, c2, s2, position_ids=p)[0]
        return apply(qa, ka, c2, s2, position_ids=p)

    if k is None:
        return (eager(raw, (q, None, sin, cos), {}, name="fused_rope"),
                None, v)
    outs = eager(raw, (q, k, sin, cos), {}, name="fused_rope")
    return outs[0], outs[1], v


def swiglu(x, y=None, name=None):
    """silu(x) * y; with y None, x splits in half on the last axis (the
    fused SwiGLU MLP gate)."""
    if y is None:
        def raw(xa):
            a, b = torch.chunk(xa, 2, dim=-1)
            return TF.silu(a) * b
        return eager(raw, (x,), {}, name="swiglu")
    return eager(lambda a, b: TF.silu(a) * b, (x, y), {}, name="swiglu")
