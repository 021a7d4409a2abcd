"""Normalization functionals — port of paddle_tpu/nn/functional/norm.py
(:28, :49, :84, :143, :158, :191, :206), the whole file: the plain
layer_norm and rms_norm, batch_norm, group_norm, instance_norm,
local_response_norm and spectral_norm. The fused-backward LayerNorm
kernels run through incubate.nn.functional.fused_layer_norm, as in the
JAX package.

batch_norm goes to `torch.nn.functional.batch_norm` (cuDNN on the card;
XLA fuses the JAX package's jnp expression): it normalizes with the
biased batch variance and, in training, updates the running statistics
in place with the unbiased one, outside autograd, as the JAX package's
`_rebind` does (:118). Paddle's `momentum` weighs the old statistic
(0.9), torch's the new one, so the call passes 1 - momentum. Under AMP
O1 `batch_norm` is a black-list op: its inputs arrive in f32 and the
statistics are computed in f32 (the JAX package takes its running
statistics from the bf16 input; a recorded divergence).

Dtypes are the JAX package's (`_batch_norm_raw`, `_group_norm_raw` and
`instance_norm` there compute in jnp, where the weight, the bias and, in
eval, the running statistics promote the input): the output has the
promoted dtype of x, the weight and bias given, and the running
statistics where they are read. A bf16 input with f32 weights gives f32;
without a weight, BatchNorm gives bf16 in training and f32 in eval. The
torch call runs in that dtype: a cast is launched only where the dtypes
differ.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor
from ...ops._registry import as_array, eager
from .activation import _inexact


def _layer_norm_raw(x, weight, bias, epsilon, begin_norm_axis):
    x = _inexact(x)
    axes = tuple(range(begin_norm_axis, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = -len(tuple(normalized_shape))
    args = [x]
    if weight is not None:
        args.append(weight)
    if bias is not None:
        args.append(bias)

    def raw(*a):
        w = a[1] if weight is not None else None
        b = a[-1] if bias is not None else None
        return _layer_norm_raw(a[0], w, b, epsilon, a[0].ndim + begin)

    return eager(raw, tuple(args), {}, name="layer_norm")


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """Plain RMSNorm (`kernels.rms_norm.rms_norm_ref`), as the JAX
    package's nn.functional runs it."""
    from ...kernels.rms_norm import rms_norm_ref

    args = [x] if weight is None else [x, weight]

    def raw(*a):
        return rms_norm_ref(a[0], a[1] if len(a) > 1 else None, epsilon)

    return eager(raw, tuple(args), {}, name="rms_norm")


def _channel_axis(data_format, ndim):
    return 1 if data_format.startswith("NC") else ndim - 1


def _promoted(*ts):
    """The tensors (None kept) cast to their promoted dtype: the dtype
    of the JAX package's jnp expression over them."""
    dt = None
    for t in ts:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in ts]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    use_batch_stats = training and not (use_global_stats is True)
    update = use_batch_stats and isinstance(running_mean, Tensor)
    rm = as_array(running_mean) if not use_batch_stats or update else None
    rv = as_array(running_var) if not use_batch_stats or update else None
    args = [x]
    if weight is not None:
        args.append(weight)
    if bias is not None:
        args.append(bias)

    def raw(*a):
        xx = a[0]
        w = a[1] if weight is not None else None
        b = a[-1] if bias is not None else None
        c_axis = _channel_axis(data_format, xx.ndim)
        if c_axis != 1:
            xx = xx.movedim(c_axis, 1)
        # torch computes in one dtype: the promoted one of x, the affine
        # and the statistics; the output takes the JAX dtype, where the
        # statistics promote only when they are read (eval)
        odt = (_promoted(xx, w, b) if use_batch_stats else
               _promoted(xx, w, b, rm))[0].dtype
        xx, w, b, rmc, rvc = _promoted(xx, w, b, rm, rv)
        out = TF.batch_norm(xx, rmc, rvc, w, b, training=use_batch_stats,
                            momentum=1.0 - momentum, eps=epsilon)
        if update and rmc is not rm:
            rm.copy_(rmc)
            rv.copy_(rvc)
        out = out.to(odt)
        return out.movedim(1, c_axis) if c_axis != 1 else out

    return eager(raw, tuple(args), {}, name="batch_norm")


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    args = [x]
    if weight is not None:
        args.append(weight)
    if bias is not None:
        args.append(bias)

    def raw(*a):
        xx = a[0]
        w = a[1] if weight is not None else None
        b = a[-1] if bias is not None else None
        c_axis = _channel_axis(data_format, xx.ndim)
        if c_axis != 1:
            xx = xx.movedim(c_axis, 1)
        xx, w, b = _promoted(xx, w, b)
        out = TF.group_norm(xx, num_groups, w, b, epsilon)
        return out.movedim(1, c_axis) if c_axis != 1 else out

    return eager(raw, tuple(args), {}, name="group_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) plane normalized by its own statistics; the
    running statistics are accepted and, as in the JAX package, unused."""
    args = [x]
    if weight is not None:
        args.append(weight)
    if bias is not None:
        args.append(bias)

    def raw(*a):
        w = a[1] if weight is not None else None
        b = a[-1] if bias is not None else None
        xx, w, b = _promoted(a[0], w, b)
        return TF.instance_norm(xx, weight=w, bias=b, eps=eps)

    return eager(raw, tuple(args), {}, name="instance_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + α/size · Σ x² over `size` neighbouring channels)^β, the
    window centred (size // 2 before), zero outside; channels on axis 1,
    as the JAX package reads them whatever `data_format` says."""

    def raw(a):
        sq = torch.square(a)
        half = size // 2
        c = a.shape[1]
        pads = [0, 0] * (a.ndim - 2) + [half, size - 1 - half]
        sqp = TF.pad(sq, pads)
        win = sum(sqp.narrow(1, i, c) for i in range(size))
        return a / torch.pow(k + alpha * win / size, beta)

    return eager(raw, (x,), {}, name="local_response_norm")


def spectral_norm(weight, axis=0, power_iters=1, epsilon=1e-12, u=None,
                  name=None):
    """weight / σ_max, σ estimated by power iteration in f32 from `u`
    (the SpectralNorm layer's persistent buffer) or, without it, from
    the normalized ones vector. Returns the weight, or (weight, the new
    u) when u is given."""

    def raw(w, u0=None):
        h = w.shape[axis]
        mat = w.movedim(axis, 0).reshape(h, -1).to(torch.float32)
        if u0 is None:
            uv = torch.ones(h, dtype=torch.float32, device=w.device) / \
                (h ** 0.5)
        else:
            # a copy: the caller writes the new u into u0's storage
            uv = u0.reshape(h).to(torch.float32, copy=True)
        for _ in range(max(power_iters, 1)):
            v = mat.T @ uv
            v = v / (torch.linalg.vector_norm(v) + epsilon)
            uv = mat @ v
            uv = uv / (torch.linalg.vector_norm(uv) + epsilon)
        sigma = uv @ mat @ v
        return (w / torch.clamp(sigma, min=epsilon)).to(w.dtype), \
            uv.to(w.dtype)

    args = (weight,) if u is None else (weight, u)
    out, u_new = eager(raw, args, {}, name="spectral_norm")
    return (out, u_new) if u is not None else out
