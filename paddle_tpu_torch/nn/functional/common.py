"""Common functionals — port of paddle_tpu/nn/functional/common.py, the
whole file (`one_hot` and `pad` are the ops of `ops.creation` and
`ops.manipulation`, as in the JAX package).

The random ones (dropout, dropout2d/3d, alpha_dropout) draw their masks
from the port's per-device generators (`core.random`): the draws differ
from the JAX package's, eval mode is exact. `interpolate` follows
Paddle's documented modes (see `_interpolate_raw`)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dtype import convert_dtype
from ...ops._registry import as_array, defop, eager
from ...ops.math import _promote
from ...core.tensor import Tensor
from ...core import random as prandom
from .activation import _inexact


def _linear_raw(x, weight, bias=None, name=None):
    # paddle weight layout is [in_features, out_features]: x @ w, in the
    # operands' promoted dtype, as jnp.matmul computes it
    out = torch.matmul(*_promote(x, weight))
    if bias is not None:
        out = out + bias
    return out


def linear(x, weight, bias=None, name=None):
    if bias is None:
        return eager(_linear_raw, (x, weight), {}, name="linear")
    return eager(_linear_raw, (x, weight, bias), {}, name="linear")


def _keep_mask(shape, keep, device):
    """Bernoulli(keep) mask drawn from the device's seeded generator."""
    u = torch.rand(shape, device=device,
                   generator=prandom.default_generator(device))
    return u < keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else Tensor(x)
    keep = 1.0 - p
    if keep == 0.0 and axis is None:
        # every element dropped: zeros, as `_dropout_raw` gives
        # (paddle_tpu/nn/functional/common.py:30-37); with `axis` the JAX
        # package divides by keep and raises, and so does this
        return eager(lambda a: a * 0, (x,), {}, name="dropout")
    scale = 1.0 / keep if mode == "upscale_in_train" else 1.0
    axes = None if axis is None else \
        ([axis] if isinstance(axis, int) else list(axis))

    def raw(a):
        # with `axis`, the mask is broadcast along the other axes
        shape = a.shape if axes is None else \
            [a.shape[i] if i in axes else 1 for i in range(a.ndim)]
        mask = _keep_mask(tuple(shape), keep, a.device)
        return torch.where(mask, a * scale, 0.0).to(a.dtype)

    return eager(raw, (x,), {}, name="dropout")


def _embedding_raw(x, weight, padding_idx=None):
    out = weight[x.to(weight.device)]
    if padding_idx is not None:
        mask = (x != padding_idx)[..., None].to(weight.device)
        out = out * mask.to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    idx = as_array(x)
    return eager(lambda w: _embedding_raw(idx, w, padding_idx), (weight,),
                 {}, name="embedding")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: the mask spans the batch and channel axes
    and is broadcast over the spatial ones."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout that keeps SELU's mean and variance: a dropped element
    takes SELU's negative saturation value, then an affine map restores
    the moments (paddle_tpu/nn/functional/common.py:67)."""
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else Tensor(x)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE

    def raw(a):
        keep = 1.0 - p
        mask = _keep_mask(a.shape, keep, a.device)
        A = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        B = -A * alpha_p * (1 - keep)
        return (A * torch.where(mask, a, alpha_p) + B).to(a.dtype)

    return eager(raw, (x,), {}, name="alpha_dropout")


def _normalize_raw(x, p=2, axis=1, epsilon=1e-12, name=None):
    x = _inexact(x)
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=True), 1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


normalize = defop("normalize", _normalize_raw)


def _cos_sim_raw(x1, x2, axis=1, eps=1e-8, name=None):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


cosine_similarity = defop("cosine_similarity", _cos_sim_raw)


def _src_index(out_n, in_n, mode, align_corners, align_mode, scale):
    """Paddle's source coordinate of each output position along one
    axis: `ratio` is (in-1)/(out-1) with align_corners, else in/out (or
    1/scale_factor when one was given)."""
    dst = torch.arange(out_n, dtype=torch.float32)
    if align_corners:
        ratio = (in_n - 1) / (out_n - 1) if out_n > 1 else 0.0
    else:
        ratio = 1.0 / scale if scale else in_n / out_n
    if mode == "nearest":
        src = dst * ratio + 0.5 if align_corners else dst * ratio
        return torch.clamp(torch.floor(src), max=in_n - 1).to(torch.int64)
    if align_corners or align_mode == 1:
        return torch.clamp(dst * ratio, max=in_n - 1)
    return torch.clamp((dst + 0.5) * ratio - 0.5, min=0.0, max=in_n - 1)


def _resample_axis(x, axis, out_n, mode, align_corners, align_mode, scale):
    src = _src_index(out_n, x.shape[axis], mode, align_corners, align_mode,
                     scale).to(x.device)
    if mode == "nearest":
        return x.index_select(axis, src)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=x.shape[axis] - 1)
    shape = [1] * x.ndim
    shape[axis] = out_n
    w = (src - i0).to(x.dtype).reshape(shape)
    return x.index_select(axis, i0) * (1 - w) + x.index_select(axis, i1) * w


def _interpolate_raw(x, size=None, scale_factor=None, mode="nearest",
                     align_corners=False, align_mode=0, data_format="NCHW",
                     name=None):
    """Paddle's documented modes: nearest and (bi/tri)linear with
    align_corners and align_mode, bicubic (torch's a = -0.75, Paddle's
    kernel) and area (adaptive average pooling). The JAX package's
    `jax.image.resize` ignores align_corners and align_mode, maps area
    to linear and antialiases when it downsamples: a recorded
    divergence; the two agree when upsampling with align_corners=False
    in nearest and linear modes."""
    chan_last = data_format in ("NHWC", "NWC", "NDHWC")
    if chan_last:
        x = x.movedim(-1, 1)
    x = _inexact(x)
    spatial = tuple(x.shape[2:])
    scales = [None] * len(spatial)
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        scales = [float(f) for f in scale_factor]
        size = tuple(int(s * f) for s, f in zip(spatial, scales))
    else:
        if isinstance(size, Tensor):
            size = size.numpy().tolist()
        size = tuple(int(v.item()) if isinstance(v, Tensor) else int(v)
                     for v in size)
    if mode in ("bicubic", "area"):
        out = TF.interpolate(x, size=size, mode=mode,
                             align_corners=align_corners
                             if mode == "bicubic" else None)
    elif mode in ("nearest", "linear", "bilinear", "trilinear"):
        kind = "nearest" if mode == "nearest" else "linear"
        out = x
        for i, n in enumerate(size):
            out = _resample_axis(out, 2 + i, n, kind, align_corners,
                                 align_mode, scales[i])
    else:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    return out.movedim(1, -1) if chan_last else out


interpolate = defop("interpolate", _interpolate_raw)
upsample = interpolate


def _pixel_shuffle_raw(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


pixel_shuffle = defop("pixel_shuffle", _pixel_shuffle_raw)


def _pixel_unshuffle_raw(x, downscale_factor, data_format="NCHW",
                         name=None):
    r = downscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


pixel_unshuffle = defop("pixel_unshuffle", _pixel_unshuffle_raw)


def _channel_shuffle_raw(x, groups, data_format="NCHW", name=None):
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w)
    return x.permute(0, 2, 1, 3, 4).reshape(n, c, h, w)


channel_shuffle = defop("channel_shuffle", _channel_shuffle_raw)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, np.integer)) \
        else tuple(int(a) for a in v)


def _unfold_raw(x, kernel_sizes, strides=1, paddings=0, dilations=1,
                name=None):
    """im2col: [N, C, H, W] → [N, C·kh·kw, L], channels slowest; four
    paddings are [top, bottom, left, right]."""
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        x = TF.pad(x, [int(paddings[2]), int(paddings[3]),
                       int(paddings[0]), int(paddings[1])])
        paddings = 0
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     padding=_pair(paddings), stride=_pair(strides))


unfold = defop("unfold", _unfold_raw)


def _fold_raw(x, output_sizes, kernel_sizes, strides=1, paddings=0,
              dilations=1, name=None):
    """col2im, the adjoint of unfold: overlapping patches summed."""
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   dilation=_pair(dilations), padding=_pair(paddings),
                   stride=_pair(strides))


fold = defop("fold", _fold_raw)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - ε)·label + ε/K, or + ε·prior_dist."""
    prior = None if prior_dist is None else as_array(prior_dist)

    def raw(l):
        if prior is not None:
            return (1 - epsilon) * l + epsilon * prior.to(l.device)
        return (1 - epsilon) * l + epsilon / l.shape[-1]

    return eager(raw, (label,), {}, name="label_smooth")


def _pairwise_distance_raw(x, y, p=2.0, epsilon=1e-6, keepdim=False,
                           name=None):
    d = x - y + epsilon
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p), dim=-1,
                               keepdim=keepdim), 1.0 / p)


pairwise_distance = defop("pairwise_distance", _pairwise_distance_raw)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    from ...ops.manipulation import pad as _pad
    return _pad(x, padding, mode="constant", value=0.0,
                data_format=data_format)


def _bilinear_raw(x1, x2, weight, bias=None, name=None):
    # out[n, o] = x1[n, i] W[o, i, j] x2[n, j] (+ b[o])
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def bilinear(x1, x2, weight, bias=None, name=None):
    args = (x1, x2, weight) + ((bias,) if bias is not None else ())
    return eager(_bilinear_raw, args, {}, name="bilinear")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """mask[..., j] = j < x[...]; without maxlen the mask is max(x) wide,
    read on the host, as in the JAX package."""

    def raw(a):
        ml = int(maxlen) if maxlen is not None else int(torch.max(a))
        steps = torch.arange(ml, device=a.device)
        return (steps < a[..., None]).to(convert_dtype(dtype))

    return eager(raw, (x,), {}, name="sequence_mask")


def _temporal_shift_raw(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    # TSM: a fold of channels shifted one segment back, the next fold one
    # forward, the rest kept
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold_c = int(c * shift_ratio)
    left = torch.cat([x5[:, 1:, :fold_c],
                      torch.zeros_like(x5[:, :1, :fold_c])], dim=1)
    right = torch.cat([torch.zeros_like(x5[:, :1, fold_c:2 * fold_c]),
                       x5[:, :-1, fold_c:2 * fold_c]], dim=1)
    out = torch.cat([left, right, x5[:, :, 2 * fold_c:]], dim=2)
    out = out.reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    return eager(lambda a: _temporal_shift_raw(a, seg_num, shift_ratio,
                                               data_format), (x,), {},
                 name="temporal_shift")


def _affine_grid_raw(theta, out_shape, align_corners=True):
    n, _, h, w = [int(s) for s in out_shape]
    dev = theta.device

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=dev)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=dev)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # H, W, 3
    return torch.einsum("nij,hwj->nhwi", theta.to(torch.float32), base)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    if isinstance(out_shape, Tensor):
        out_shape = out_shape.numpy().tolist()
    return eager(lambda t: _affine_grid_raw(t, out_shape, align_corners),
                 (theta,), {}, name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """torch's grid sampler (its CUDA kernel on the card), whose
    coordinate maps, padding modes and rounding are the JAX package's
    expression: values agree to f32 rounding of the weights."""
    return eager(lambda a, g: TF.grid_sample(
        a, g.to(a.dtype), mode=mode, padding_mode=padding_mode,
        align_corners=align_corners), (x, grid), {}, name="grid_sample")


def _gather_tree_raw(ids, parents):
    # the beam-search backtrace: ids/parents [T, N, B], sequences
    # re-threaded through the parent pointers from the last step back
    t = ids.shape[0]
    beams = torch.arange(ids.shape[2], dtype=ids.dtype,
                         device=ids.device).expand(ids.shape[1:])
    out = [None] * t
    for i in range(t - 1, -1, -1):
        b = beams.to(torch.int64)
        out[i] = torch.gather(ids[i], 1, b)
        beams = torch.gather(parents[i], 1, b)
    return torch.stack(out, dim=0)


def gather_tree(ids, parents):
    return eager(_gather_tree_raw, (ids, parents), {}, name="gather_tree")
