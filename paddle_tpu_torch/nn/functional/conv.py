"""Convolution and pooling functionals — port of
paddle_tpu/nn/functional/conv.py, the whole file.

The JAX package lowers each convolution to `lax.conv_general_dilated`
and each pool to `lax.reduce_window`, which XLA compiles; no Pallas
kernel is involved. Here the convolutions go to `torch.nn.functional`'s
`conv*d` / `conv_transpose*d` (cuDNN on the card) and the pools to its
pooling functions, with Paddle's API kept at the edge:

  * padding: an int, one per spatial dim, a (lo, hi) pair per dim in the
    flat form [lo0, hi0, lo1, hi1, ...], the full-rank nested form, or
    the strings "SAME" and "VALID" (`_conv_padding`, :29). "SAME" pads
    as `lax` does, ceil(in / stride) outputs with the odd pixel on the
    high side; an uneven padding is applied with `F.pad` before a call
    with none.
  * layouts: channels-last inputs ("NLC", "NHWC", "NDHWC") are permuted
    to channels-first for the call and back.
  * conv transposes take Paddle's weight [in, out / groups, *k] (torch's
    own layout) and its padding and output_padding: the full transposed
    result is cropped (or zero-extended on the high side by
    output_padding), then the bias is added, as the JAX package's
    dilated-input convolution computes it. "SAME" gives in · stride
    outputs and "VALID" the full result; the JAX package's call refuses
    string paddings for transposes.
  * `return_mask` indices are flat indices into each input plane
    (`_max_pool_indices`, :191), which is torch's own index layout.

Where the two differ: `ceil_mode` is honoured here and ignored by the
JAX package, and a transposed convolution with dilation > 1 dilates its
kernel here, where the JAX package's call leaves the kernel undilated
(its tests use dilation 1); both are recorded in ROADMAP.md Queue 3.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...ops._registry import eager


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    return v


def _conv_padding(padding, spatial):
    """Paddle padding spec → "SAME" / "VALID" or one (lo, hi) per dim."""
    n = spatial
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        # full-rank form [[0,0],[0,0],[h0,h1],[w0,w1]] (checked first: the
        # JAX package reads a 2-D one as the flat form and fails)
        return [tuple(int(x) for x in p) for p in padding[-n:]]
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _explicit_pads(pad, sizes, k, s, d):
    """`lax`'s pads for a string padding (window k dilated by d, stride
    s); a list passes through."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        out = []
        for n, kk, ss, dd in zip(sizes, k, s, d):
            total = max((-(-n // ss) - 1) * ss + dd * (kk - 1) + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pad, str):
        raise ValueError(f"padding {pad!r}: use 'SAME', 'VALID' or ints")
    return list(pad)


def _pad_arg(pads):
    """(lo, hi) per spatial dim → F.pad's last-dim-first flat list."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _channels_first(x, data_format):
    if data_format.endswith("C"):
        return x.movedim(-1, 1), True
    return x, False


def _restore(out, chan_last):
    return out.movedim(1, -1) if chan_last else out


def _conv_raw(x, weight, bias, stride, padding, dilation, groups, ndim,
              data_format, transpose=False, output_padding=0):
    x, chan_last = _channels_first(x, data_format)
    strides = _ntuple(stride, ndim)
    dilations = _ntuple(dilation, ndim)
    k = tuple(weight.shape[2:])
    pad = _conv_padding(padding, ndim)
    if not transpose:
        pads = _explicit_pads(pad, x.shape[2:], k, strides, dilations)
        conv = getattr(TF, f"conv{ndim}d")
        if all(lo == hi for lo, hi in pads):
            out = conv(x, weight, bias, strides, tuple(lo for lo, _ in pads),
                       dilations, groups)
        else:
            out = conv(TF.pad(x, _pad_arg(pads)), weight, bias, strides, 0,
                       dilations, groups)
        return _restore(out, chan_last)
    opad = _ntuple(output_padding, ndim)
    if pad == "SAME":
        # in · stride outputs: the full result's d(k-1)+1-s extra pixels
        # cropped, the odd one on the high side
        crops = []
        for kk, ss, dd in zip(k, strides, dilations):
            extra = dd * (kk - 1) + 1 - ss
            crops.append((max(extra, 0) // 2, extra - max(extra, 0) // 2))
    elif pad == "VALID":
        crops = [(0, 0)] * ndim
    elif isinstance(pad, str):
        raise ValueError(f"padding {pad!r}: use 'SAME', 'VALID' or ints")
    else:
        crops = [(lo, hi - op) for (lo, hi), op in zip(pad, opad)]
    conv_t = getattr(TF, f"conv_transpose{ndim}d")
    out = conv_t(x, weight, None, strides, 0, 0, groups, dilations)
    if any(c != (0, 0) for c in crops):
        out = TF.pad(out, [-v for v in _pad_arg(crops)])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return _restore(out, chan_last)


def _conv(name, ndim, x, weight, bias, stride, padding, dilation, groups,
          data_format, transpose=False, output_padding=0):
    args = (x, weight) if bias is None else (x, weight, bias)
    return eager(lambda *a: _conv_raw(
        a[0], a[1], a[2] if len(a) > 2 else None, stride, padding, dilation,
        groups, ndim, data_format, transpose, output_padding),
        args, {}, name=name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv("conv1d", 1, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv("conv2d", 2, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv("conv3d", 3, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


# `output_size` is accepted and, as in the JAX package, not used
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv("conv1d_transpose", 1, x, weight, bias, stride, padding,
                 dilation, groups, data_format, True, output_padding)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv("conv2d_transpose", 2, x, weight, bias, stride, padding,
                 dilation, groups, data_format, True, output_padding)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv("conv3d_transpose", 3, x, weight, bias, stride, padding,
                 dilation, groups, data_format, True, output_padding)


# ---- pooling ---------------------------------------------------------------

def _pool_geometry(x, ksize, strides, padding, ndim):
    k = _ntuple(ksize, ndim)
    s = _ntuple(strides if strides is not None else ksize, ndim)
    pad = _conv_padding(padding, ndim)
    pads = _explicit_pads(pad, x.shape[2:], k, s, (1,) * ndim)
    # torch's pools take a symmetric padding of at most half the window
    direct = all(lo == hi and lo <= kk // 2 for (lo, hi), kk in zip(pads, k))
    return k, s, pad, pads, direct


def _neg_fill(x):
    if x.is_floating_point():
        return -math.inf
    return torch.iinfo(x.dtype).min


def _pool_raw(x, ksize, strides, padding, ndim, op, data_format="NCHW",
              ceil_mode=False, count_include_pad=False):
    x, chan_last = _channels_first(x, data_format)
    k, s, pad, pads, direct = _pool_geometry(x, ksize, strides, padding, ndim)
    if op == "max":
        pool = getattr(TF, f"max_pool{ndim}d")
        if direct:
            out = pool(x, k, s, tuple(lo for lo, _ in pads),
                       ceil_mode=ceil_mode)
        else:
            out = pool(TF.pad(x, _pad_arg(pads), value=_neg_fill(x)), k, s,
                       0, ceil_mode=ceil_mode)
        return _restore(out, chan_last)
    pool = getattr(TF, f"avg_pool{ndim}d")
    # the JAX package divides by the window's size under a string padding
    # or none, and by the count of real pixels otherwise (exclusive)
    include = count_include_pad or isinstance(pad, str) or \
        all(p == (0, 0) for p in pads)
    if direct:
        out = pool(x, k, s, tuple(lo for lo, _ in pads), ceil_mode=ceil_mode,
                   count_include_pad=include)
    else:
        arg = _pad_arg(pads)
        out = pool(TF.pad(x, arg), k, s, 0, ceil_mode=ceil_mode)
        if not include:
            out = out / pool(TF.pad(torch.ones_like(x), arg), k, s, 0,
                             ceil_mode=ceil_mode)
    return _restore(out, chan_last)


def _max_pool_indices(x, ksize, stride, padding, nd, ceil_mode=False):
    """Flat index into each input plane of every window's max (Paddle's
    return_mask layout), channels-first layouts, any spatial rank."""
    k, s, _, pads, direct = _pool_geometry(x, ksize, stride, padding, nd)
    pool = getattr(TF, f"max_pool{nd}d")
    if direct:
        return pool(x, k, s, tuple(lo for lo, _ in pads), ceil_mode=ceil_mode,
                    return_indices=True)[1]
    padded = TF.pad(x, _pad_arg(pads), value=_neg_fill(x))
    idx = pool(padded, k, s, 0, ceil_mode=ceil_mode, return_indices=True)[1]
    # an index into the padded plane → the same pixel's in the input's
    coords, rest = [], idx
    for n in reversed(padded.shape[2:]):
        coords.append(rest % n)
        rest = rest // n
    flat = torch.zeros_like(idx)
    for c, (lo, _), n in zip(reversed(coords), pads, x.shape[2:]):
        flat = flat * n + (c - lo)
    return flat


def _max_pool_nd(x, kernel_size, stride, padding, return_mask, ceil_mode,
                 data_format, nd, name):
    out = eager(lambda a: _pool_raw(a, kernel_size, stride, padding, nd,
                                    "max", data_format, ceil_mode),
                (x,), {}, name=name)
    if return_mask:
        if data_format.endswith("C"):
            raise NotImplementedError(
                f"{name}: return_mask with a channels-last layout (as in "
                f"the JAX package)")
        idx = eager(lambda a: _max_pool_indices(a, kernel_size, stride,
                                                padding, nd, ceil_mode),
                    (x,), {}, name=name + "_mask")
        return out, idx
    return out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool_nd(x, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format, 1, "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool_nd(x, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format, 2, "max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool_nd(x, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format, 3, "max_pool3d")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return eager(lambda a: _pool_raw(a, kernel_size, stride, padding, 1,
                                     "avg", data_format, ceil_mode,
                                     count_include_pad=not exclusive),
                 (x,), {}, name="avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return eager(lambda a: _pool_raw(a, kernel_size, stride, padding, 2,
                                     "avg", data_format, ceil_mode,
                                     count_include_pad=not exclusive),
                 (x,), {}, name="avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return eager(lambda a: _pool_raw(a, kernel_size, stride, padding, 3,
                                     "avg", data_format, ceil_mode,
                                     count_include_pad=not exclusive),
                 (x,), {}, name="avg_pool3d")


def _adaptive_size(x, output_size, ndim):
    out = _ntuple(output_size, ndim) if output_size is not None else \
        (None,) * ndim
    return tuple(x.shape[2 + i] if o is None else int(o)
                 for i, o in enumerate(out))


def _adaptive_pool_raw(x, output_size, ndim, op, return_indices=False):
    """Bins [floor(i·n/m), ceil((i+1)·n/m)) per dim, the JAX package's
    and torch's adaptive pools alike."""
    size = _adaptive_size(x, output_size, ndim)
    if op == "avg":
        return getattr(TF, f"adaptive_avg_pool{ndim}d")(x, size)
    return getattr(TF, f"adaptive_max_pool{ndim}d")(
        x, size, return_indices=return_indices)


def adaptive_avg_pool1d(x, output_size, name=None):
    return eager(lambda a: _adaptive_pool_raw(a, output_size, 1, "avg"),
                 (x,), {}, name="adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return eager(lambda a: _adaptive_pool_raw(a, output_size, 2, "avg"),
                 (x,), {}, name="adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return eager(lambda a: _adaptive_pool_raw(a, output_size, 3, "avg"),
                 (x,), {}, name="adaptive_avg_pool3d")


def _adaptive_max_pool(x, output_size, return_mask, ndim, name):
    out = eager(lambda a: _adaptive_pool_raw(a, output_size, ndim, "max"),
                (x,), {}, name=name)
    if return_mask:
        # any bin sizes: the JAX package's mask takes divisible ones only
        idx = eager(lambda a: _adaptive_pool_raw(a, output_size, ndim, "max",
                                                 return_indices=True)[1],
                    (x,), {}, name=name + "_mask")
        return out, idx
    return out


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, return_mask, 1,
                              "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, return_mask, 2,
                              "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, return_mask, 3,
                              "adaptive_max_pool3d")


# ---- max un-pooling ----------------------------------------------------------

def _max_unpool_raw(x, indices, nd, kernel_size, stride, padding,
                    output_size, data_format):
    if not data_format.startswith("NC"):
        raise NotImplementedError(
            "max_unpool with a channels-last layout is not supported "
            "(as max_pool's return_mask)")
    ksize = _ntuple(kernel_size, nd)
    strides = _ntuple(stride if stride is not None else kernel_size, nd)
    pads = _ntuple(padding, nd)
    if output_size is None:
        output_size = tuple((n - 1) * st - 2 * p + kk for n, st, p, kk
                            in zip(x.shape[2:], strides, pads, ksize))
    else:
        output_size = tuple(int(v) for v in tuple(output_size)[-nd:])
    N, C = x.shape[:2]
    flat = int(np.prod(output_size))
    # an index past the output (the default size of a padded pool can be
    # smaller than its input) is dropped, as the JAX package's scatter
    # drops it: it lands in one spare slot that is cut off
    idx = indices.reshape(N, C, -1).long().clamp(max=flat)
    out = torch.zeros((N, C, flat + 1), dtype=x.dtype, device=x.device)
    out = out.scatter(2, idx, x.reshape(N, C, -1))
    return out[:, :, :flat].reshape((N, C) + output_size)


def _unpool_op(nd, default_format):
    def op(x, indices, kernel_size, stride=None, padding=0,
           data_format=default_format, output_size=None, name=None):
        """Inverse of max_pool(return_mask=True): each pooled value goes
        back to the position its mask recorded; everything else is 0."""
        return eager(lambda a, i: _max_unpool_raw(
            a, i, nd, kernel_size, stride, padding, output_size,
            data_format), (x, indices), {}, name=f"max_unpool{nd}d")

    op.__name__ = f"max_unpool{nd}d"
    return op


max_unpool1d = _unpool_op(1, "NCL")
max_unpool2d = _unpool_op(2, "NCHW")
max_unpool3d = _unpool_op(3, "NCDHW")


# ---- Lp and fractional pooling ------------------------------------------------

def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
             data_format, nd, name):
    p = float(norm_type)
    window = int(np.prod(_ntuple(kernel_size, nd)))

    def raw(a):
        powed = torch.abs(a.float()) ** p
        pooled = _pool_raw(powed, kernel_size, stride, padding, nd, "avg",
                           data_format, ceil_mode, count_include_pad=True)
        return ((pooled * window) ** (1.0 / p)).to(a.dtype)

    return eager(raw, (x,), {}, name=name)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """(sum |x|^p)^(1/p) over each window."""
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    data_format, 1, "lp_pool1d")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    data_format, 2, "lp_pool2d")


def _fractional_pool(a, output_size, ndim, u):
    """Fractional max pooling (Graham): window ends floor(alpha·(i + u))
    for alpha = in / out, the last window ending at the input's end."""
    out = a
    for d, n_out in enumerate(_ntuple(output_size, ndim)):
        n_in = a.shape[2 + d]
        alpha = n_in / n_out
        ends = [int(math.floor(alpha * (i + u))) for i in range(n_out)]
        starts = [0] + ends[:-1]
        ends[-1] = n_in
        segs = [out.narrow(2 + d, s, max(e, s + 1) - s).amax(
            dim=2 + d, keepdim=True) for s, e in zip(starts, ends)]
        out = torch.cat(segs, dim=2 + d)
    return out


def _fractional_u(random_u):
    """The window offset: `random_u`, or a draw in [0.05, 0.95) from the
    port's CPU generator (the JAX package draws from its global key)."""
    if random_u is not None:
        return float(random_u)
    from ...core import random as prandom
    g = prandom.default_generator("cpu")
    return float(torch.empty(()).uniform_(0.05, 0.95, generator=g))


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    u = _fractional_u(random_u)
    out = eager(lambda a: _fractional_pool(a, output_size, 2, u),
                (x,), {}, name="fractional_max_pool2d")
    return (out, None) if return_mask else out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    u = _fractional_u(random_u)
    out = eager(lambda a: _fractional_pool(a, output_size, 3, u),
                (x,), {}, name="fractional_max_pool3d")
    return (out, None) if return_mask else out
