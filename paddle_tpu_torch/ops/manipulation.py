"""Shape, layout and indexing ops — port of paddle_tpu/ops/manipulation.py
(the ones the eager path uses: reshape, transpose, flatten, squeeze,
unsqueeze, concat, stack, split, cast, getitem, setitem_, where and
pad).

`squeeze(x, axis=k)` on an axis longer than 1 returns x unchanged, as
Paddle documents; the JAX package raises ValueError there (a recorded
divergence). Slices with a negative step reverse, as in JAX: torch has
no negative step, so those axes are flipped first and sliced forward."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ._registry import adopt_inplace, as_array, defop, eager
from ..core.tensor import Tensor
from ..core import dtype as dtypes


def _shape_arg(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    return tuple(int(s) for s in shape)


def _axes(axis):
    return tuple(int(a) for a in np.atleast_1d(
        axis.numpy() if isinstance(axis, Tensor) else axis))


reshape = defop("reshape",
                lambda x, shape, name=None: torch.reshape(x, _shape_arg(shape)))
transpose = defop("transpose", lambda x, perm, name=None:
                  x.permute([int(p) for p in perm]))


def _flatten_raw(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.ndim
    if nd == 0:
        return x.reshape(1)
    s, e = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))


flatten = defop("flatten", _flatten_raw)
squeeze = defop("squeeze", lambda x, axis=None, name=None:
                x.squeeze() if axis is None else x.squeeze(_axes(axis)))


def _unsqueeze_raw(x, axis, name=None):
    axes = _axes(axis)
    nd = x.ndim + len(axes)
    # jnp.expand_dims: the axes are positions in the output
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


unsqueeze = defop("unsqueeze", _unsqueeze_raw)
cast = defop("cast", lambda x, dtype, name=None:
             x.to(dtypes.convert_dtype(dtype)))


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return eager(lambda *arrs: torch.cat(arrs, dim=axis), tuple(x), {},
                 name="concat")


def stack(x, axis=0, name=None):
    return eager(lambda *arrs: torch.stack(arrs, dim=int(axis)), tuple(x),
                 {}, name="stack")


def _split_raw(x, num_or_sections, axis=0):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"split: dimension {x.shape[axis]} is not "
                             f"divisible into {num_or_sections} parts")
        return tuple(torch.split(x, x.shape[axis] // num_or_sections,
                                 dim=axis))
    secs = [int(s) for s in num_or_sections]
    # paddle allows one -1 section
    if -1 in secs:
        known = sum(s for s in secs if s != -1)
        secs[secs.index(-1)] = x.shape[axis] - known
    return tuple(torch.split(x, secs, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return list(eager(lambda a: _split_raw(a, num_or_sections, axis), (x,),
                      {}, name="split"))


def _norm_index(idx):
    if isinstance(idx, tuple):
        return tuple(_norm_index(i) for i in idx)
    if isinstance(idx, Tensor):
        return idx._data
    if isinstance(idx, list):
        return torch.as_tensor(np.asarray(idx))
    return idx


def _dims_taken(i) -> int:
    """Input axes one index element consumes."""
    if i is None or i is Ellipsis:
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return max(i.ndim, 1)
    return 1


def _forward_steps(nidx, shape):
    """(axes to flip, an index with only positive steps) equal to `nidx`
    on a tensor of `shape`: a slice s:e:-k over an axis of n becomes,
    on that axis flipped, the forward slice from n-1-first to n-1-last
    by k."""
    items = nidx if isinstance(nidx, tuple) else (nidx,)
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in items):
        return (), nidx
    used = sum(_dims_taken(i) for i in items)
    flips, out, d = [], [], 0
    for i in items:
        if i is Ellipsis:
            d += len(shape) - used
        elif isinstance(i, slice) and i.step is not None and i.step < 0:
            n = shape[d]
            r = range(*i.indices(n))
            i = slice(n - 1 - r[0], n - r[-1], -i.step) if len(r) else \
                slice(0, 0)
            flips.append(d)
        out.append(i)
        d += _dims_taken(i)
    return tuple(flips), tuple(out)


def _getitem_raw(a, nidx):
    flips, fidx = _forward_steps(nidx, a.shape)
    return (a.flip(flips) if flips else a)[fidx]


def getitem(x, idx):
    nidx = _norm_index(idx)
    return eager(lambda a: _getitem_raw(a, nidx), (x,), {}, name="getitem")


def _setitem_raw(a, nidx, v):
    flips, fidx = _forward_steps(nidx, a.shape)
    out = a.flip(flips) if flips else a.clone()
    if not isinstance(v, (torch.Tensor, bool, int, float)):
        v = torch.as_tensor(np.asarray(v), device=a.device)
    out[fidx] = v.to(a.dtype) if isinstance(v, torch.Tensor) else v
    return out.flip(flips) if flips else out


def setitem_(x, idx, value):
    """`x[idx] = value` (paddle_tpu/ops/manipulation.py:437), in x's
    dtype, written as an in-place op (`_registry.adopt_inplace`): when x
    or value is differentiable under grad mode the write is recorded and
    x takes the new value and its place in the graph; otherwise a leaf x
    keeps its storage and the value is copied in."""
    nidx = _norm_index(idx)
    if isinstance(value, Tensor):
        out = eager(lambda a, v: _setitem_raw(a, nidx, v), (x, value), {},
                    name="setitem")
    else:
        out = eager(lambda a: _setitem_raw(a, nidx, value), (x,), {},
                    name="setitem")
    return adopt_inplace(x, out)


def where(condition, x=None, y=None, name=None):
    """x where `condition` holds, else y (paddle_tpu/ops/manipulation.py
    :295), in their promoted dtype; a Python scalar takes the other
    operand's dtype. The one-argument form (the indices of the true
    elements) is the op long tail's `nonzero` (ROADMAP.md Queue 1, item
    7)."""
    if x is None and y is None:
        raise NotImplementedError(
            "where(condition) without x and y is nonzero(as_tuple=True), "
            "which the port does not have yet")
    cond = as_array(condition).to(torch.bool)
    tens = tuple(v for v in (x, y) if isinstance(v, Tensor))

    def raw(*arrs):
        it = iter(arrs)
        a = next(it) if isinstance(x, Tensor) else x
        b = next(it) if isinstance(y, Tensor) else y
        return torch.where(cond, a, b)

    return eager(raw, tens, {}, name="where")


def _pad_widths(pad, nd, data_format):
    """(lo, hi) per axis from Paddle's pad list (paddle_tpu/ops/
    manipulation.py:393): 2·ndim entries pad every axis in order; fewer
    pad the spatial axes, innermost pair first."""
    pad = [int(p.item()) if isinstance(p, Tensor) else int(p) for p in
           (pad.numpy().tolist() if isinstance(pad, Tensor) else pad)]
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    widths = [(0, 0)] * nd
    k = len(pad) // 2
    # channels-last layouts: the spatial axes start at 1
    dims = list(range(1, 1 + k)) if data_format.endswith("C") and nd >= 3 \
        else list(range(nd - k, nd))
    for i in range(k):
        widths[dims[k - 1 - i]] = (pad[2 * i], pad[2 * i + 1])
    return widths


def _pad_raw(x, pad, mode="constant", value=0.0, data_format="NCHW",
             name=None):
    """jnp.pad's modes: constant, reflect, replicate ("edge") and
    circular ("wrap"), over any axes. torch pads at most the last three
    axes in the three copying modes, so the padded axes are moved last
    and the others folded into one batch axis for the call."""
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    widths = _pad_widths(pad, x.ndim, data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(widths) for v in lo_hi]
        if x.dtype == torch.bool:
            return TF.pad(x.to(torch.uint8), flat,
                          value=int(bool(value))).to(torch.bool)
        return TF.pad(x, flat, value=value)
    axes = [d for d, w in enumerate(widths) if w != (0, 0)]
    # the copying modes pad each axis on its own: up to three at a time
    for k in range(0, len(axes), 3):
        x = _pad_copying(x, axes[k:k + 3], widths, mode)
    return x


def _pad_copying(x, axes, widths, mode):
    rest = [d for d in range(x.ndim) if d not in axes]
    moved = x.permute(rest + axes)
    lead = moved.shape[:len(rest)]
    y = moved.reshape((1, -1) + tuple(moved.shape[len(rest):]))
    flat = [v for d in reversed(axes) for v in widths[d]]
    y = TF.pad(y, flat, mode=mode)
    y = y.reshape(tuple(lead) + tuple(y.shape[2:]))
    inv = [0] * x.ndim
    for i, d in enumerate(rest + axes):
        inv[d] = i
    return y.permute(inv)


pad = defop("pad", _pad_raw)
