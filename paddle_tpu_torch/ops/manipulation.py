"""Shape, layout and indexing ops — port of paddle_tpu/ops/manipulation.py
(the ones the eager path uses: reshape, transpose, flatten, squeeze,
unsqueeze, concat, stack, split, cast and basic-slicing getitem)."""
from __future__ import annotations

import numpy as np
import torch

from ._registry import defop, eager
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


def getitem(x, idx):
    nidx = _norm_index(idx)
    return eager(lambda a: a[nidx], (x,), {}, name="getitem")
